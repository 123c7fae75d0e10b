"""The traffic generator and the seeds: the same seed gives the same
inputs, every seed the same work."""

import pytest
import torch

from gpbench.harness import seeds, traffic
from gpbench.harness.bench import PKG
from gpbench.paths import _common


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 3_000_000_000_123])
def test_derive_is_stable_and_separates_streams(seed):
    a = seeds.derive(seed, "data")
    assert a == seeds.derive(seed, "data")
    assert a != seeds.derive(seed, "probes", 0) != seeds.derive(seed, "probes", 1)
    assert 0 <= a < 2 ** 63
    g1, g2 = seeds.generator("cpu", seed, "x"), seeds.generator("cpu", seed, "x")
    assert torch.equal(torch.randn(5, generator=g1), torch.randn(5, generator=g2))


def test_probe_seeds_differ_by_step():
    assert len({traffic.probe_seed(3, i) for i in range(100)}) == 100


def test_a_steps_probes_repeat_for_its_seed():
    def probes(seed, step):
        g = torch.Generator().manual_seed(traffic.probe_seed(seed, step))
        return torch.randn(4, 3, generator=g)

    assert torch.equal(probes(2 ** 33 + 5, 7), probes(2 ** 33 + 5, 7))
    assert not torch.equal(probes(2 ** 33 + 5, 7), probes(2 ** 33 + 5, 8))


@pytest.mark.parametrize("path", sorted((PKG / "traffic").glob("*.json")), ids=lambda p: p.stem)
def test_every_traffic_file_loads(path):
    assert traffic.load(path)["kind"] in traffic.KINDS


def test_an_unknown_kind_is_refused(tmp_path):
    path = tmp_path / "t.json"
    path.write_text('{"kind": "queries"}')
    with pytest.raises(ValueError, match="kind"):
        traffic.load(path)


def test_the_data_repeat_per_seed_with_the_same_sizes():
    c = {"n": 64, "x_low": 0.0, "x_high": 10.0}
    x1, e1 = _common.uniform_sorted(c, 3_000_000_000_123, "cpu")
    x2, e2 = _common.uniform_sorted(c, 3_000_000_000_123, "cpu")
    x3, e3 = _common.uniform_sorted(c, 3_000_000_000_124, "cpu")
    assert torch.equal(x1, x2) and torch.equal(e1, e2)
    assert not torch.equal(x1, x3) and x1.shape == x3.shape == e3.shape == (64,)
    assert torch.all(torch.diff(x1) >= 0) and 0.0 <= float(x1.min()) and float(x1.max()) <= 10.0
