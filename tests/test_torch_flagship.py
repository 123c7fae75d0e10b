"""The slice as a whole: the port's training-and-prediction step against
the JAX package's ``__graft_entry__._flagship_step`` and the headline's
periodic-EQ NLML (``bench.py:bench_n2000``'s model), in float64 on the
same numpy inputs; plus the guards that keep the port free of JAX and on
the card by default."""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from __graft_entry__ import _flagship_step
from stheno_tpu import config as jconfig
from stheno_torch import config as tconfig
from stheno_torch.convert import params_from_jax
from stheno_torch.entry import entry, flagship_step, nlml_n2000, periodic_nlml
from stheno_torch.ops import chol_tile as ttile
from stheno_torch.ops import gram as tgram
from tests.test_torch_helpers import both_impls, np_, torch_cpu  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent

# float64 against float64 on the same inputs: the two packages run the same
# formulas, so they agree to rounding (rtol 1e-8, the slice's tolerance).
RTOL = 1e-8


@pytest.fixture(params=["auto", "fast"])
def impl(request):
    both_impls(jconfig, request.param)
    yield request.param
    jconfig.set_cholesky_impl("auto")


def _data(n=256, m=64, seed=0):
    r = np.random.RandomState(seed)
    x = np.sort(r.rand(n)) * 10
    y = np.sin(x) + 0.1 * r.randn(n)
    return x, y, np.linspace(-1.0, 11.0, m)


PARAMS = {"log_ell": 0.1, "log_s2": -0.2, "log_noise": -2.0}


def test_flagship_step_matches_jax(impl):
    x, y, x_new = _data()
    pj = {k: jnp.asarray(v, jnp.float64) for k, v in PARAMS.items()}
    vj, gj, mj, varj = _flagship_step(jnp.asarray(x), jnp.asarray(y), jnp.asarray(x_new), pj)
    pt = params_from_jax({k: np.asarray(v) for k, v in pj.items()}, device="cpu")
    vt, gt, mt, vart = flagship_step(x, y, x_new, pt)
    np.testing.assert_allclose(float(vt), float(vj), rtol=RTOL)
    for k in PARAMS:
        np.testing.assert_allclose(float(gt[k]), float(gj[k]), rtol=RTOL)
    np.testing.assert_allclose(np_(mt), np_(mj), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(np_(vart), np_(varj), rtol=RTOL, atol=1e-12)


def test_periodic_nlml_value_and_grad_match_jax(impl):
    n = 300
    x = np.linspace(0.0, 10.0, n)
    y = np.sin(x) + 0.3 * np.cos(3.2 * x)

    def nlml_j(ell):
        f = sj.GP(sj.EQ().stretch(ell).periodic(jnp.asarray(1.0)))
        return -f.measure.logpdf(f(jnp.asarray(x), jnp.asarray(0.1)), jnp.asarray(y))

    vj, gj = jax.value_and_grad(nlml_j)(jnp.asarray(2.0))
    vt, gt = nlml_n2000(
        torch.tensor(x), torch.tensor(y), torch.tensor(2.0, dtype=torch.float64), grad=True
    )
    np.testing.assert_allclose(float(vt), float(vj), rtol=RTOL)
    np.testing.assert_allclose(float(gt), float(gj), rtol=RTOL)
    np.testing.assert_allclose(
        float(nlml_n2000(torch.tensor(x), torch.tensor(y), torch.tensor(2.0, dtype=torch.float64))),
        float(vj),
        rtol=RTOL,
    )


def test_posterior_of_a_sum_kernel_with_mean_matches_jax():
    # A second model through the same path: a sum kernel and a constant
    # mean, conditioned, then the joint logpdf of new data and the
    # marginals under the posterior.
    x, y, x_new = _data(n=80, m=20, seed=1)

    def run(M, a):
        f = M.GP(0.5 + 0.0 * M.OneMean(), M.Matern32().stretch(1.5) + 0.3 * M.EQ())
        post = f | (f(a(x), 0.05), a(y))
        lp = post.measure.logpdf(post(a(x_new), 0.1), a(np.cos(x_new)))
        mean, var = post(a(x_new)).marginals()
        return lp, mean, var

    out_t = run(st, torch.tensor)
    out_j = run(sj, jnp.asarray)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(np_(a), np_(b), rtol=RTOL, atol=1e-12)


def test_entry_runs_at_its_shapes_on_the_cpu_when_asked():
    fn, (x, y, x_new, params) = entry(device="cpu")
    assert x.shape == (1024,) and x_new.shape == (256,) and x.dtype == torch.float32
    val, grads, mean, var = fn(x[::8], y[::8], x_new[::8], params)
    assert torch.isfinite(val) and all(torch.isfinite(g) for g in grads.values())
    assert mean.shape == (32,) and bool((var >= 0).all())


def test_cpu_run_launches_no_kernel():
    before = (tgram.launches, ttile.launches)
    x = np.linspace(0.0, 10.0, 50)
    nlml_n2000(torch.tensor(x), torch.tensor(np.sin(x)), torch.tensor(2.0, dtype=torch.float64), grad=True)
    assert (tgram.launches, ttile.launches) == before


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device does not raise here")
    tconfig.set_default_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flagship_step(*_data(n=8, m=2), PARAMS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        periodic_nlml(np.zeros(3), np.zeros(3), 1.0)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "stheno_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [
        (str(p.relative_to(ROOT)), m)
        for p in files
        for m in _imports(p)
        if m.split(".")[0] in ("jax", "jaxlib", "stheno_tpu")
    ]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, stheno_torch, stheno_torch.entry, stheno_torch.ops.chol;"
        "assert 'jax' not in sys.modules and 'stheno_tpu' not in sys.modules"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
