"""Parity of the port's fused Gram x V (kernel K3's plain version and its
wrapper) with the JAX package's Pallas kernel in interpret mode, at the
shapes of ``tests/test_gram_matvec.py``; the wrapper's guards; the launch
shape chosen for the card; and the kernel build's source digest."""

import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stheno_tpu.ops.gram_matvec import gram_matvec as jgram_matvec
from stheno_torch.ops import _build
from stheno_torch.ops import gram_matvec as tgmv
from stheno_torch.ops.gram import KINDS, gram_plain
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401

# rtol 2e-5: the tolerance tests/test_gram_matvec.py holds the Pallas
# kernel to against the dense float32 product (the sums run in another
# order).
RTOL = 2e-5


@pytest.mark.parametrize("kind", ["eq", "matern32", "rq", "linear"])
def test_gram_matvec_matches_pallas_interpret(kind):
    r = np.random.RandomState(0)
    x = r.randn(37, 2).astype(np.float32)
    y = r.randn(23, 2).astype(np.float32)
    v = r.randn(23, 5).astype(np.float32)
    ref = jgram_matvec(kind, jnp.asarray(x), jnp.asarray(y), jnp.asarray(v), alpha=1.3,
                       interpret=True)
    out = tgmv.gram_matvec(kind, torch.tensor(x), torch.tensor(y), torch.tensor(v), 1.3)
    assert out.shape == (37, 5) and out.dtype == torch.float32
    np.testing.assert_allclose(np_(out), np_(ref), rtol=RTOL, atol=1e-5)


def test_gram_matvec_square_accumulation_matches_pallas_interpret():
    # n = 1100 spans three of the Pallas kernel's 512-row tiles and three
    # of its column tiles; atol 2e-4 as in tests/test_gram_matvec.py (a
    # sum of 1100 terms).
    r = np.random.RandomState(1)
    x = r.randn(1100, 1).astype(np.float32)
    v = r.randn(1100, 3).astype(np.float32)
    ref = jgram_matvec("eq", jnp.asarray(x), jnp.asarray(x), jnp.asarray(v), interpret=True)
    xt = torch.tensor(x)
    out = tgmv.gram_matvec("eq", xt, xt, torch.tensor(v))
    np.testing.assert_allclose(np_(out), np_(ref), rtol=RTOL, atol=2e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_is_the_blocked_dense_product_f64(kind):
    # float64, a ragged last block: the blocked plain version equals the
    # dense Gram times v to rounding (rtol 1e-12).
    r = np.random.RandomState(2)
    x, y, v = (torch.tensor(r.randn(*s)) for s in ((70, 3), (45, 3), (45, 4)))
    out = tgmv.gram_matvec_plain(kind, x, y, v, 0.7, block=16)
    ref = gram_plain(kind, x, y, 0.7) @ v
    np.testing.assert_allclose(np_(out), np_(ref), rtol=1e-12, atol=1e-12)


def test_gram_matvec_refuses_a_gradient():
    x = torch.randn(6, 1, dtype=torch.float64, requires_grad=True)
    v = torch.randn(6, 2, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="forward-only"):
        tgmv.gram_matvec("eq", x, x, v)
    with pytest.raises(RuntimeError, match="forward-only"):
        tgmv.gram_matvec("rq", x.detach(), x.detach(), v, torch.tensor(1.0, requires_grad=True))
    with torch.no_grad():
        assert tgmv.gram_matvec("eq", x, x, v).shape == (6, 2)


def test_gram_matvec_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(4, 2)
    v = torch.zeros(4, 1)
    with pytest.raises(TypeError):
        tgmv.gram_matvec("eq", x.double(), x, v)
    with pytest.raises(TypeError):
        tgmv.gram_matvec("eq", x.to(torch.bfloat16), x.to(torch.bfloat16), v.to(torch.bfloat16))
    with pytest.raises(ValueError):
        tgmv.gram_matvec("eq", x, torch.zeros(4, 3), v)
    with pytest.raises(ValueError):
        tgmv.gram_matvec("eq", x, x, torch.zeros(5, 1))
    with pytest.raises(ValueError):
        tgmv.gram_matvec("cosine", x, x, v)


def test_cpu_call_launches_no_kernel():
    before = tgmv.launches
    x = torch.randn(9, 1)
    tgmv.gram_matvec("eq", x, x, torch.randn(9, 3))
    assert tgmv.launches == before


@pytest.mark.parametrize(
    "n, m, p, dtype",
    [
        (262_144, 262_144, 17, torch.float32),
        (262_144, 262_144, 256, torch.float32),
        (8192, 262_144, 1, torch.float32),
        (4096, 262_144, 1, torch.float32),
        (3000, 2500, 5, torch.float64),
        (37, 23, 5, torch.float32),
    ],
)
def test_launch_shape_covers_every_column_once(n, m, p, dtype):
    kernel, width, span, splits = tgmv.route(n, m, p, dtype)
    assert width >= p or kernel != "ffma"
    assert span % 64 == 0 and 1 <= splits <= 65535
    # Every column lies in exactly one split, and no split is empty.
    assert span * splits >= m and span * (splits - 1) < m
    # A split sweeps at least about 1024 columns, never fewer than m
    # allows.
    assert splits <= -(-m // 1024)


def test_build_digest_follows_sources_and_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    assert sorted(p.name for p in csrc.glob("*.cuh")), "the kernels share a header"
    assert [p.name for p in _build._sources(csrc)] == [p.name for p in _build._sources()]
    base = _build._digest(csrc)
    assert base == _build._digest()
    header = csrc / "gram_kind.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = _build._digest(csrc)
    assert edited != base
    source = csrc / "gram_matvec.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    assert _build._digest(csrc) not in (base, edited)


@pytest.mark.parametrize(
    "p, dtype, kernel, width",
    [
        (1, torch.float32, "ffma", 1),
        (16, torch.float32, "ffma", 16),
        (17, torch.float32, "mma", 24),
        (64, torch.float32, "mma", 64),
        (256, torch.float32, "mma", 128),
        (1, torch.float64, "dmma", 1),
        (16, torch.float64, "dmma", 16),
        (17, torch.float64, "dmma", 17),
        (64, torch.float64, "dmma", 64),
        (256, torch.float64, "dmma", 64),
    ],
)
def test_route_by_width_and_dtype(p, dtype, kernel, width):
    # float32 from p = 17 on takes the tensor cores with p padded to 24
    # (not 32) and wider p in blocks of up to 128; float32 p <= 16 the FFMA
    # kernel; float64 the FP64 tensor cores at every p, padded to a
    # multiple of 8, wider p in blocks of 64, but p = 8 k + 1 up to 33
    # exactly (its last column on DFMA).
    got, w, span, splits = tgmv.route(262_144, 262_144, p, dtype)
    assert (got, w) == (kernel, width)
    assert span % 64 == 0 and span * splits >= 262_144 and span * (splits - 1) < 262_144


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [1, 5, 16, 17, 24, 33])
def test_ffma_and_dmma_launch_shapes_are_deterministic(p, dtype):
    # The float64 route at every p and the float32 one at p <= 16: the
    # width each block or thread holds, rows per block that tile n, and a
    # column split that depends on the shapes alone (the same sums in the
    # same order on every call, as CG needs).
    for n, m in ((262_144, 262_144), (8192, 262_144), (4096, 262_144), (37, 23)):
        got = tgmv.route(n, m, p, dtype)
        assert got == tgmv.route(n, m, p, dtype)
        kernel, width, span, splits = got
        if dtype == torch.float64:
            assert kernel == "dmma" and got[1:] == tgmv.dmma_launch_shape(n, m, p)
            if p % 8 == 1 and p <= 33:
                assert width == p
            else:
                assert width in (8, 16, 24, 32, 64)
                assert width == min(64, -(-p // 8) * 8) or (p > 32 and width == 64)
            rows = tgmv._DMMA_ROWS
        elif p <= 16:
            assert kernel == "ffma" and got[1:] == tgmv.launch_shape(n, m, p)
            assert width in (1, 4, 8, 16) and width >= p
            rows = tgmv._THREADS * tgmv._rows_per_thread(width)
            assert rows == 512
        else:
            assert kernel == "mma"
            continue
        blocks = -(-n // rows) * -(-p // width)
        assert span % 64 == 0 and span * splits >= m and span * (splits - 1) < m
        # Split only where the row blocks leave the card short.
        target = tgmv._MMA_TARGET_BLOCKS if kernel == "dmma" else tgmv._TARGET_BLOCKS
        assert splits == 1 or blocks * (splits - 1) < target


@pytest.mark.parametrize("n, m, p", [(262_144, 262_144, 17), (8192, 262_144, 64), (3000, 2500, 17)])
def test_mma_launch_shape_covers_every_column_once(n, m, p):
    nb, span, splits = tgmv.mma_launch_shape(n, m, p)
    assert nb in (24, 32, 64, 128) and (nb >= p or nb == 128) and nb % 8 == 0
    assert span % 64 == 0 and 1 <= splits <= 65535
    assert span * splits >= m and span * (splits - 1) < m


def test_tf32_rounding_is_round_to_nearest_ties_away():
    z = torch.tensor([1.0, 1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 3 * 2**-12, 0.0])
    assert tgmv._tf32(z).tolist() == [1.0, 1 + 2**-10, -(1 + 2**-10), 1.0, 1 + 2**-10, 0.0]
    # The low part keeps the next 10 bits, truncated: hi + lo is pi to
    # 2^-20.
    hi, lo = tgmv._split(torch.tensor([math.pi], dtype=torch.float32))
    assert float(hi) == 3.140625 and abs(float(hi + lo) - math.pi) <= 2**-20 * math.pi


@pytest.mark.parametrize("p", [17, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_split_product_emulation_within_card_tolerance(kind, p):
    """The tensor-core kernel's arithmetic (3xTF32 split product, passes of
    64 columns) against the float64 product, within the tolerance
    chip_smoke.py holds the card's K3 to: 8 sqrt(m) eps of |G| @ |v|."""
    r = np.random.RandomState(p)
    x = torch.tensor(r.randn(512, 1).astype(np.float32))
    y = torch.tensor(r.randn(2048, 1).astype(np.float32))
    v = torch.tensor(r.randn(2048, p).astype(np.float32))
    out = tgmv.gram_matvec_split_plain(kind, x, y, v, 1.3, block=256)
    G64 = gram_plain(kind, x.double(), y.double(), 1.3)
    ref = G64 @ v.double()
    scale = G64.abs() @ v.double().abs()
    tol = 8 * math.sqrt(2048) * torch.finfo(torch.float32).eps
    assert out.dtype == torch.float32 and out.shape == (512, p)
    assert float(((out.double() - ref).abs() / scale).max()) <= tol


@pytest.mark.parametrize("kind", KINDS)
def test_ex2_emulation_matches_pallas_interpret(kind):
    """The float32 FFMA kernel's arithmetic (prescaled inputs, base-2 exps
    with exp2 for ex2.approx) against the Pallas kernel in interpret mode
    at a small ragged shape, within the tolerance chip_smoke.py holds the
    card's K3 to: 8 sqrt(m) eps of |G| @ |v| (the float64 Gram)."""
    r = np.random.RandomState(4)
    x = r.randn(37, 2).astype(np.float32)
    y = r.randn(29, 2).astype(np.float32)
    v = r.randn(29, 3).astype(np.float32)
    ref = jgram_matvec(kind, jnp.asarray(x), jnp.asarray(y), jnp.asarray(v), alpha=1.3,
                       interpret=True)
    out = tgmv.gram_matvec_ex2_plain(kind, torch.tensor(x), torch.tensor(y), torch.tensor(v),
                                     1.3)
    G64 = gram_plain(kind, torch.tensor(x).double(), torch.tensor(y).double(), 1.3)
    scale = np_(G64.abs() @ torch.tensor(v).double().abs())
    tol = 8 * math.sqrt(29) * np.finfo(np.float32).eps
    assert out.dtype == torch.float32 and out.shape == (37, 3)
    assert float((np.abs(np_(out) - np_(ref)) / scale).max()) <= tol


@pytest.mark.parametrize("kind", ["eq", "matern12", "matern32", "matern52"])
def test_ex2_emulation_diagonal_is_exactly_g0(kind):
    # x is y: the prescaled norms and inner product share one chain, so d2
    # is exactly 0 and the diagonal exactly g(0) = 1, at depth 1 and 3.
    r = np.random.RandomState(5)
    for d in (1, 3):
        x = torch.tensor(r.randn(40, d).astype(np.float32) * 3)
        G = tgmv.gram_matvec_ex2_plain(kind, x, x, torch.eye(40))
        assert bool((torch.diagonal(G) == 1).all())
