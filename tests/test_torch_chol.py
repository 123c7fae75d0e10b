"""Parity of the port's Cholesky layer with the JAX package: the tile
factorisation (kernel K2's plain version) against the Pallas kernel in
interpret mode, the divide-and-conquer recursion and the structure-aware
products. Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stheno_tpu.ops import chol as jchol
from stheno_tpu.ops import pallas_chol as jtile
from stheno_tpu.ops import trimul as jtrimul
from stheno_torch.ops import chol as tchol
from stheno_torch.ops import chol_tile as ttile
from stheno_torch.ops import trimul as ttrimul
from tests.test_torch_helpers import np_, spd, torch_cpu  # noqa: F401


@pytest.fixture
def jax_interpret():
    jtile.set_chol_mode("interpret")
    yield
    jtile.set_chol_mode("auto")


@pytest.mark.parametrize("n", [128, 200, 384])
def test_chol_tile_matches_pallas_interpret(n, jax_interpret):
    # 200 exercises the identity padding, 384 the panels and trailing
    # updates. Both compute the same blocked algorithm in float32: atol
    # 5e-5, the tolerance tests/test_pallas_chol.py holds the Pallas
    # kernel to against a float64 factor.
    A = spd(n, seed=n, dtype=np.float32)
    Lj, Ij = jtile.chol_tile(jnp.asarray(A))
    Lt, It = ttile.chol_tile(torch.tensor(A))
    np.testing.assert_allclose(np_(Lt), np_(Lj), atol=5e-5)
    np.testing.assert_allclose(np_(It), np_(Ij), atol=5e-5)
    np.testing.assert_allclose(np_(Lt @ It), np.eye(n), atol=5e-5)
    assert np.all(np.triu(np_(Lt), 1) == 0) and np.all(np.triu(np_(It), 1) == 0)


def test_chol_tile_grad_matches_pallas_custom_vjp(jax_interpret):
    """The Murray adjoint plus the inverse correction, on a tile that pads
    to 256: the gradient must ignore the padding block."""
    n = 136
    A = spd(n, seed=1, dtype=np.float32)
    W = np.random.RandomState(2).randn(n, n).astype(np.float32)
    y = np.random.RandomState(3).randn(n).astype(np.float32)

    def f_jax(A):
        L, Linv = jtile.chol_tile(A)
        return (
            jnp.sum(jnp.log(jnp.diagonal(L)))
            + jnp.sum((Linv @ jnp.asarray(y)) ** 2)
            + jnp.sum(L * jnp.asarray(W))
        )

    gj = np_(jax.grad(f_jax)(jnp.asarray(A)))
    At = torch.tensor(A, requires_grad=True)
    L, Linv = ttile.chol_tile(At)
    f = (
        torch.sum(torch.log(torch.diagonal(L)))
        + torch.sum((Linv @ torch.tensor(y)) ** 2)
        + torch.sum(L * torch.tensor(W))
    )
    f.backward()
    # Relative to the gradient's scale, as tests/test_pallas_chol.py does.
    np.testing.assert_allclose(np_(At.grad), gj, atol=5e-5 * np.max(np.abs(gj)))


def test_chol_tile_grad_matches_autograd_through_linalg_f64_reference():
    n = 140
    A = spd(n, seed=4, dtype=np.float32)
    W = torch.tensor(np.random.RandomState(5).randn(n, n), dtype=torch.float32)

    def loss(L, Linv):
        return torch.sum(L * W) + torch.sum(Linv * W.T)

    At = torch.tensor(A, requires_grad=True)
    loss(*ttile.chol_tile(At)).backward()
    A64 = torch.tensor(A, dtype=torch.float64, requires_grad=True)
    L64 = torch.linalg.cholesky(0.5 * (A64 + A64.T))
    loss(L64, torch.linalg.inv(L64)).backward()
    ref = np_(A64.grad)
    np.testing.assert_allclose(np_(At.grad), ref, atol=1e-4 * np.max(np.abs(ref)))


@pytest.mark.parametrize("sub", [8, 32])
def test_chol_tile_plain_sub_blocks_match_linalg_f64(sub, monkeypatch):
    """The plain version's arithmetic (warp-sized sub-blocks factored and
    inverted, block inverses joined by products) at a sub-block size the
    test sets, in float64: L matches the library factor and L inv(L) = I
    to rtol 1e-10. n = 200 pads to two 128-blocks."""
    monkeypatch.setattr(ttile, "_S", sub)
    n = 200
    A = torch.tensor(spd(n, seed=11))
    L, Linv = ttile.chol_tile_plain(A)
    np.testing.assert_allclose(np_(L), np_(torch.linalg.cholesky(A)), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np_(L @ Linv), np.eye(n), rtol=1e-10, atol=1e-10)
    assert np.all(np.triu(np_(L), 1) == 0) and np.all(np.triu(np_(Linv), 1) == 0)


def test_chol_tile_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        ttile.chol_tile(torch.zeros(ttile.MAX_TILE + 1, ttile.MAX_TILE + 1))
    with pytest.raises(ValueError):
        ttile.chol_tile(torch.zeros(2, 64, 64))
    with pytest.raises(TypeError):
        ttile.chol_tile(torch.eye(64, dtype=torch.float64))


def test_chol_tile_launches_nothing_on_cpu():
    before = ttile.launches
    ttile.chol_tile(torch.tensor(spd(64, seed=6, dtype=np.float32)))
    assert ttile.launches == before


@pytest.mark.parametrize("n", [100, 300, 416])
def test_cholesky_with_inv_recursion_matches_jax_f64(n, monkeypatch):
    # _BASE shrunk on both sides so that the recursion runs at test size;
    # float64 takes the library base case on both sides (rtol 1e-10).
    monkeypatch.setattr(jchol, "_BASE", 128)
    monkeypatch.setattr(tchol, "_BASE", 128)
    A = spd(n, seed=n)
    Lj, Ij = jchol.cholesky_with_inv(jnp.asarray(A))
    Lt, It = tchol.cholesky_with_inv(torch.tensor(A))
    np.testing.assert_allclose(np_(Lt), np_(Lj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np_(It), np_(Ij), rtol=1e-10, atol=1e-12)


def test_cholesky_with_inv_recursion_over_tile_base_f32(monkeypatch):
    """float32 with the tile base case under a shrunk _BASE and MAX_TILE:
    the recursion stitches tile results into one consistent (L, inv L)."""
    monkeypatch.setattr(tchol, "_BASE", 128)
    monkeypatch.setattr(ttile, "MAX_TILE", 128)
    n = 416
    A = spd(n, seed=7, dtype=np.float32)
    L, Linv = tchol.cholesky_with_inv(torch.tensor(A))
    assert np.max(np.abs(np_(L @ L.T) - A)) < 5e-4
    np.testing.assert_allclose(np_(L @ Linv), np.eye(n), atol=5e-4)


def test_tri_inv_lower_matches_jax_f64(monkeypatch):
    monkeypatch.setattr(jchol, "_BASE", 128)
    monkeypatch.setattr(tchol, "_BASE", 128)
    L = np.linalg.cholesky(spd(333, seed=8))
    np.testing.assert_allclose(
        np_(tchol.tri_inv_lower(torch.tensor(L))),
        np_(jchol.tri_inv_lower(jnp.asarray(L))),
        rtol=1e-10,
        atol=1e-12,
    )


def test_cholesky_nan_marks_failure_instead_of_raising():
    A = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    assert torch.isnan(tchol.cholesky_nan(A)).all()
    assert torch.isfinite(tchol.cholesky_nan(torch.eye(3))).all()


_TRIMUL = ["mul_att", "mul_at", "mul_ta", "syrk_nt", "syrk_tn_lower"]


@pytest.mark.parametrize("name", _TRIMUL)
def test_trimul_matches_jax_f64(name):
    # Sizes past the leaf / block thresholds so the recursions run; rtol
    # 1e-11 for float64 products summed in another order.
    r = np.random.RandomState(9)
    n = 1024 if name == "syrk_tn_lower" else 700
    T = np.tril(r.randn(n, n))
    A = r.randn(96, n) if name in ("mul_att", "mul_at") else r.randn(n, 96)
    if name == "syrk_nt":
        args_j, args_t = (jnp.asarray(A),), (torch.tensor(A),)
    elif name == "syrk_tn_lower":
        args_j, args_t = (jnp.asarray(T),), (torch.tensor(T),)
    elif name == "mul_ta":
        args_j, args_t = (jnp.asarray(T), jnp.asarray(A)), (torch.tensor(T), torch.tensor(A))
    else:
        args_j, args_t = (jnp.asarray(A), jnp.asarray(T)), (torch.tensor(A), torch.tensor(T))
    kw = {"nb": 4} if name == "syrk_tn_lower" else {}
    out = getattr(ttrimul, name)(*args_t, **kw)
    ref = getattr(jtrimul, name)(*args_j, **kw)
    np.testing.assert_allclose(np_(out), np_(ref), rtol=1e-11, atol=1e-9)
