"""The port's multi-output subsystem (``stheno_torch.mo``, the cross
process, ``combine`` and joint densities over several processes):
``tests/mo/test_mo.py``'s cases on the port, each held against the JAX
package on the same numpy float64 inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_torch.mo import MultiOutputKernel, MultiOutputMean
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401


def _setup(M, arr):
    m = M.Measure()
    f1 = M.GP(1.0, M.EQ(), measure=m)
    f2 = M.GP(2.0, M.EQ().stretch(2.0), measure=m)
    return m, f1, f2, arr(np.linspace(0, 3, 4))


def _both(fn):
    """``fn(M, arr)`` for the port and the JAX package."""
    return fn(st, torch.tensor), fn(sj, jnp.asarray)


def test_block_assembly():
    def run(M, arr):
        m, f1, f2, x = _setup(M, arr)
        mok = (MultiOutputKernel if M is st else sj.mo.MultiOutputKernel)(m, f1, f2)
        return [M.dense(M.pairwise(mok, *args)) for args in
                [(x, x), (f1(x), f2(x)), (f1(x), f1(x)), (f1(x), x), (x, f2(x))]]

    got, want = _both(run)
    assert got[0].shape == (8, 8) and got[3].shape == (4, 8)
    np.testing.assert_allclose(np_(got[0][:4, 4:]), 0, atol=1e-12)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-10, atol=1e-14)


def test_mom_and_elwise():
    m, f1, f2, x = _setup(st, torch.tensor)
    out = MultiOutputMean(m, f1, f2)(x)
    np.testing.assert_allclose(np_(out[:4, 0]), 1.0)
    np.testing.assert_allclose(np_(out[4:, 0]), 2.0)
    mok = MultiOutputKernel(m, f1, f2)
    el = st.elwise(mok, x, x)
    assert el.shape == (8, 1)
    np.testing.assert_allclose(np_(el[:, 0]), 1.0, rtol=1e-10)
    np.testing.assert_allclose(np_(st.elwise(mok, f2(x), f2(x))), 1.0, rtol=1e-10)
    with pytest.raises(ValueError):
        st.elwise(mok, f1(x), x)
    with pytest.raises(ValueError):
        st.elwise(mok, (x, x), (x,))


def test_dimensionality_and_infer_size():
    m, f1, f2, x = _setup(st, torch.tensor)
    mok = MultiOutputKernel(m, f1, f2)
    assert st.dimensionality(mok) == 2
    assert st.dimensionality(st.EQ()) == 1
    assert st.dimensionality(st.EQ() + st.EQ()) == 1
    assert st.dimensionality(st.mo.AmbiguousDimensionalityKernel(st.EQ())) is None
    assert st.infer_size(mok, x) == 8
    assert st.infer_size(mok, f1(x)) == 4
    assert st.infer_size(mok, (f1(x), f2(x))) == 8
    assert st.infer_size(st.EQ(), x) == 4
    assert st.num_elements(f1(x)) == 4
    assert st.num_elements((f1(x), f2(x))) == 8
    with pytest.raises(RuntimeError):
        st.infer_size(st.mo.AmbiguousDimensionalityKernel(st.EQ()), x)


def test_cross_process():
    def run(M, arr):
        m, f1, f2, x = _setup(M, arr)
        fdd = M.cross(f1, f2)(x)
        return fdd.mean, M.dense(fdd.var)

    got, want = _both(run)
    assert got[0].shape == (8, 1) and got[1].shape == (8, 8)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-12)
    m, f1, f2, x = _setup(st, torch.tensor)
    s = st.cross(f1, f2)(x).sample(torch.Generator().manual_seed(0))
    assert s.shape == (8, 1)


def test_multi_output_conditioning():
    def run(M, arr):
        m, f1, f2, x = _setup(M, arr)
        y1, y2 = arr(np.sin(np.linspace(0, 3, 4))), arr(np.cos(np.linspace(0, 3, 4)))
        post = m.condition((f1(x, 1e-6), y1), (f2(x, 1e-6), y2))
        return (*post(f1)(x).marginals(), *post(f2)(x).marginals())

    got, want = _both(run)
    np.testing.assert_allclose(np_(got[0]), np.sin(np.linspace(0, 3, 4)), atol=1e-4)
    np.testing.assert_allclose(np_(got[2]), np.cos(np.linspace(0, 3, 4)), atol=1e-4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-8, atol=1e-12)


def test_correlated_multi_output():
    def run(M, arr):
        m = M.Measure()
        latent = M.GP(M.EQ(), measure=m)
        f1 = latent + M.GP(1e-2 * M.EQ(), measure=m)
        f2 = latent + M.GP(1e-2 * M.EQ().stretch(2.0), measure=m)
        x = arr(np.linspace(0, 5, 10))
        post = m.condition(f1(x, 1e-6), arr(np.sin(np.linspace(0, 5, 10))))
        return (*post(f2)(x).marginals(), f2(x).marginals()[1])

    (m2, v2, v2_prior), want = _both(run)
    np.testing.assert_allclose(np_(m2), np.sin(np.linspace(0, 5, 10)), atol=0.15)
    assert bool((v2 < v2_prior).all())
    for a, b in zip((m2, v2), want):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-8, atol=1e-12)


def test_combined_joint_logpdf():
    def run(M, arr):
        m, f1, f2, x = _setup(M, arr)
        y1, y2 = arr(np.sin(np.linspace(0, 3, 4))), arr(np.cos(np.linspace(0, 3, 4)))
        joint = m.logpdf((f1(x, 0.1), y1), (f2(x, 0.2), y2))
        fdd, y = M.combine((f1(x, 0.1), y1), (f2(x, 0.2), y2))
        return joint, m.logpdf(f1(x, 0.1), y1) + m.logpdf(f2(x, 0.2), y2), y, M.dense(fdd.noise)

    got, want = _both(run)
    np.testing.assert_allclose(float(got[0]), float(got[1]), rtol=1e-8)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-8)


def test_combined_correlated_logpdf_matches_jax():
    # Several pairs on correlated processes (no factorisation), with a NaN
    # dropped from one of them.
    def run(M, arr):
        m = M.Measure()
        g = M.GP(M.EQ(), measure=m)
        h = g + M.GP(0.5 * M.Matern32(), measure=m)
        x = np.linspace(0, 4, 6)
        y2 = np.cos(x)
        y2[2] = np.nan
        obs = M.Obs((g(arr(x), 0.1), arr(np.sin(x))), (h(arr(x[:4]), 0.2), arr(y2[:4])))
        return m.logpdf(obs), m.condition(obs)(h)(arr(np.linspace(0, 4, 3))).marginals()[0]

    got, want = _both(run)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-8)


def test_posterior_cross_process_marginals():
    # The posterior cross process: transposed cross-kernels take the
    # dimensionality of what they wrap.
    def run(M, arr):
        m = M.Measure()
        p1 = M.GP(M.EQ(), measure=m)
        p2 = M.GP(M.Matern32(), measure=m)
        pc = M.cross(p1, p2)
        x = arr(np.linspace(0, 5, 10))
        post = m | (p1(x, 0.1), arr(np.sin(np.linspace(0, 5, 10))))
        return (*post(pc)(x, 1e-2).marginals(), *post(p1(x, 1e-2)).marginals())

    got, want = _both(run)
    assert got[0].shape == (20,) and got[1].shape == (20,)
    np.testing.assert_allclose(np_(got[0][:10]), np_(got[2]), rtol=1e-8)
    np.testing.assert_allclose(np_(got[1][:10]), np_(got[3]), rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-8, atol=1e-12)
