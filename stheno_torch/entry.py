"""Entry points: the exact-GP training-and-prediction step.

Counterparts of ``__graft_entry__.py:_flagship_step``/``entry()`` and of
the model of ``bench.py:bench_n2000``:

- :func:`flagship_step` differentiates the negative log marginal
  likelihood of an EQ GP with respect to its hyperparameters, then
  conditions on the data and returns the posterior marginals at new
  inputs;
- :func:`entry` returns the step and its example arguments at the JAX
  shapes (n=1024, m=256, float32);
- :func:`flagship_jacfwd` is the same NLML's gradient by forward mode
  (``torch.func.jacfwd``) at N=2000 (:func:`flagship_n2000_inputs`): on
  the card it runs K1's tangent kernel and K2's forward rule;
  :func:`flagship_hessian` is its Hessian (``torch.func.hessian``, forward
  over reverse), which adds K1's backward and its tangent kernel;
- :func:`nlml_n2000` is the reference's headline, the periodic-EQ NLML at
  N=2000 (:func:`n2000_inputs`), as a value or a value and gradient;
- the matrix-free path of ``bench.py:bench_iterative_262k`` (the exact GP
  at N=262,144, whose Gram cannot be stored): :func:`iterative_inputs`
  makes its data, :func:`iterative_precond_state` its shared
  preconditioner, :func:`iterative_step` its NLML value and gradient
  (fresh or amortised preconditioner), :func:`sharded_iterative_262k`
  the same step with its matvecs row-sharded over a mesh, and
  :func:`serving_weights`,
  :func:`serving_mean`, :func:`serving_variance_cache`,
  :func:`serving_var` and :func:`serving_bundle` its amortised
  posterior, each with the benchmark's settings as defaults;
- the training workloads of ``bench.py:bench_opt_steps`` and
  ``bench_nuts``: :func:`adam_n2000` builds the Adam driver of the
  N=2000 EQ GP (:func:`adam_n2000_objective`; its step captured in CUDA
  graphs on the card), :func:`resumable_n2000` trains the same model
  through ``utils.resumable_minimise`` (checkpoints, resume, rollback;
  its steps captured in CUDA graphs on the card), :func:`nuts_n2000`
  runs NUTS over the three log-hyperparameters of an EQ GP at N=2000 and
  :func:`hmc_n2000` HMC on the same posterior, the chains split over a
  mesh dimension when given one;
- the pseudo-point (sparse) path of ``bench.py:bench_vfe_n2000`` (N=2000,
  M=100) and ``bench_dist_elbo_1m`` (N=1,000,000, M=512):
  :func:`vfe_n2000_inputs` and :func:`sparse_1m_inputs` make their data,
  :func:`sparse_elbo` (alias :func:`vfe_elbo_n2000` and
  :func:`sparse_elbo_1m`) the VFE, FITC or DTC ELBO of
  ``GP(EQ().stretch(ell))`` as a value or a value and gradient, and
  :func:`sparse_predict` the posterior marginals after pseudo-point
  conditioning. The inducing Gram is near singular in float32 at these
  sizes, so they factor with the adaptive jitter (as the JAX package's
  ``dist_elbo`` does) unless ``jitter`` fixes it; :func:`sparse_jitter`
  is the probe's choice;
- the modelling DSL through the reference's own example models:
  Bayesian linear regression (``examples/example6_blr.py``) at N=10^6,
  :func:`blr_inputs`, :func:`blr_logpdf` and :func:`blr_predict`, whose
  variance is a ``Woodbury`` that is never densified; the smooth-plus-
  wiggly decomposition (``examples/example2_decomposition.py``) at the
  headline's N=2000, :func:`decomposition_inputs` and
  :func:`decomposition_logpdf`; the derivative model
  (``examples/example5_integration.py``), :func:`derivative_inputs` and
  :func:`derivative_condition`; and a ``Normal`` with a ``Kronecker``
  variance on ``bench.py``'s 1024 x 1024 grid, :func:`kronecker_inputs`
  and :func:`kronecker_logpdf`, with or without a mask of each axis;
- pathwise posterior draws at ``bench.py:bench_pathwise_262k``'s size:
  :func:`pathwise_262k_inputs` makes its data and :func:`pathwise_build`
  the 8 function draws from one whitened CG solve (or a dense one);
- SVGP on the data of ``bench_dist_elbo_1m`` (N=10^6, M=512):
  :func:`svgp_1m_inputs`, :func:`svgp_1m_step` (a minibatch ELBO, or its
  value and gradient with respect to the log-hyperparameters and the
  inducing inputs) and :func:`svgp_1m_natgrad` (one natural-gradient
  step), the minibatch drawn once by a numpy ``RandomState(0)`` as
  ``examples/example14_svgp.py`` draws its batches;
- the structured grids of ``bench.py:bench_structured_grids``: the
  circulant path on the uniform N=2^20 grid, :func:`grid_1m_inputs`,
  :func:`grid_nlml_1m_step` (the stochastic NLML and its gradient) and
  :func:`grid_posterior_1m` (mean at 4096 points, variance at 512), and the
  Kronecker path on the 1024 x 1024 grid, :func:`kron_1m_inputs`,
  :func:`kron_nlml_1m_step` (the exact NLML and its gradient) and
  :func:`kron_posterior_1m`;
- the small-noise operator of ``bench.py:bench_compensated_262k``:
  :func:`compensated_262k_inputs`, :func:`compensated_matvec8_262k` (the
  compensated matvec of 8 right-hand sides at noise 0.01) and
  :func:`smallnoise_weights_262k` (the compensated representer-weights
  solve and its true residual through the compensated operator);
- the distributed 1-D paths (``stheno_torch.parallel``) over a mesh of the
  process group's ranks: :func:`dist_nlml_16k` (the NLML of
  ``bench.py:bench_dense_nlml_grad``'s EQ GP at N=16,384 through
  ``sharded_gram`` and ``dist_nlml``, its value or value and gradient),
  :func:`dist_elbo_1m` (``bench_dist_elbo_1m``'s VFE ELBO at N=10^6, M=512
  through ``dist_elbo``) and :func:`dist_predict_16k` (the N=16,384
  model's posterior through ``dist_posterior_predict``), with
  :func:`dist_nlml_16k_inputs` for the data; and the 2-D block-cyclic
  path over a grid of ranks: :func:`dist_nlml_2d_16k` (the same NLML
  through ``dist_nlml_2d``, each rank's tiles built by one Gram call on
  its cyclic rows and columns).

Raw inputs go to ``device`` (default ``config.default_device``, the card);
tensors keep their own device.
"""

import contextlib
import functools

import numpy as np
import torch

from . import config
from . import iterative as it
from .dist import Normal
from .kernels import EQ, RQ, Delta, pairwise
from .matrix import Diagonal, Kronecker, adaptive_jitter_eps, add, dense
from .model import (
    GP,
    Measure,
    PseudoObs,
    PseudoObsDTC,
    PseudoObsFITC,
    pathwise_sampler,
    svgp_elbo,
    svgp_init,
    svgp_natgrad_step,
)
from . import parallel as par
from .parallel import cholesky2d as _c2d
from .parallel._comm import MeshAxis
from .parallel.cholesky import sharded
from .opt import AdamDriver, Vars
from .opt.hmc import _sample_hmc
from .opt.nuts import _sample_nuts
from .opt.minimise import _make_loss
from .opt.transform import adam
from .utils import resumable_minimise

__all__ = [
    "flagship_step",
    "entry",
    "flagship_n2000_inputs",
    "flagship_jacfwd",
    "flagship_hessian",
    "periodic_nlml",
    "n2000_inputs",
    "nlml_n2000",
    "iterative_kernel",
    "iterative_inputs",
    "iterative_precond_state",
    "iterative_step",
    "sharded_iterative_262k",
    "serving_weights",
    "serving_mean",
    "serving_variance_cache",
    "serving_var",
    "serving_bundle",
    "adam_n2000_objective",
    "adam_n2000",
    "nuts_n2000",
    "hmc_n2000",
    "SPARSE_NOISE",
    "vfe_n2000_inputs",
    "sparse_1m_inputs",
    "sparse_jitter",
    "sparse_elbo",
    "vfe_elbo_n2000",
    "sparse_elbo_1m",
    "sparse_predict",
    "blr_inputs",
    "blr_logpdf",
    "blr_predict",
    "decomposition_inputs",
    "decomposition_logpdf",
    "derivative_inputs",
    "derivative_condition",
    "kronecker_inputs",
    "GRID_NOISE",
    "grid_kernel",
    "grid_1m_inputs",
    "grid_nlml_1m_step",
    "grid_posterior_1m",
    "kron_kernels",
    "kron_1m_inputs",
    "kron_nlml_1m_step",
    "kron_posterior_1m",
    "SMALL_NOISE",
    "compensated_262k_inputs",
    "compensated_matvec8_262k",
    "smallnoise_weights_262k",
    "DIST_NOISE",
    "dist_nlml_16k_inputs",
    "dist_nlml_16k",
    "dist_nlml_2d_16k",
    "dist_elbo_1m",
    "dist_predict_16k",
    "kronecker_logpdf",
    "PATHWISE_NOISE",
    "pathwise_262k_inputs",
    "pathwise_build",
    "svgp_kernel",
    "svgp_1m_inputs",
    "svgp_1m_step",
    "svgp_1m_natgrad",
]


def _eq_model(params):
    ell = torch.exp(params["log_ell"])
    s2 = torch.exp(params["log_s2"])
    noise = torch.exp(params["log_noise"])
    return GP(s2 * EQ().stretch(ell)), noise


@config.pin_matmul_precision
def flagship_step(x, y, x_new, params, device=None):
    """NLML value and gradient + posterior marginals for an EQ GP.

    ``params`` holds ``log_ell``, ``log_s2`` and ``log_noise``. Returns
    ``(value, grads, mean, var)`` with ``grads`` a dict like ``params``."""
    x, y, x_new = (config.as_tensor(a, device=device) for a in (x, y, x_new))
    leaves = {
        k: config.as_tensor(v, device=device).detach().requires_grad_(True)
        for k, v in params.items()
    }
    with torch.enable_grad():
        f, noise = _eq_model(leaves)
        val = -f.measure.logpdf(f(x, noise), y)
        grads = torch.autograd.grad(val, list(leaves.values()))
    with torch.no_grad():
        f, noise = _eq_model({k: v.detach() for k, v in leaves.items()})
        post = f | (f(x, noise), y)
        mean, var = post(x_new).marginals()
    return val.detach(), dict(zip(leaves, grads)), mean, var


def entry(device=None):
    """``(flagship_step, example_args)`` at the JAX package's shapes."""
    dev = config.resolve_device(device)
    n, m = 1024, 256
    x = torch.linspace(0.0, 10.0, n, dtype=torch.float32, device=dev)
    y = torch.sin(x)
    x_new = torch.linspace(0.0, 10.0, m, dtype=torch.float32, device=dev)
    params = {
        "log_ell": torch.tensor(0.0, device=dev),
        "log_s2": torch.tensor(0.0, device=dev),
        "log_noise": torch.tensor(-2.0, device=dev),
    }
    return flagship_step, (x, y, x_new, params)


def flagship_n2000_inputs(dtype=torch.float32, device=None, *, n=2000):
    """``(x, y, params)`` of the flagship's EQ model at N=2000: ``x`` on [0,
    10], ``y = sin x + 0.3 cos 3.2x`` (the headline's data) and
    :func:`entry`'s log-hyperparameters."""
    dev = config.resolve_device(device)
    x = torch.linspace(0.0, 10.0, n, dtype=dtype, device=dev)
    y = torch.sin(x) + 0.3 * torch.cos(3.2 * x)
    params = {k: torch.tensor(v, dtype=dtype, device=dev)
              for k, v in (("log_ell", 0.0), ("log_s2", 0.0), ("log_noise", -2.0))}
    return x, y, params


@config.pin_matmul_precision
def flagship_jacfwd(x, y, params):
    """The flagship NLML of :func:`flagship_step` and its gradient with
    respect to ``params`` by forward mode: ``(value, grads)``, ``grads`` a
    dict like ``params``. One ``torch.func.jacfwd`` over the stacked
    log-hyperparameters, so each factorisation and Gram carries all their
    tangents at once: on the card K1's tangent kernel takes the Gram's in
    one launch, and the factorisation's tiles K2's forward rule."""
    x, y = config.as_tensor(x), config.as_tensor(y)
    names = list(params)
    p = torch.stack([config.as_tensor(params[k], device=x.device) for k in names]).detach()

    def nlml(p):
        f, noise = _eq_model(dict(zip(names, p)))
        val = -f.measure.logpdf(f(x, noise), y)
        return val, val

    jac, val = torch.func.jacfwd(nlml, has_aux=True)(p)
    return val, dict(zip(names, jac))


@config.pin_matmul_precision
def flagship_hessian(x, y, params):
    """The Hessian of the flagship NLML of :func:`flagship_step` with
    respect to ``params``, the port's form of ``jax.hessian`` of that NLML:
    one ``torch.func.hessian`` (forward over reverse) over the stacked
    log-hyperparameters, a ``(k, k)`` tensor in the order of ``params``'s
    keys. On the card the reverse pass launches K1 and K1's backward, and
    the forward pass over it, in one launch each for all ``k`` directions,
    K1's tangent kernel, the backward's tangent kernel
    (``ops/gram_bwd_jvp.py``) and K2's forward rule."""
    x, y = config.as_tensor(x), config.as_tensor(y)
    names = list(params)
    p = torch.stack([config.as_tensor(params[k], device=x.device) for k in names]).detach()

    def nlml(p):
        f, noise = _eq_model(dict(zip(names, p)))
        return -f.measure.logpdf(f(x, noise), y)

    return torch.func.hessian(nlml)(p)


def periodic_nlml(x, y, ell, period=1.0, noise=0.1):
    """NLML of ``GP(EQ().stretch(ell).periodic(period))`` with noise."""
    x, y = config.as_tensor(x), config.as_tensor(y)
    period = torch.as_tensor(period, dtype=x.dtype, device=x.device)
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    f = GP(EQ().stretch(ell).periodic(period))
    return -f.measure.logpdf(f(x, noise), y)


def n2000_inputs(dtype=torch.float32, device=None):
    """The headline's data: ``x`` on [0, 10], ``y = sin x + 0.3 cos 3.2x``,
    and the stretch ``ell = 2``."""
    x = torch.linspace(0.0, 10.0, 2000, dtype=dtype, device=config.resolve_device(device))
    y = torch.sin(x) + 0.3 * torch.cos(3.2 * x)
    return x, y, torch.tensor(2.0, dtype=dtype, device=x.device)


@config.pin_matmul_precision
def nlml_n2000(x, y, ell, grad=False):
    """The headline NLML: its value, or ``(value, d value / d ell)``."""
    if not grad:
        with torch.no_grad():
            return periodic_nlml(x, y, ell)
    ell = ell.detach().requires_grad_(True)
    with torch.enable_grad():
        val = periodic_nlml(x, y, ell)
        (g,) = torch.autograd.grad(val, ell)
    return val.detach(), g


# ---------------------------------------------------------------------------
# The matrix-free path at N=262,144 (bench.py:bench_iterative_262k).

#: Observation-noise variance of the matrix-free path.
ITERATIVE_NOISE = 0.1


def iterative_kernel(params):
    """``exp(log_s2) * EQ().stretch(exp(log_ell))``."""
    return torch.exp(params["log_s2"]) * EQ().stretch(torch.exp(params["log_ell"]))


def iterative_inputs(n=262_144, device=None, dtype=torch.float32, seed=0):
    """The benchmark's data, made as ``bench.py`` makes it: ``x`` is ``n``
    sorted uniform points on [0, 10], ``y = sin x + 0.1 noise``, from a
    numpy ``RandomState(seed)``; and the parameters ``log_s2 = log_ell =
    0``. Returns ``(x, y, params)``."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    dev = config.resolve_device(device)
    r = np.random.RandomState(seed)
    x = torch.as_tensor(np.sort(r.rand(n).astype(np_dtype)) * 10, device=dev)
    y = torch.sin(x) + 0.1 * torch.as_tensor(r.randn(n).astype(np_dtype), device=dev)
    params = {k: torch.zeros((), dtype=dtype, device=dev) for k in ("log_s2", "log_ell")}
    return x, y, params


def iterative_precond_state(x, params, generator, rank=64, block=8192):
    """The shared eig-preconditioner state ``(U, lam)`` (amortised
    training and serving)."""
    return it.eig_precond_state(iterative_kernel, params, x, rank, generator, block=block)


#: The training step's settings, ``bench.py``'s: the probes, the CG
#: tolerance and cap, and the Lanczos steps. :func:`iterative_step` (where
#: a caller may change them) and :func:`sharded_iterative_262k` both take
#: them from here.
ITERATIVE_STEP = {"num_probes": 16, "cg_tol": 1e-2, "max_cg_iters": 200, "slq_steps": 30}


def iterative_step(x, y, params, generator, *, precond_state=None, noise=ITERATIVE_NOISE,
                   precond_rank=64, block=8192, compensated=False, **settings):
    """The training step: the stochastic NLML and its gradient with
    respect to ``params``, with a fresh rank-``precond_rank`` eig
    preconditioner or the given ``precond_state``, at
    :data:`ITERATIVE_STEP`'s settings with ``settings`` (any of its keys)
    in their place. Returns ``(value, grads, info)`` with ``info`` the
    forward solve's health dict."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        val, info = it.iterative_nlml(
            iterative_kernel, leaves, x, y, noise, generator, precond_rank=precond_rank,
            precond_state=precond_state, block=block, return_info=True,
            compensated=compensated, **{**ITERATIVE_STEP, **settings},
        )
        grads = torch.autograd.grad(val, list(leaves.values()))
    return val.detach(), dict(zip(leaves, grads)), info


def sharded_iterative_262k(mesh, generator, *, n=262_144, dtype=torch.float32, precond_rank=64,
                           block=8192):
    """:func:`iterative_step`'s model, data and settings (its noise and
    :data:`ITERATIVE_STEP`, a fresh rank-``precond_rank`` eig
    preconditioner) through ``parallel.sharded_iterative_nlml`` over the
    1-D ``mesh``: every Gram matvec row-sharded over its ranks, the
    surrogate gradient taken per rank and summed. The data
    (:func:`iterative_inputs`, ``n`` points) is made on ``generator``'s
    device. Returns ``(value, grads, info)``, the same on every rank."""
    x, y, params = iterative_inputs(n, device=generator.device, dtype=dtype)
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        val, info = par.sharded_iterative_nlml(
            iterative_kernel, leaves, x, y, ITERATIVE_NOISE, generator, mesh,
            axis=mesh.mesh_dim_names[0], precond_rank=precond_rank, block=block,
            return_info=True, **ITERATIVE_STEP,
        )
        grads = torch.autograd.grad(val, list(leaves.values()))
    return val.detach(), dict(zip(leaves, grads)), info


def serving_weights(x, y, params, precond_state, *, noise=ITERATIVE_NOISE, cg_tol=1e-4,
                    max_cg_iters=200, block=8192):
    """The representer weights on the shared state: ``(alpha, info)``."""
    return it.posterior_weights(
        iterative_kernel, params, x, y, noise, cg_tol=cg_tol, max_cg_iters=max_cg_iters,
        precond_state=precond_state, block=block,
    )


def serving_mean(x, params, alpha, x_new, *, block=8192):
    """The posterior mean at ``x_new`` from the weights (no CG)."""
    with torch.no_grad():
        return it.cached_posterior_mean(iterative_kernel, params, x, alpha, x_new, block=block)


def serving_variance_cache(x, params, generator, *, noise=ITERATIVE_NOISE, rank=256,
                           power_iters=2, refine=True, cg_tol=1e-3, max_cg_iters=20,
                           block=4096, basis_tile_dtype=None):
    """The amortised variance cache of the benchmark's settings
    (``basis_tile_dtype=torch.bfloat16``: its bfloat16-basis build)."""
    return it.variance_cache(
        iterative_kernel, params, x, noise, rank=rank, generator=generator,
        power_iters=power_iters, refine=refine, cg_tol=cg_tol, max_cg_iters=max_cg_iters,
        block=block, basis_tile_dtype=basis_tile_dtype,
    )


def serving_var(x, params, cache, x_new, *, chunk=1024):
    """The posterior variance at ``x_new`` from the cache (no CG)."""
    with torch.no_grad():
        return it.cached_posterior_var(iterative_kernel, params, x, cache, x_new, chunk=chunk)


def serving_bundle(x, y, params, generator, *, precond_state=None, noise=ITERATIVE_NOISE,
                   rank=256, block=8192, chunk=1024, var_max_cg_iters=20):
    """The serving bundle :class:`~stheno_torch.iterative.AmortisedPosterior`
    (weights and variance cache in one object)."""
    return it.AmortisedPosterior(
        iterative_kernel, params, x, y, noise, rank=rank, generator=generator,
        precond_state=precond_state, block=block, chunk=chunk,
        var_max_cg_iters=var_max_cg_iters,
    )


# ---------------------------------------------------------------------------
# Training at N=2000 (bench.py:bench_opt_steps, bench_nuts).


def adam_n2000_objective(device=None, dtype=torch.float32, *, n=2000):
    """``(f, vs)``: the objective of ``bench_opt_steps`` and an empty
    :class:`~stheno_torch.opt.Vars` for it. ``f(vs)`` is the NLML of
    ``GP(s2 * EQ().stretch(ell))`` with noise 0.1 on ``x = linspace(0, 10,
    n)``, ``y = sin x + 0.3 cos 3.2x``, with ``ell`` and ``s2`` positive
    parameters from 1."""
    dev = config.resolve_device(device)
    x = torch.linspace(0.0, 10.0, n, dtype=dtype, device=dev)
    y = torch.sin(x) + 0.3 * torch.cos(3.2 * x)

    def f(v):
        ell = v.positive(1.0, name="ell")
        s2 = v.positive(1.0, name="s2")
        g = GP(s2 * EQ().stretch(ell))
        return -g.measure.logpdf(g(x, 0.1), y)

    return f, Vars(dtype=dtype, device=dev)


def adam_n2000(steps_per_dispatch=1, device=None, dtype=torch.float32, *, n=2000):
    """The Adam driver of ``bench_opt_steps`` on
    :func:`adam_n2000_objective`, at rate 1e-3. On the card its step is
    captured as a CUDA graph when it is built; ``steps_per_dispatch``
    changes nothing there (see :class:`~stheno_torch.opt.AdamDriver`)."""
    f, vs = adam_n2000_objective(device, dtype, n=n)
    return AdamDriver(f, vs, rate=1e-3, steps_per_dispatch=steps_per_dispatch)


def resumable_n2000(checkpoint_path, steps, *, steps_per_dispatch=1, checkpoint_every=10,
                    rate=5e-2, trace=False, device=None, dtype=torch.float32, n=2000):
    """Adam at ``rate`` on :func:`adam_n2000_objective`'s model through
    :func:`~stheno_torch.utils.resumable_minimise`: ``steps`` steps from
    ``ell = s2 = 1``, or from the checkpoint at ``checkpoint_path`` where
    there is one, with a checkpoint every ``checkpoint_every`` steps. The
    objective is the NLML as a function of the latent dict
    (``{"ell": log ell, "s2": log s2}``). Returns ``(latent, info)``."""
    f, vs = adam_n2000_objective(device, dtype, n=n)
    loss = _make_loss(f, vs)
    return resumable_minimise(
        loss, vs.latent_dict(), steps=steps, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, optimizer=adam(rate), trace=trace,
        steps_per_dispatch=steps_per_dispatch,
    )


def _nuts_target(n, dev, dtype=torch.float32):
    """``bench_nuts``'s log posterior and start: an EQ GP over ``(log_ell,
    log_s2, log_noise)`` with standard normal priors on the three, from
    ``(0, 0, -1.9)``, on ``n`` sorted uniform points on [0, 10] with ``y =
    sin x + 0.15 noise`` (float32, from a numpy ``RandomState(0)``), in
    ``dtype``."""
    r = np.random.RandomState(0)
    x = np.sort(r.rand(n).astype(np.float32)) * 10
    y = (np.sin(x) + 0.15 * r.randn(n)).astype(np.float32)
    x, y = (torch.as_tensor(a, device=dev).to(dtype) for a in (x, y))

    def logpost(p):
        f = GP(torch.exp(p["log_s2"]) * EQ().stretch(torch.exp(p["log_ell"])))
        lp = f.measure.logpdf(f(x, torch.exp(p["log_noise"])), y)
        return lp - 0.5 * (p["log_ell"] ** 2 + p["log_s2"] ** 2 + p["log_noise"] ** 2)

    init = {
        "log_ell": torch.zeros((), dtype=dtype, device=dev),
        "log_s2": torch.zeros((), dtype=dtype, device=dev),
        "log_noise": torch.full((), -1.9, dtype=dtype, device=dev),
    }
    return logpost, init


def nuts_n2000(key_seed, device=None, *, n=2000, num_chains=4, num_warmup=192,
               num_samples=128, max_depth=6, mesh=None, chain_axis="chains",
               dtype=torch.float32):
    """``bench_nuts``'s run: NUTS with the dense metric over ``(log_ell,
    log_s2, log_noise)`` of an EQ GP with standard normal priors on the
    three, from ``(0, 0, -1.9)``, on ``n`` sorted uniform points on [0, 10]
    with ``y = sin x + 0.15 noise`` (float32, from a numpy
    ``RandomState(0)``), with a CPU generator seeded by ``key_seed`` and
    adaptive jitter on (warm-up explores small noise values where the
    fixed float32 jitter fails). ``mesh`` and ``chain_axis`` split the
    chains over the ranks of a mesh dimension (``sample_nuts``); ``dtype``
    is the model's (the data are drawn in float32). Returns ``(samples,
    accept_rate)``, each sample ``(num_chains, num_samples)``."""
    return _nuts_n2000(key_seed, device, None, n=n, num_chains=num_chains,
                       num_warmup=num_warmup, num_samples=num_samples, max_depth=max_depth,
                       mesh=mesh, chain_axis=chain_axis, dtype=dtype)[:2]


def _nuts_n2000(key_seed, device, drive, *, n=2000, num_chains=4, num_warmup=192,
                num_samples=128, max_depth=6, mesh=None, chain_axis="chains",
                dtype=torch.float32):
    """:func:`nuts_n2000` with its chains run by ``drive``
    (``opt/nuts.py:_sample_nuts``): ``(samples, accept_rate, accepts,
    depths)``."""
    logpost, init = _nuts_target(n, config.resolve_device(device), dtype)
    prev = config.adaptive_jitter
    config.set_adaptive_jitter(True)
    try:
        return _sample_nuts(
            logpost, init, torch.Generator().manual_seed(key_seed), drive,
            num_samples=num_samples, num_warmup=num_warmup, step_size=0.1,
            max_depth=max_depth, num_chains=num_chains, target_accept=0.8,
            adapt_mass="dense", mesh=mesh, chain_axis=chain_axis,
        )
    finally:
        config.set_adaptive_jitter(prev)


def hmc_n2000(key_seed, device=None, *, n=2000, num_chains=2, num_warmup=16, num_samples=16,
              mesh=None, chain_axis="chains", dtype=torch.float32):
    """HMC (``sample_hmc``, 8 leapfrog steps of 0.05) on :func:`nuts_n2000`'s
    posterior, with a CPU generator seeded by ``key_seed`` and adaptive
    jitter on; ``mesh`` and ``chain_axis`` split the chains over a mesh
    dimension; ``dtype`` is the model's. Returns ``(samples, logps,
    accept_rate)``."""
    return _hmc_n2000(key_seed, device, None, n=n, num_chains=num_chains,
                      num_warmup=num_warmup, num_samples=num_samples, mesh=mesh,
                      chain_axis=chain_axis, dtype=dtype)


def _hmc_n2000(key_seed, device, drive, *, n=2000, num_chains=2, num_warmup=16,
               num_samples=16, mesh=None, chain_axis="chains", dtype=torch.float32):
    """:func:`hmc_n2000` with its chains run by ``drive``
    (``opt/hmc.py:_sample_hmc``)."""
    logpost, init = _nuts_target(n, config.resolve_device(device), dtype)
    prev = config.adaptive_jitter
    config.set_adaptive_jitter(True)
    try:
        return _sample_hmc(
            logpost, init, torch.Generator().manual_seed(key_seed), drive,
            num_samples=num_samples, num_warmup=num_warmup, step_size=0.05, n_leapfrog=8,
            num_chains=num_chains, target_accept=0.8, mesh=mesh, chain_axis=chain_axis,
        )
    finally:
        config.set_adaptive_jitter(prev)


# ---------------------------------------------------------------------------
# The pseudo-point path (bench.py:bench_vfe_n2000, bench_dist_elbo_1m).

#: Observation-noise variance of the sparse path.
SPARSE_NOISE = 0.1

_SPARSE_METHODS = {"vfe": PseudoObs, "fitc": PseudoObsFITC, "dtc": PseudoObsDTC}


def _np_dtype(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def vfe_n2000_inputs(dtype=torch.float32, device=None, *, n=2000, m=100):
    """``bench_vfe_n2000``'s data: ``x`` (``n``) and ``z`` (``m``) on
    linspace(0, 10), ``y = sin x + 0.3 cos 3.2x``, and ``ell = 1``; made in
    numpy in ``dtype``. Returns ``(x, y, z, ell)``."""
    npd = _np_dtype(dtype)
    x = np.linspace(0.0, 10.0, n).astype(npd)
    y = (np.sin(x) + npd(0.3) * np.cos(npd(3.2) * x)).astype(npd)
    z = np.linspace(0.0, 10.0, m).astype(npd)
    dev = config.resolve_device(device)
    x, y, z = (torch.as_tensor(a, device=dev) for a in (x, y, z))
    return x, y, z, torch.ones((), dtype=dtype, device=dev)


def sparse_1m_inputs(dtype=torch.float32, device=None, *, n=1_000_000, m=512, seed=1):
    """``bench_dist_elbo_1m``'s data: ``n`` sorted uniform ``x`` on [0, 10)
    and ``y = sin x + 0.1 noise`` from a numpy ``RandomState(seed)``,
    ``z = linspace(0, 10, m)``, ``ell = 1``, made in ``dtype``. Returns
    ``(x, y, z, ell)``."""
    npd = _np_dtype(dtype)
    r = np.random.RandomState(seed)
    x = np.sort(r.rand(n).astype(npd)) * 10
    y = (np.sin(x) + npd(0.1) * r.randn(n).astype(npd)).astype(npd)
    z = np.linspace(0.0, 10.0, m).astype(npd)
    dev = config.resolve_device(device)
    x, y, z = (torch.as_tensor(a, device=dev) for a in (x, y, z))
    return x, y, z, torch.ones((), dtype=dtype, device=dev)


def sparse_jitter(z, ell):
    """The jitter that the adaptive probe picks for the inducing Gram of
    ``EQ().stretch(ell)`` at ``z`` (from ``config.jitter`` of its dtype)."""
    K_z = dense(pairwise(EQ().stretch(ell), z))
    return float(adaptive_jitter_eps(K_z, config.jitter(K_z.dtype)))


@contextlib.contextmanager
def _jitter(jitter):
    """The adaptive jitter when ``jitter`` is None, else ``jitter`` fixed."""
    prev = config.epsilon, config.adaptive_jitter
    if jitter is None:
        config.set_adaptive_jitter(True)
    else:
        config.set_epsilon(float(jitter))
        config.set_adaptive_jitter(False)
    try:
        yield
    finally:
        config.set_epsilon(prev[0])
        config.set_adaptive_jitter(prev[1])


def _sparse_obs(x, y, z, ell, noise, method):
    f = GP(EQ().stretch(ell))
    return f, _SPARSE_METHODS[method](f(z), (f(x, noise), y))


@config.pin_matmul_precision
def sparse_elbo(x, y, z, ell, grad=False, method="vfe", *, jitter=None):
    """The ELBO of ``PseudoObs(f(z), (f(x, SPARSE_NOISE), y))`` (``method``:
    ``"vfe"``, ``"fitc"`` or ``"dtc"``) for ``f = GP(EQ().stretch(ell))``:
    its value, or ``(value, grads)`` with ``grads`` the gradient with respect
    to ``{"log_ell", "log_noise", "z"}``."""
    ell = config.as_scalar(ell, x.dtype, x.device)
    noise = config.as_scalar(SPARSE_NOISE, x.dtype, x.device)
    with _jitter(jitter):
        if not grad:
            with torch.no_grad():
                f, obs = _sparse_obs(x, y, z, ell, noise, method)
                return f.measure.logpdf(obs)
        leaves = [t.detach().requires_grad_(True) for t in (ell, noise, z)]
        with torch.enable_grad():
            f, obs = _sparse_obs(x, y, leaves[2], leaves[0], leaves[1], method)
            val = f.measure.logpdf(obs)
            g_ell, g_noise, g_z = torch.autograd.grad(val, leaves)
    return val.detach(), {"log_ell": ell * g_ell, "log_noise": noise * g_noise, "z": g_z}


#: ``bench.py``'s names for the two sizes of :func:`sparse_elbo`.
vfe_elbo_n2000 = sparse_elbo
sparse_elbo_1m = sparse_elbo


@config.pin_matmul_precision
def sparse_predict(x, y, z, ell, x_new, *, jitter=None):
    """``f | obs`` for the VFE pseudo-observations of :func:`sparse_elbo`,
    and its posterior marginals ``(mean, var)`` at ``x_new``."""
    ell = config.as_scalar(ell, x.dtype, x.device)
    noise = config.as_scalar(SPARSE_NOISE, x.dtype, x.device)
    with _jitter(jitter), torch.no_grad():
        f, obs = _sparse_obs(x, y, z, ell, noise, "vfe")
        return (f | obs)(x_new).marginals()


# ---------------------------------------------------------------------------
# The modelling DSL: the reference's example models.


def _value_and_grad(fn, params, grad):
    """``fn(params)`` (a scalar tensor), or ``(value, grads)`` with
    ``grads`` its gradient with respect to each entry of ``params``."""
    if not grad:
        with torch.no_grad():
            return fn(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        val = fn(leaves)
        grads = torch.autograd.grad(val, list(leaves.values()))
    return val.detach(), dict(zip(leaves, grads))


def _log_params(dtype, device, **values):
    return {k: torch.full((), float(np.log(v)), dtype=dtype, device=device)
            for k, v in values.items()}


def blr_inputs(n=1_000_000, dtype=torch.float32, device=None):
    """Example 6's data at ``n`` points: ``x`` on linspace(0, 10), ``y = 0.8 x
    + 4 + 0.2 eps`` with ``eps`` from a numpy ``RandomState(4)``, made in
    float64 and cast to ``dtype``; and the parameters ``log_s_slope = 0``,
    ``log_s_intercept = log 5``, ``log_noise = log 0.04``. Returns ``(x, y,
    params)``."""
    dev = config.resolve_device(device)
    x = np.linspace(0.0, 10.0, n)
    y = 0.8 * x + 4.0 + 0.2 * np.random.RandomState(4).randn(n)
    npd = _np_dtype(dtype)
    x, y = (torch.as_tensor(a.astype(npd), device=dev) for a in (x, y))
    return x, y, _log_params(dtype, dev, log_s_slope=1.0, log_s_intercept=5.0, log_noise=0.04)


def _identity(z):
    return z


def _blr_model(params):
    """``(prior, slope, intercept, f, y)``: ``f = slope * x + intercept`` with
    ``slope = GP(s_slope)`` and ``intercept = GP(s_intercept)``, ``y = f +
    sqrt(noise) GP(Delta())``."""
    with Measure() as prior:
        slope = GP(torch.exp(params["log_s_slope"]))
        intercept = GP(torch.exp(params["log_s_intercept"]))
        f = slope * _identity + intercept
        e = torch.exp(0.5 * params["log_noise"]) * GP(Delta())
        y = f + e
    return prior, slope, intercept, f, y


@config.pin_matmul_precision
def blr_logpdf(x, y, params, grad=False):
    """Example 6's log marginal likelihood ``log p(y)``: its value, or
    ``(value, grads)`` with ``grads`` its gradient with respect to each
    log-parameter. ``y(x).var`` is a ``Woodbury(Diagonal, LowRank)`` of
    rank 2, so this is O(N)."""

    def fn(p):
        prior, _, _, _, y_p = _blr_model(p)
        return prior.logpdf(y_p(x), y)

    return _value_and_grad(fn, params, grad)


@config.pin_matmul_precision
def blr_predict(x, y, params, n_new=1024):
    """Example 6's posterior: the marginals ``(mean, var)`` of the slope and
    the intercept at one point, and of ``f`` at ``n_new`` points on
    linspace(0, 10), as a dict."""
    with torch.no_grad():
        prior, slope, intercept, f, y_p = _blr_model(params)
        post = prior | (y_p(x), y)
        zero = x.new_zeros(1)
        x_new = torch.linspace(0.0, 10.0, n_new, dtype=x.dtype, device=x.device)
        return {
            "slope": post(slope)(zero).marginals(),
            "intercept": post(intercept)(zero).marginals(),
            "f": post(f)(x_new).marginals(),
        }


def decomposition_inputs(dtype=torch.float32, device=None):
    """Example 2's model at the headline's size: :func:`n2000_inputs`'s ``x``
    and ``y``, and ``log_ell_smooth = log 2``, ``log_ell_wiggly = log 0.5``,
    ``log_noise = log 0.1``. Returns ``(x, y, params)``."""
    x, y, _ = n2000_inputs(dtype, device)
    return x, y, _log_params(dtype, x.device, log_ell_smooth=2.0, log_ell_wiggly=0.5,
                             log_noise=0.1)


def _decomposition_model(params):
    """``(measure, f_smooth, f_wiggly, f, y)``: ``f = f_smooth + f_wiggly``
    with ``f_smooth = GP(EQ().stretch(ell_smooth))`` and ``f_wiggly =
    GP(RQ(0.1).stretch(ell_wiggly))``, ``y = f + GP(noise Delta())``."""
    m = Measure()
    f_smooth = GP(EQ().stretch(torch.exp(params["log_ell_smooth"])), measure=m)
    f_wiggly = GP(RQ(0.1).stretch(torch.exp(params["log_ell_wiggly"])), measure=m)
    e = GP(torch.exp(params["log_noise"]) * Delta(), measure=m)
    f = f_smooth + f_wiggly
    return m, f_smooth, f_wiggly, f, f + e


@config.pin_matmul_precision
def decomposition_logpdf(x, y, params, grad=False):
    """Example 2's log marginal likelihood and decomposition: ``(value,
    means)``, or ``(value, grads, means)`` with ``grad``, where ``grads``
    is the gradient with respect to each log-parameter and ``means`` the
    posterior marginal means of ``f_smooth``, ``f_wiggly`` and ``f`` at
    ``x`` (keys ``"smooth"``, ``"wiggly"``, ``"f"``)."""

    def fn(p):
        m, _, _, _, y_p = _decomposition_model(p)
        return m.logpdf(y_p(x), y)

    out = _value_and_grad(fn, params, grad)
    with torch.no_grad():
        m, f_smooth, f_wiggly, f, y_p = _decomposition_model(params)
        post = m | (y_p(x), y)
        means = {k: post(p)(x).marginals()[0]
                 for k, p in (("smooth", f_smooth), ("wiggly", f_wiggly), ("f", f))}
    return (*out, means) if grad else (out, means)


def derivative_inputs(n=2000, dtype=torch.float32, device=None):
    """Example 5's data at ``n`` points: ``x`` on linspace(0, 5) and ``y =
    -sin x``, made in float64 and cast to ``dtype``; and ``log_scale = log
    0.7``, ``log_ell = log 1.5``, ``log_noise = log 0.01``. Returns ``(x, y,
    params)``."""
    dev = config.resolve_device(device)
    x = np.linspace(0.0, 5.0, n)
    npd = _np_dtype(dtype)
    x, y = (torch.as_tensor(a.astype(npd), device=dev) for a in (x, -np.sin(x)))
    return x, y, _log_params(dtype, dev, log_scale=0.7, log_ell=1.5, log_noise=0.01)


def _derivative_model(params, like):
    """``(measure, ddf)``: ``f = scale GP(EQ()).stretch(ell)``, ``df =
    f.diff()``, ``ddf = df.diff()``, with ``f(0) = 1`` and ``df(0) = 0``
    conditioned on."""
    with Measure() as prior:
        f = torch.exp(params["log_scale"]) * GP(EQ()).stretch(torch.exp(params["log_ell"]))
        df = f.diff()
        ddf = df.diff()
    zero = like.new_zeros(1)
    return prior | ((f(zero), like.new_ones(1)), (df(zero), like.new_zeros(1))), ddf


@config.pin_matmul_precision
def derivative_condition(x, y, params, grad=False):
    """Example 5's model: the log-density of the observations ``ddf(x,
    noise) = y`` after pinning ``f(0) = 1`` and ``df(0) = 0``, and
    ``post(ddf)``'s marginals at ``x``. Returns ``(value, (mean, var))``, or
    ``(value, grads, (mean, var))`` with ``grad``, ``grads`` the gradient
    of the value with respect to each log-parameter."""

    def fn(p):
        prior2, ddf = _derivative_model(p, x)
        return prior2.logpdf(ddf(x, torch.exp(p["log_noise"])), y)

    out = _value_and_grad(fn, params, grad)
    with torch.no_grad():
        prior2, ddf = _derivative_model(params, x)
        post = prior2 | (ddf(x, torch.exp(params["log_noise"])), y)
        marg = post(ddf)(x).marginals()
    return (*out, marg) if grad else (out, marg)


#: Noise added to each factor of the Kronecker run.
KRONECKER_NOISE = 0.1


def kronecker_inputs(n1=1024, n2=1024, dtype=torch.float32, device=None):
    """``bench.py``'s grid: the axes linspace(0, 10, n1) and linspace(0, 8,
    n2), ``y`` a standard normal draw of ``n1 n2`` from a numpy
    ``RandomState(1)``, ``log_ell1 = log_ell2 = 0``, and a mask of each
    axis that drops 10% of its points (drawn from ``RandomState(2)``).
    Returns ``(ax1, ax2, y, params, (mask1, mask2))``."""
    dev = config.resolve_device(device)
    npd = _np_dtype(dtype)
    ax1 = np.linspace(0.0, 10.0, n1).astype(npd)
    ax2 = np.linspace(0.0, 8.0, n2).astype(npd)
    y = np.random.RandomState(1).randn(n1 * n2).astype(npd)
    r = np.random.RandomState(2)
    masks = []
    for n in (n1, n2):
        m = np.ones(n, dtype=bool)
        m[r.choice(n, n // 10, replace=False)] = False
        masks.append(torch.as_tensor(m, device=dev))
    ax1, ax2, y = (torch.as_tensor(a, device=dev) for a in (ax1, ax2, y))
    params = {k: torch.zeros((), dtype=dtype, device=dev) for k in ("log_ell1", "log_ell2")}
    return ax1, ax2, y, params, tuple(masks)


@config.pin_matmul_precision
def kronecker_logpdf(ax1, ax2, y, params, grad=False, mask=None):
    """``Normal(0, Kronecker(A + 0.1 I, B + 0.1 I)).logpdf(y)`` with ``A``
    and ``B`` the Grams of ``EQ().stretch(exp(log_ell1))`` on ``ax1`` and
    ``EQ().stretch(exp(log_ell2))`` on ``ax2``; under ``mask``, a pair of
    boolean vectors (one per axis), the rows of the grid they drop are
    marginalised out. Its value, or ``(value, grads)``."""

    def fn(p):
        factors = [
            add(pairwise(EQ().stretch(torch.exp(p[k])), ax),
                Diagonal(torch.full((ax.shape[0],), KRONECKER_NOISE, dtype=ax.dtype,
                                    device=ax.device)))
            for k, ax in (("log_ell1", ax1), ("log_ell2", ax2))
        ]
        return Normal(Kronecker(*factors)).logpdf(y, mask=mask)

    return _value_and_grad(fn, params, grad)


# ---------------------------------------------------------------------------
# Pathwise draws (bench.py:bench_pathwise_262k) and SVGP on the sparse
# path's N=10^6 data.

#: Observation-noise variance of the pathwise draws.
PATHWISE_NOISE = 0.1


def pathwise_262k_inputs(n=262_144, dtype=torch.float32, device=None, seed=0):
    """``bench_pathwise_262k``'s data (that of :func:`iterative_inputs`):
    ``n`` sorted uniform ``x`` on [0, 10] and ``y = sin x + 0.1 noise``
    from a numpy ``RandomState(seed)``. Returns ``(x, y)``."""
    x, y, _ = iterative_inputs(n, device=device, dtype=dtype, seed=seed)
    return x, y


def pathwise_build(x, y, generator, *, solver="cg", block=8192, mesh=None):
    """``bench_pathwise_262k``'s build: 8 posterior function draws of
    ``GP(EQ())`` under noise 0.1 from ``generator``, with 2048 random
    features and, for ``solver="cg"``, the whitened CG at tol 1e-4 (at most
    200 iterations) under a rank-64 preconditioner; with a 1-D ``mesh``,
    the matvecs and the evaluations row-sharded over it. Returns
    ``(sample_fn, cg_info)``."""
    axis = "data" if mesh is None else mesh.mesh_dim_names[0]
    with torch.no_grad():
        fn, _, info = pathwise_sampler(
            EQ(), x, y, PATHWISE_NOISE, generator, num_samples=8, num_features=2048,
            solver=solver, block=block, cg_tol=1e-4, max_cg_iters=200, precond_rank=64,
            return_info=True, mesh=mesh, axis=axis,
        )
    return fn, info


def svgp_kernel(theta):
    """``exp(log_s2) * EQ().stretch(exp(log_ell))``."""
    return torch.exp(theta["log_s2"]) * EQ().stretch(torch.exp(theta["log_ell"]))


def svgp_1m_inputs(dtype=torch.float32, device=None, *, n=1_000_000, m=512, seed=1):
    """``(x, y, theta, params)``: the data of :func:`sparse_1m_inputs`,
    ``theta = {log_s2: 0, log_ell: 0}`` and ``svgp_init``'s parameters at
    its inducing inputs."""
    x, y, z, _ = sparse_1m_inputs(dtype, device, n=n, m=m, seed=seed)
    theta = {k: torch.zeros((), dtype=dtype, device=x.device) for k in ("log_s2", "log_ell")}
    return x, y, theta, svgp_init(EQ(), z)


@functools.lru_cache(maxsize=8)
def _svgp_indices(n, batch, device):
    """``batch`` of ``range(n)`` without replacement from a numpy
    ``RandomState(0)``, on ``device``: drawn once (the draw permutes all of
    ``range(n)`` on the host), since every call would draw the same."""
    idx = np.random.RandomState(0).choice(n, size=batch, replace=False)
    return torch.as_tensor(idx, device=device)


def _svgp_batch(x, y, batch, mesh=None):
    """The minibatch ``(x_b (B, 1), y_b)`` at :func:`_svgp_indices`; all of
    the data when ``batch`` is None. With a 1-D ``mesh``, each a ``DTensor``
    placed ``Shard(0)`` on it, holding this rank's rows."""
    if batch is not None:
        idx = _svgp_indices(x.shape[0], batch, x.device)
        x, y = x[idx], y[idx]
    x = x[:, None]
    if mesh is not None:
        ax = MeshAxis(mesh, mesh.mesh_dim_names[0])
        rows = x.shape[0]
        if rows % ax.size:
            raise ValueError(f"the batch's {rows} rows do not divide over {ax.size} ranks.")
        n = rows // ax.size
        mine = slice(ax.rank * n, (ax.rank + 1) * n)
        x, y = sharded(x[mine], ax, rows), sharded(y[mine], ax, rows)
    return x, y


@config.pin_matmul_precision
def svgp_1m_step(x, y, theta, params, *, batch=4096, grad=False, jitter=None, mesh=None):
    """The SVGP ELBO of :func:`svgp_kernel` under noise 0.1 on one minibatch
    (``batch`` None: all of the data), its value or ``(value, grads)`` with
    ``grads`` the gradient with respect to ``log_s2``, ``log_ell`` and
    ``z``. ``jitter`` fixes the inducing Gram's jitter (default: the
    adaptive probe, as :func:`sparse_elbo`). With a 1-D ``mesh``, the
    minibatch is sharded over it by rows (``svgp_elbo``'s sharded batch);
    every rank returns the same value and gradients."""
    xb, yb = _svgp_batch(x, y, batch, mesh)

    def fn(p):
        return svgp_elbo(svgp_kernel(p), {**params, "z": p["z"]}, xb, yb, SPARSE_NOISE,
                         x.shape[0])

    with _jitter(jitter):
        return _value_and_grad(fn, {**theta, "z": params["z"]}, grad)


@config.pin_matmul_precision
def svgp_1m_natgrad(x, y, theta, params, *, batch=4096, rho=1.0, jitter=None, mesh=None):
    """One natural-gradient step of step size ``rho`` on the minibatch of
    :func:`svgp_1m_step` (sharded by rows over a 1-D ``mesh`` when given):
    the new parameters."""
    xb, yb = _svgp_batch(x, y, batch, mesh)
    with _jitter(jitter), torch.no_grad():
        return svgp_natgrad_step(svgp_kernel(theta), params, xb, yb, SPARSE_NOISE, x.shape[0],
                                 rho)


# ---------------------------------------------------------------------------
# Structured grids (bench.py:bench_structured_grids) and the small-noise
# operator (bench.py:bench_compensated_262k).

#: Observation-noise variance of the grid and Kronecker paths.
GRID_NOISE = 0.1


def grid_kernel(params):
    """``exp(log_s2) * EQ().stretch(exp(log_ell))``."""
    return torch.exp(params["log_s2"]) * EQ().stretch(torch.exp(params["log_ell"]))


def grid_1m_inputs(n=1 << 20, dtype=torch.float32, device=None):
    """``bench_structured_grids``'s uniform grid: the axis linspace(0, 100,
    n), ``y = sin(axis) + 0.1 eps`` with ``eps`` from a numpy
    ``RandomState(0)``, ``log_s2 = log_ell = 0``. Returns ``(axis, y,
    params)``."""
    dev = config.resolve_device(device)
    npd = _np_dtype(dtype)
    axis = torch.linspace(0.0, 100.0, n, dtype=dtype, device=dev)
    eps = torch.as_tensor(np.random.RandomState(0).randn(n).astype(npd), device=dev)
    params = {k: torch.zeros((), dtype=dtype, device=dev) for k in ("log_s2", "log_ell")}
    return axis, torch.sin(axis) + 0.1 * eps, params


def grid_nlml_1m_step(axis, y, params, generator, *, num_probes=8, cg_tol=1e-2,
                      max_cg_iters=100, slq_steps=20, precond_rank=64):
    """The benchmark's step: ``grid_iterative_nlml`` of :func:`grid_kernel`
    under noise 0.1 with its settings (8 probes, CG tol 1e-2 and at most
    100 iterations, 20 SLQ steps, rank 64): ``(value, grads)``."""

    def fn(p):
        return it.grid_iterative_nlml(
            grid_kernel, p, axis, y, GRID_NOISE, generator, num_probes=num_probes,
            cg_tol=cg_tol, max_cg_iters=max_cg_iters, slq_steps=slq_steps,
            precond_rank=precond_rank,
        )

    return _value_and_grad(fn, params, True)


def grid_posterior_1m(axis, y, params, *, n_mean=4096, n_var=512, chunk=512):
    """The posterior on the grid: the mean at ``n_mean`` points and the
    variance at ``n_var`` points of linspace(0, 100) (CG tol 1e-5, at most
    300 iterations; rank 256: about 160 eigenvalues of the grid's Gram
    exceed the noise, sqrt(2 pi) (N / 100) exp(-(pi k / 100)^2 / 2) > 0.1,
    so the training step's rank 64 would leave the whitened operator's
    condition near 3e4). Returns ``(mean, var, mean_info)``."""
    x_mean = torch.linspace(0.0, 100.0, n_mean, dtype=y.dtype, device=y.device)
    x_var = torch.linspace(0.0, 100.0, n_var, dtype=y.dtype, device=y.device)
    opts = dict(cg_tol=1e-5, max_cg_iters=300, precond_rank=256, block=8192)
    mean, info = it.grid_posterior_mean(grid_kernel, params, axis, y, GRID_NOISE, x_mean,
                                        **opts)
    var = it.grid_posterior_var(grid_kernel, params, axis, y, GRID_NOISE, x_var, chunk=chunk,
                                **opts)
    return mean, var, info


def kron_kernels(params):
    """The per-axis kernels ``(exp(log_s2) * EQ().stretch(exp(log_ell1)),
    EQ().stretch(exp(log_ell2)))``."""
    return (torch.exp(params["log_s2"]) * EQ().stretch(torch.exp(params["log_ell1"])),
            EQ().stretch(torch.exp(params["log_ell2"])))


def kron_1m_inputs(n1=1024, n2=1024, dtype=torch.float32, device=None):
    """``bench_structured_grids``'s tensor grid: the axes linspace(0, 10,
    n1) and linspace(0, 8, n2), ``y`` a standard normal draw of ``n1 n2``
    from a numpy ``RandomState(1)``, ``log_s2 = log_ell1 = log_ell2 = 0``.
    Returns ``(ax1, ax2, y, params)``."""
    dev = config.resolve_device(device)
    npd = _np_dtype(dtype)
    ax1 = torch.linspace(0.0, 10.0, n1, dtype=dtype, device=dev)
    ax2 = torch.linspace(0.0, 8.0, n2, dtype=dtype, device=dev)
    y = torch.as_tensor(np.random.RandomState(1).randn(n1 * n2).astype(npd), device=dev)
    params = {k: torch.zeros((), dtype=dtype, device=dev)
              for k in ("log_s2", "log_ell1", "log_ell2")}
    return ax1, ax2, y, params


def kron_nlml_1m_step(ax1, ax2, y, params):
    """The benchmark's step: ``kron_nlml`` of :func:`kron_kernels` under
    noise 0.1: ``(value, grads)``."""
    return _value_and_grad(lambda p: it.kron_nlml(kron_kernels, p, (ax1, ax2), y, GRID_NOISE),
                           params, True)


def kron_posterior_1m(ax1, ax2, y, params, *, n_new=4096):
    """The exact posterior ``(mean, var)`` at ``n_new`` points drawn
    uniformly over the grid's box from a numpy ``RandomState(3)``."""
    r = np.random.RandomState(3)
    xn = r.rand(n_new, 2) * np.array([float(ax1[-1]), float(ax2[-1])])
    xn = torch.as_tensor(xn.astype(_np_dtype(y.dtype)), device=y.device)
    with torch.no_grad():
        return it.kron_posterior(kron_kernels, params, (ax1, ax2), y, GRID_NOISE, xn)


#: Observation-noise variance of the small-noise runs: ten times below the
#: plain float32 path's practical boundary at N=262,144.
SMALL_NOISE = 0.01


def _eq_only(params):
    return EQ()


def compensated_262k_inputs(n=262_144, dtype=torch.float32, device=None):
    """``bench_compensated_262k``'s data, drawn in its order from one numpy
    ``RandomState(0)``: ``x`` sorted uniform on [0, 10], ``y = sin x + 0.1
    eps`` and ``v (n, 8)`` standard normal. Returns ``(x, y, v)``."""
    dev = config.resolve_device(device)
    npd = _np_dtype(dtype)
    r = np.random.RandomState(0)
    x = torch.as_tensor(np.sort(r.rand(n).astype(npd)) * 10, device=dev)
    y = torch.sin(x) + 0.1 * torch.as_tensor(r.randn(n).astype(npd), device=dev)
    v = torch.as_tensor(r.randn(n, 8).astype(npd), device=dev)
    return x, y, v


def compensated_matvec8_262k(x, v):
    """``(EQ Gram + 0.01 I) @ v`` through the compensated operator."""
    with torch.no_grad():
        return it.kernel_matvec(EQ(), x, v, noise=SMALL_NOISE, block=8192, compensated=True)


def smallnoise_weights_262k(x, y, generator, *, rank=256):
    """The benchmark's small-noise solve: a rank-256 eig state of the EQ
    Gram from ``generator``, the representer weights at noise 0.01 by the
    compensated whitened CG (tol 1e-5, at most 40 iterations), and the true
    relative residual ``||y - (K + 0.01 I) alpha|| / ||y||`` through the
    compensated operator. Returns ``(alpha, info, true_residual)``."""
    with torch.no_grad():
        state = it.eig_precond_state(_eq_only, None, x, rank, generator, block=8192)
        alpha, info = it.posterior_weights(
            _eq_only, None, x, y, SMALL_NOISE, cg_tol=1e-5, max_cg_iters=40,
            precond_state=state, block=8192, compensated=True,
        )
        resid = y - it.kernel_matvec(EQ(), x, alpha, noise=SMALL_NOISE, block=8192,
                                     compensated=True)
        return alpha, info, torch.linalg.vector_norm(resid) / torch.linalg.vector_norm(y)


# ---------------------------------------------------------------------------
# The distributed 1-D paths: bench_dense_nlml_grad's model at N=16,384 and
# bench_dist_elbo_1m, over a mesh of the process group's ranks.

#: Observation-noise variance of the distributed N=16,384 model.
DIST_NOISE = 0.1


def dist_nlml_16k_inputs(n=16_384, dtype=torch.float32, device=None):
    """``bench_dense_nlml_grad``'s data: ``x = linspace(0, 10, n)`` and ``y =
    sin x + 0.3 cos 3.2x``. Returns ``(x, y)``."""
    x = torch.linspace(0.0, 10.0, n, dtype=dtype, device=config.resolve_device(device))
    return x, torch.sin(x) + 0.3 * torch.cos(3.2 * x)


def _dist_value_and_grad(fn, ell, grad):
    """``fn(ell)``, or ``(fn(ell), d fn / d ell)``."""
    if not grad:
        with torch.no_grad():
            return fn(ell)
    val, g = _value_and_grad(lambda p: fn(p["ell"]), {"ell": ell}, True)
    return val, g["ell"]


@config.pin_matmul_precision
def dist_nlml_16k(mesh, ell, grad=False, *, n=16_384):
    """The NLML of ``GP(EQ().stretch(ell))`` at noise 0.1 on
    :func:`dist_nlml_16k_inputs`' data (``n`` points, in ``ell``'s dtype and
    on its device), through ``parallel.sharded_gram`` and ``dist_nlml``
    over ``mesh`` (panel block 256, as the JAX functions default): its
    value, or ``(value, d value / d ell)``, the same on every rank."""
    ell = config.as_tensor(ell)
    x, y = dist_nlml_16k_inputs(n, ell.dtype, ell.device)

    def fn(e):
        K = par.sharded_gram(EQ().stretch(e), x[:, None], mesh, noise=DIST_NOISE)
        return par.dist_nlml(K, y, mesh)

    return _dist_value_and_grad(fn, ell, grad)


@config.pin_matmul_precision
def dist_nlml_2d_16k(mesh, ell, grad=False, *, n=16_384):
    """:func:`dist_nlml_16k`'s NLML over a 2-D grid ``mesh`` (dimensions
    ``"rows"`` and ``"cols"``, ``make_grid_mesh``) through ``dist_nlml_2d``
    (panel block 256): each rank builds its block-cyclic tile set of the
    Gram by one Gram call (K1) on its cyclic row and column points, so no
    tile moves before the factorisation. Its value, or ``(value, d value /
    d ell)``, the same on every rank."""
    ell = config.as_tensor(ell)
    x, y = dist_nlml_16k_inputs(n, ell.dtype, ell.device)
    g = _c2d.grid(mesh, n, device=ell.device)

    def fn(e):
        K = _c2d.cyclic_gram(EQ().stretch(e), x[:, None], g, noise=DIST_NOISE)
        return _c2d.nlml_cyclic(K, y, g)

    return _dist_value_and_grad(fn, ell, grad)


@config.pin_matmul_precision
def dist_elbo_1m(mesh, ell, grad=False, *, inputs=None):
    """The VFE ELBO of ``GP(EQ().stretch(ell))`` at noise 0.1
    on ``bench_dist_elbo_1m``'s data (``inputs``, by default
    :func:`sparse_1m_inputs` in ``ell``'s dtype and on its device), the N
    observations row-sharded over ``mesh`` (``parallel.dist_elbo``): its
    value, or ``(value, d value / d ell)``, the same on every rank."""
    ell = config.as_tensor(ell)
    x, y, z, _ = inputs if inputs is not None else sparse_1m_inputs(ell.dtype, ell.device)

    def fn(e):
        return par.dist_elbo(EQ().stretch(e), z[:, None], x[:, None], y, SPARSE_NOISE, mesh)

    return _dist_value_and_grad(fn, ell, grad)


@config.pin_matmul_precision
def dist_predict_16k(mesh, ell, n_new=1024, *, n=16_384):
    """The posterior marginals ``(mean, var)`` of :func:`dist_nlml_16k`'s
    model at ``n_new`` points on [0, 10], through
    ``parallel.dist_posterior_predict`` over ``mesh``."""
    ell = config.as_tensor(ell)
    x, y = dist_nlml_16k_inputs(n, ell.dtype, ell.device)
    x_new = torch.linspace(0.0, 10.0, n_new, dtype=ell.dtype, device=ell.device)
    return par.dist_posterior_predict(EQ().stretch(ell), x[:, None], y, x_new[:, None],
                                      DIST_NOISE, mesh)
