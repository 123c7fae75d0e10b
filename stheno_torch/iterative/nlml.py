"""Matrix-free exact-GP NLML with stochastic (Hutchinson) gradients, and
the matrix-free posterior.

Counterpart of ``stheno_tpu/iterative/nlml.py``. The forward pass is one
preconditioned CG solve of ``A^{-1} [y, Z]`` (``A = K + noise I``) whose
coefficients also give the log-determinant by the mBCG identity
(``slq.cg_quadrature_logdet``). The backward pass uses the unbiased
estimators

    d logdet / d theta  ~  (1/p) sum_i u_i^T (dA/dtheta) w_i,
    d (y^T A^{-1} y)    =  - alpha^T (dA/dtheta) alpha,  alpha = A^{-1} y,

realised by differentiating the surrogate ``0.5 (mean_i u_i^T A w_i -
alpha^T A alpha)`` with the solves held constant: one differentiable
bilinear form ``sum(A' * (A [w, alpha]))`` with ``A' = 0.5 [U / p,
-alpha]``.

The JAX ``custom_vjp`` becomes the ``torch.autograd.Function``
:class:`_NLMLFunction`: its forward runs without autograd, so every sweep
takes the fused Gram x V kernel K3; its backward rebuilds the kernel from
the parameter leaves and differentiates the surrogate through
``matvec._kernel_bilinear``: for a fused-form kernel one launch of the
fused Gram-gradient kernel (``ops/gram_matvec_vjp.py:_GramBilinearFn``)
gives the surrogate's Gram term and its gradients together, with no K3
sweep and no Gram tile; for any other expression the checkpointed
blocked sweep (K1 tiles on the card).
The core takes the JAX package's hooks: ``matvec_fn(k, x, v, noise)``
replaces the Gram matvec everywhere (the preconditioner build, the CG and
SLQ solves, and the surrogate, whose bilinear form becomes ``sum(A *
matvec_fn(...))``, differentiated by autograd): the grid path
(``toeplitz.py``) passes its FFT matvec. ``fwd_matvec_fn`` replaces it in
the forward solves only (the compensated operator), and
``surrogate_matvec_fn`` in the surrogate only (``surrogate_tile_dtype``).
``surrogate_grad_fn(params, noise, x, U, w, alpha, need) -> (p_bar,
noise_bar, x_bar)`` replaces the surrogate's gradient whole (the
mesh-sharded one of ``parallel/iterative.py``). Without them the core runs
exactly the fused default path above.
JAX ``key``s become ``torch.Generator``s.
"""

import math
import warnings

import torch

from .. import config
from ..kernels.eval import elwise, pairwise
from ..kernels.util import uprank
from ..matrix import dense
from .cg import batched_cg
from .compensated import resolve_compensated
from .matvec import _kernel_bilinear, kernel_matvec
from .pchol import (
    eig_preconditioner_factors,
    eig_preconditioner_ops,
    make_whitened_solver,
    pivoted_cholesky,
    preconditioner_sqrt_ops,
    woodbury_preconditioner,
)
from .slq import cg_quadrature_logdet

__all__ = [
    "iterative_nlml",
    "eig_precond_state",
    "posterior_weights",
    "cached_posterior_mean",
    "iterative_posterior_mean",
    "iterative_posterior_var",
]

_LOG_2_PI = math.log(2 * math.pi)


def _detached(params):
    if not isinstance(params, dict):
        return params
    return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in params.items()}


def _randn(shape, generator, like):
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def _default_generator(device):
    return torch.Generator(device=device).manual_seed(0)


@config.pin_matmul_precision
def eig_precond_state(
    kernel_fn, params, x, rank, generator=None, *, power_iters=1, block=4096,
    init=None, dtype=None,
):
    """Build the eig-preconditioner state ``(U, lam)`` for reuse across
    optimiser steps (``iterative_nlml(..., precond_state=...)``). A stale
    state stays exact: staleness costs CG iterations only.

    Args:
        kernel_fn: ``params -> Kernel`` expression builder.
        params: parameter dict (used detached).
        x: inputs ``(n, d)`` or ``(n,)``.
        rank: preconditioner rank (subspace width).
        generator: ``torch.Generator`` for the start block (ignored when
            ``init`` is given). Without one this warns and seeds 0.
        init: optional ``(n, rank)`` warm-start block (e.g. the previous
            state's ``U``).
        dtype: probe dtype (default: that of ``x``).

    Returns:
        ``(U, lam)`` with orthonormal ``U (n, rank)``.
    """
    x = uprank(x)
    n = x.shape[0]
    dtype = x.dtype if dtype is None else dtype
    with torch.no_grad():
        k = kernel_fn(_detached(params))
        if init is not None:
            om = init.detach()
        else:
            if generator is None:
                warnings.warn(
                    "eig_precond_state: no `generator` passed; seeding 0. Pass an "
                    "explicit generator (or `init`) to make the probe basis "
                    "independent across models.",
                    stacklevel=2,
                )
                generator = _default_generator(x.device)
            om = torch.randn(
                (n, min(rank, n)), generator=generator, dtype=dtype, device=x.device
            )
        return eig_preconditioner_factors(
            lambda v: kernel_matvec(k, x, v, block=block), om, power_iters
        )


class _Config:
    """The non-tensor arguments of :class:`_NLMLFunction`, and the forward
    solve's health dict it hands back."""

    def __init__(self, names, kernel_fn, block, cg_tol, max_cg_iters, quad_steps,
                 precond_rank, precond_method, precond_power_iters, matvec_fn=None,
                 fwd_matvec_fn=None, surrogate_matvec_fn=None, surrogate_grad_fn=None):
        self.names = names
        self.matvec_fn = matvec_fn
        self.fwd_matvec_fn = fwd_matvec_fn
        self.surrogate_matvec_fn = surrogate_matvec_fn
        self.surrogate_grad_fn = surrogate_grad_fn
        self.kernel_fn = kernel_fn
        self.block = block
        self.cg_tol = cg_tol
        self.max_cg_iters = max_cg_iters
        self.quad_steps = quad_steps
        self.precond_rank = precond_rank
        self.precond_method = precond_method
        self.precond_power_iters = precond_power_iters
        self.health = None

    def matvec(self, k, x, v, noise):
        """The Gram matvec: ``matvec_fn``, or the blocked/fused one."""
        if self.matvec_fn is not None:
            return self.matvec_fn(k, x, v, noise)
        return kernel_matvec(k, x, v, noise=noise, block=self.block)


def _nlml_forward(cfg, params, y, noise, x, u, om, pstate):
    """The forward solve: ``(nlml, health, alpha, U, w)``; no autograd."""
    n = x.shape[0]
    k = cfg.kernel_fn(params)
    fwd = cfg.fwd_matvec_fn or cfg.matvec
    mv = lambda v: fwd(k, x, v, noise)  # noqa: E731
    steps = min(cfg.quad_steps, cfg.max_cg_iters)
    use_eig = pstate is not None or (
        cfg.precond_method == "eig" and bool(cfg.precond_rank) and cfg.precond_rank > 0
    )
    if use_eig:
        # Split-preconditioned CG on the whitened operator P^{-1/2} A
        # P^{-1/2}: its condition number is O(1), so float32 CG converges
        # where CG on A itself stalls at its rounding floor, and the probes
        # u ~ N(0, I) enter unwhitened (logdet A = logdet P + tr log At).
        if pstate is not None:
            Ue, lam = pstate
        else:
            Ue, lam = eig_preconditioner_factors(
                lambda v: cfg.matvec(k, x, v, None), om, cfg.precond_power_iters
            )
        _, _, apply_half_inv, logdet_p = eig_preconditioner_ops(Ue, lam, noise, n)
        mv_white = lambda v: apply_half_inv(mv(apply_half_inv(v)))  # noqa: E731
        rhs = torch.cat([apply_half_inv(y)[:, None], u], dim=1)
        sol, info = batched_cg(
            mv_white, rhs, tol=cfg.cg_tol, max_iters=cfg.max_cg_iters, track_tridiag=steps
        )
        # Back to unwhitened space: alpha = A^{-1} y, U = A^{-1} P^{1/2} u,
        # w = P^{-1/2} u (E[u w^T] = A^{-1} under the whitened probes).
        alpha = apply_half_inv(sol[:, 0])
        U = apply_half_inv(sol[:, 1:])
        w = apply_half_inv(u)
    else:
        precond = None
        logdet_p = 0.0
        z = u
        if cfg.precond_rank and cfg.precond_rank > 0:
            L = pivoted_cholesky(k, x, cfg.precond_rank)
            precond = woodbury_preconditioner(L, noise)
            _, apply_half, logdet_p = preconditioner_sqrt_ops(L, noise)
            z = apply_half(u)  # Probes ~ N(0, P).
        rhs = torch.cat([y[:, None], z], dim=1)
        sol, info = batched_cg(
            mv, rhs, precond=precond, tol=cfg.cg_tol, max_iters=cfg.max_cg_iters,
            track_tridiag=steps,
        )
        alpha, U = sol[:, 0], sol[:, 1:]
        w = precond(z) if precond is not None else z

    # Logdet for free from the probe columns' CG coefficients (mBCG).
    alphas_t, betas_t, steps_t = info["tridiag"]
    logdet = logdet_p + cg_quadrature_logdet(
        alphas_t[:, 1:], betas_t[:, 1:], steps_t[1:], torch.sum(u * u, dim=0)
    )
    nlml = 0.5 * (logdet + torch.sum(y * alpha) + n * _LOG_2_PI)

    # Solver health: a stalled CG gives wrong gradients silently, so warn.
    rel = info["rel_residual"]
    converged = bool(rel <= cfg.cg_tol)
    if not converged:
        warnings.warn(
            f"stheno_torch.iterative: CG STALLED - rel residual {float(rel):.3e} > tol "
            f"{cfg.cg_tol:.1e} after {info['iters']} iterations; the NLML value and its "
            "gradients are unreliable. Raise max_cg_iters, the preconditioner rank or "
            "the noise floor"
            + ("." if cfg.fwd_matvec_fn is not None else
               ", or switch the solve onto the two-float matvec (compensated=True)."),
            RuntimeWarning,
            stacklevel=4,
        )
    health = {"cg_iters": info["iters"], "cg_rel_residual": rel, "cg_converged": converged}
    return nlml, health, alpha, U, w


def _surrogate_grads(cfg, leaves, noise, x, U, w, alpha, need):
    """Gradients of the Hutchinson surrogate ``0.5 (mean_i u_i^T A w_i -
    alpha^T A alpha)`` with respect to the parameter leaves, ``noise`` and
    ``x`` (``None`` where ``need`` is false), through one differentiable
    bilinear form, ``sum(0.5 [U / p, -alpha] * (A [w, alpha]))``
    (``matvec._kernel_bilinear``): the same function, summed in another
    order.

    With ``cfg.matvec_fn`` or ``cfg.surrogate_matvec_fn`` the bilinear
    form is ``sum(A' * matvec_fn(k, x, V, noise))`` through autograd. A
    rounded-tile surrogate (``surrogate_matvec_fn``) runs in the input
    dtype, as in the JAX package: its tiles' rounding is far above any
    summation error. Otherwise float32 inputs are swept in float64. A
    fused-form kernel builds no
    tile and runs no forward sweep (one launch of the fused Gram-gradient
    kernel for the value and the gradients); the row block, halved so that
    a tile takes the same bytes, only matters for the blocked sweep of
    other expressions. The gradient sums each term
    over all N^2 Gram entries, whose contributions cancel to a value many
    orders of magnitude below their sizes; in float32 those sums lose it.
    Measured on an H100 at N=262,144 (``chip_smoke.py`` phase
    ``iterative_gates`` tests it): a float32 sweep put d/d log_s2 38% away
    from an all-float64 step (4.38 against 7.04), a float64 sweep over the
    same float32 solves 0.5%. The solves and their forward sweeps stay in
    the input dtype."""
    p = w.shape[1]
    smv = cfg.surrogate_matvec_fn or cfg.matvec_fn
    wide = (torch.float64 if x.dtype == torch.float32 and cfg.surrogate_matvec_fn is None
            else x.dtype)
    block = max(1, cfg.block * x.element_size() // (torch.finfo(wide).bits // 8))
    inputs = [
        t.detach().to(wide).requires_grad_(bool(nd))
        for t, nd in zip((*leaves, noise, x), need)
    ]
    *leaves_d, noise_d, x_d = inputs
    U, w, alpha = U.to(wide), w.to(wide), alpha.to(wide)
    with torch.enable_grad():
        k = cfg.kernel_fn(dict(zip(cfg.names, leaves_d)))
        A = 0.5 * torch.cat([U / p, -alpha[:, None]], dim=1)
        V = torch.cat([w, alpha[:, None]], dim=1)
        if smv is None:
            surrogate = _kernel_bilinear(k, x_d, A, V, noise=noise_d, block=block)
        else:
            surrogate = torch.sum(A * smv(k, x_d, V, noise_d))
        targets = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(surrogate, targets, allow_unused=True))
    out = []
    for t, orig in zip(inputs, (*leaves, noise, x)):
        gr = next(grads) if t.requires_grad else None
        if t.requires_grad and gr is None:
            gr = torch.zeros_like(t)
        out.append(None if gr is None else gr.to(orig.dtype))
    return out


class _NLMLFunction(torch.autograd.Function):
    """The stochastic NLML with its surrogate gradient: the port of the JAX
    package's ``custom_vjp`` ``_nlml``. Inputs after ``cfg``: ``y``,
    ``noise``, ``x``, the probes ``u`` and ``om``, the state ``(U, lam)``
    (or ``None``s), then the parameter leaves in ``cfg.names`` order."""

    @staticmethod
    def forward(ctx, cfg, y, noise, x, u, om, state_U, state_lam, *leaves):
        params = dict(zip(cfg.names, leaves))
        pstate = None if state_U is None else (state_U, state_lam)
        nlml, cfg.health, alpha, U, w = _nlml_forward(cfg, params, y, noise, x, u, om, pstate)
        ctx.cfg = cfg
        ctx.save_for_backward(noise, x, alpha, U, w, *leaves)
        return nlml

    @staticmethod
    @config.pin_matmul_precision
    def backward(ctx, g):
        noise, x, alpha, U, w, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad
        # The leaves, noise and x, in the order _surrogate_grads takes them.
        need_sur = [*need[8:], need[2], need[3]]
        grads = [None] * len(need_sur)
        cfg = ctx.cfg
        if any(need_sur) and cfg.surrogate_grad_fn is not None:
            p_bar, noise_bar, x_bar = cfg.surrogate_grad_fn(
                dict(zip(cfg.names, leaves)), noise, x, U, w, alpha, need_sur)
            grads = [p_bar[k] for k in cfg.names] + [noise_bar, x_bar]
        elif any(need_sur):
            grads = _surrogate_grads(cfg, leaves, noise, x, U, w, alpha, need_sur)
        *leaf_bars, noise_bar, x_bar = [None if t is None else t * g for t in grads]
        y_bar = g * alpha if need[1] else None
        return (None, y_bar, noise_bar, x_bar, None, None, None, None, *leaf_bars)


def _nlml(params, y, noise, x, u, om, pstate, kernel_fn, cg_tol, max_cg_iters, quad_steps,
          precond_rank, precond_method="pivoted", precond_power_iters=1, *, block=4096,
          matvec_fn=None, fwd_matvec_fn=None, surrogate_matvec_fn=None, surrogate_grad_fn=None):
    """Shared stochastic-NLML core: ``(nlml, health)``, differentiable with
    respect to the tensors in ``params``, ``y``, ``noise`` and ``x``.

    ``u (n, p)`` are standard-normal probes and ``om (n, r)`` the subspace
    start block of a fresh eig preconditioner (``None`` otherwise);
    ``pstate`` an optional prebuilt ``(U, lam)``, held constant.
    ``matvec_fn``, ``fwd_matvec_fn``, ``surrogate_matvec_fn`` and
    ``surrogate_grad_fn`` are the hooks of the module docstring; the last
    takes the parameter leaves as a dict and ``need``, whether each leaf,
    ``noise`` and ``x`` (in that order) needs a gradient, and returns
    ``None`` where one does not."""
    names = list(params)
    leaves = [
        v if isinstance(v, torch.Tensor) else torch.as_tensor(v, dtype=y.dtype, device=y.device)
        for v in params.values()
    ]
    noise = torch.as_tensor(noise, dtype=y.dtype, device=y.device)
    cfg = _Config(names, kernel_fn, block, cg_tol, max_cg_iters, quad_steps, precond_rank,
                  precond_method, precond_power_iters, matvec_fn, fwd_matvec_fn,
                  surrogate_matvec_fn, surrogate_grad_fn)
    state_U, state_lam = (None, None) if pstate is None else (
        pstate[0].detach(), pstate[1].detach())
    val = _NLMLFunction.apply(cfg, y, noise, x, u.detach(),
                              None if om is None else om.detach(), state_U, state_lam, *leaves)
    return val, cfg.health


@config.pin_matmul_precision
def iterative_nlml(
    kernel_fn,
    params,
    x,
    y,
    noise,
    generator,
    *,
    num_probes=8,
    cg_tol=1e-4,
    max_cg_iters=500,
    slq_steps=20,
    precond_rank=64,
    precond_method="eig",
    precond_power_iters=1,
    precond_state=None,
    surrogate_tile_dtype=None,
    block=4096,
    return_info=False,
    compensated="auto",
):
    """Stochastic estimate of the exact-GP NLML, differentiable with
    respect to the tensors in ``params``, ``noise``, ``y`` and ``x``.

    ``precond_method``: ``"eig"`` (default; subspace-iteration eig
    preconditioner, robust in float32 at large N) or ``"pivoted"``
    (pivoted Cholesky and Woodbury). ``precond_state``: optional prebuilt
    ``(U, lam)`` from :func:`eig_precond_state` (the amortised path).
    ``generator``: ``torch.Generator`` for the probes (drawn ``u (n,
    num_probes)`` first, then the subspace block). ``return_info=True``
    also returns ``{"cg_iters", "cg_rel_residual", "cg_converged"}``; a
    stalled CG warns whatever ``return_info`` is.

    ``compensated``: the two-float policy of the forward CG and logdet
    solves (``compensated.py``); ``"auto"`` decides by value from
    ``precond_state``'s Ritz values (``False`` without a state). The
    backward surrogate stays on the plain differentiable matvec.

    ``surrogate_tile_dtype``: the dtype the backward surrogate's Gram tiles
    are rounded to (``kernel_matvec(tile_dtype=...)``); the forward solves
    keep the input dtype. The JAX package measured it and rejected it for
    training at N=262,144 (a gradient bias correlated with the tiles'
    structure, about 1000 times the probe noise); it is for small-N
    experiments.
    """
    x = uprank(x)
    n = x.shape[0]
    u = _randn((n, num_probes), generator, y)
    om = None
    if precond_state is None and precond_method == "eig" and precond_rank and precond_rank > 0:
        om = _randn((n, min(precond_rank, n)), generator, y)
    lam = precond_state[1] if precond_state is not None else torch.zeros(1)
    fwd_matvec_fn = surrogate_matvec_fn = None
    if resolve_compensated(compensated, noise, lam, n, y.dtype, True):
        def fwd_matvec_fn(k, xx, v, nz):
            return kernel_matvec(k, xx, v, noise=nz, block=block, compensated=True)
    if surrogate_tile_dtype is not None:
        def surrogate_matvec_fn(k, xx, v, nz):
            return kernel_matvec(k, xx, v, noise=nz, block=block, tile_dtype=surrogate_tile_dtype)
    val, info = _nlml(
        params, y, noise, x, u, om, precond_state, kernel_fn, cg_tol, max_cg_iters,
        slq_steps, precond_rank, precond_method, precond_power_iters, block=block,
        fwd_matvec_fn=fwd_matvec_fn, surrogate_matvec_fn=surrogate_matvec_fn,
    )
    return (val, info) if return_info else val


def _compensated_mv(k, x, block):
    return lambda v: kernel_matvec(k, x, v, block=block, compensated=True)


@config.pin_matmul_precision
def posterior_weights(kernel_fn, params, x, y, noise, *, cg_tol=1e-6, max_cg_iters=1000,
                      precond_rank=64, precond_state=None, block=4096, compensated="auto"):
    """Representer weights ``alpha = (K + noise I)^{-1} y`` by matrix-free
    preconditioned CG: the one-time solve of the amortised serving path.
    Returns ``(alpha, info)``. Whitened (eig-preconditioned) for scalar
    noise with a rank or a ``precond_state``; plain CG otherwise. Runs
    without autograd, as in the JAX package (no gradient through CG)."""
    with torch.no_grad():
        k = kernel_fn(_detached(params))
        y = y.detach()
        noise = torch.as_tensor(noise, dtype=y.dtype, device=y.device)
        if (precond_state is not None or (precond_rank and precond_rank > 0)) and noise.ndim == 0:
            x = uprank(x)
            solver = make_whitened_solver(
                lambda v: kernel_matvec(k, x, v, block=block), x.shape[0], noise,
                precond_rank, dtype=y.dtype, state=precond_state,
                mv_raw_comp=_compensated_mv(k, x, block), compensated=compensated,
            )
            return solver(y, tol=cg_tol, max_iters=max_cg_iters)
        mv = lambda v: kernel_matvec(k, x, v, noise=noise, block=block)  # noqa: E731
        return batched_cg(mv, y, tol=cg_tol, max_iters=max_cg_iters)


@config.pin_matmul_precision
def cached_posterior_mean(kernel_fn, params, x, alpha, x_new, *, block=4096):
    """Posterior mean at ``x_new`` from prebuilt representer weights
    ``alpha`` (:func:`posterior_weights`): ``k(x_new, x) @ alpha`` as a
    matrix-free sweep over row blocks of ``x_new`` (K3 when no gradient
    flows). No CG."""
    k = kernel_fn(params)
    return kernel_matvec(k, uprank(x_new), alpha, x_cols=uprank(x), block=block)


@config.pin_matmul_precision
def iterative_posterior_mean(kernel_fn, params, x, y, noise, x_new, *, cg_tol=1e-6,
                             max_cg_iters=1000, precond_rank=64, precond_state=None,
                             block=4096):
    """Matrix-free posterior mean at ``x_new``: :func:`posterior_weights`
    then :func:`cached_posterior_mean`. Returns ``(mean, info)``."""
    alpha, info = posterior_weights(
        kernel_fn, params, x, y, noise, cg_tol=cg_tol, max_cg_iters=max_cg_iters,
        precond_rank=precond_rank, precond_state=precond_state, block=block,
    )
    return cached_posterior_mean(kernel_fn, params, x, alpha, x_new, block=block), info


@config.pin_matmul_precision
def iterative_posterior_var(kernel_fn, params, x, y, noise, x_new, *, cg_tol=1e-6,
                            max_cg_iters=1000, precond_rank=64, precond_state=None,
                            block=4096, chunk=512, mode="scan", compensated="auto"):
    """Matrix-free posterior variance diagonal at ``x_new``,
    ``k(x*, x*) - k_*^T (K + noise I)^{-1} k_*``, exact per query: each
    ``chunk`` of test points runs its own CG against all N training points
    with the chunk's cross-covariances as right-hand sides (the last chunk
    padded with zero inputs to ``chunk`` columns, as in the JAX package).
    For many test points, :func:`~stheno_torch.iterative.variance_cache`
    amortises the work.

    ``mode``: ``"scan"`` or ``"host"``. In the JAX package they are one
    fused ``lax.map`` program and a host loop over one jitted chunk
    program; in torch every call is eager, so both are the same Python
    loop over chunks. Runs without autograd."""
    if mode not in ("scan", "host"):
        raise ValueError(f"Unknown mode {mode!r}; use 'scan' or 'host'.")
    with torch.no_grad():
        k = kernel_fn(_detached(params))
        x_arr, xn = uprank(x), uprank(x_new)
        m = xn.shape[0]
        noise = torch.as_tensor(noise, dtype=xn.dtype, device=xn.device)
        if (precond_state is not None or (precond_rank and precond_rank > 0)) and noise.ndim == 0:
            solver = make_whitened_solver(
                lambda v: kernel_matvec(k, x_arr, v, block=block), x_arr.shape[0], noise,
                precond_rank, dtype=xn.dtype, state=precond_state,
                mv_raw_comp=_compensated_mv(k, x_arr, block), compensated=compensated,
            )
        else:
            mv = lambda v: kernel_matvec(k, x_arr, v, noise=noise, block=block)  # noqa: E731
            solver = lambda rhs, tol, max_iters: batched_cg(  # noqa: E731
                mv, rhs, tol=tol, max_iters=max_iters
            )
        chunk = min(chunk, m)
        m_pad = -(-m // chunk) * chunk
        xn_pad = torch.cat([xn, xn.new_zeros((m_pad - m, xn.shape[1]))], dim=0)
        reductions = []
        for xc in torch.split(xn_pad, chunk):
            K_xc = dense(pairwise(k, x_arr, xc))  # (N, chunk)
            sol, _ = solver(K_xc, tol=cg_tol, max_iters=max_cg_iters)
            reductions.append(torch.sum(K_xc * sol, dim=0))
        prior = dense(elwise(k, xn))[:, 0]
        return torch.clamp_min(prior - torch.cat(reductions)[:m], 0.0)
