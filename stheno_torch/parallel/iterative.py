"""Matrix-free exact GPs over a mesh: the iterative path with its matvecs
row-sharded.

Counterpart of ``stheno_tpu/parallel/iterative.py``. The O(N)-memory Gram
matvec (``iterative/matvec.py``) runs on this rank's rows only: ``x``
(zero-padded to a multiple of the axis size) is split into row blocks,
each rank multiplies its ``(n_pad / D, n)`` rows of the Gram with the
replicated right-hand sides (kernel K3 on the card for a fused-form
kernel), and one ``all_gather`` of the ``(n, p)`` result makes it
replicated again. Every CG and Lanczos iteration of the stochastic NLML
(``iterative/nlml.py``) then runs replicated on every rank: the gathered
products are the same bytes on every rank, so each rank makes the same
decisions and ends with the same value.

The NLML's gradient is the grad-inside-shard idiom of the JAX package:
each rank differentiates its rows' share of the Hutchinson surrogate
(:func:`make_sharded_surrogate_grad`) with ``torch.autograd.grad`` and the
replicated inputs' gradients are summed over the axis by hand, outside
autograd. For a fused form the local product is
``ops/gram_matvec_vjp.py:_GramMatvecFn``: K3 forward, and the fused
Gram-gradient kernel backward, one launch for the rows role and one for
the columns role.

Differences from the JAX package, by design:

- Every call gathers. The JAX package leaves a terminal matvec's output
  sharded (no collective) and gathers once for each matvec whose output
  feeds the next; eager torch has no later consumer to defer to, so each
  call of :func:`sharded_kernel_matvec` moves ``(D - 1)/D * n * p * w``
  bytes a rank (``utils.comm``'s ring model), a terminal one included.
- The surrogate sweeps float32 inputs in float64, as the port's
  single-device surrogate does (``iterative/nlml.py:_surrogate_grads``):
  a float32 sweep put d/d log_s2 38% off at N=262,144 on an H100. The
  JAX sharded surrogate sweeps in the input dtype.
- The collectives raise under a gradient (``_comm.py``): the matvecs are
  forward-only, as the JAX functions are documented to be; the NLML's
  gradient comes from the surrogate.
"""

import torch

from .. import config
from ..iterative.matvec import kernel_matvec
from ..iterative.nlml import _nlml, _randn
from ..kernels.util import uprank
from ._comm import MeshAxis, all_gather_rows, all_reduce

__all__ = ["sharded_kernel_matvec", "sharded_iterative_nlml", "make_sharded_surrogate_grad"]


def _pad_rows(a, n_pad):
    """``a`` with its leading axis zero-padded to ``n_pad`` rows (a new
    tensor; the padded rows are sliced away or carry zero weights)."""
    return torch.cat([a, a.new_zeros((n_pad - a.shape[0],) + tuple(a.shape[1:]))])


def _padded_rows(n, ax):
    """``(n_pad, D)``: ``n`` rounded up to a multiple of the axis size."""
    D = ax.size
    return -(-n // D) * D, D


def _local(a, n_pad, ax):
    """This rank's row block of ``a`` zero-padded to ``n_pad`` rows."""
    nl = n_pad // ax.size
    return _pad_rows(a, n_pad)[ax.rank * nl:(ax.rank + 1) * nl]


def _rows_matvec(k, rows, cols, v2, ax, block):
    """``k(rows, cols) @ v2`` (``(n, p)``, replicated) with the rows split
    over ``ax``: the local product, then one all-gather."""
    n = rows.shape[0]
    n_pad, D = _padded_rows(n, ax)
    local = kernel_matvec(k, _local(rows, n_pad, ax), v2, block=min(block, n_pad // D),
                          x_cols=cols)
    return all_gather_rows(local, ax)[:n]


@config.pin_matmul_precision
def sharded_kernel_matvec(k, x, v, mesh, axis="data", noise=None, block=4096):
    """``(k(x, x) + noise I) @ v`` with the row blocks distributed over
    ``axis``. ``x``: ``(n, d)`` or ``(n,)``, replicated; ``v``: ``(n, p)``
    or ``(n,)``, replicated; ``noise`` a scalar or ``(n,)``, added after the
    gather. ``n`` is zero-padded to a multiple of the axis size. Returns a
    replicated result of ``v``'s shape. Forward only (a gradient raises);
    the NLML's gradient goes through :func:`make_sharded_surrogate_grad`."""
    ax = MeshAxis(mesh, axis)
    x = uprank(config.as_tensor(x))
    v_in = config.as_tensor(v)
    v2 = v_in[:, None] if v_in.ndim == 1 else v_in
    out = _rows_matvec(k, x, x, v2, ax, block)
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=v2.dtype, device=v2.device)
        out = out + (noise[:, None] if noise.ndim == 1 else noise) * v2
    return out[:, 0] if v_in.ndim == 1 else out


@config.pin_matmul_precision
def _cross_matvec_sharded(k, x_rows, x_cols, v, mesh, axis="data", block=4096):
    """``k(x_rows, x_cols) @ v`` with the rows sharded over ``axis``
    (pathwise evaluation at large test batches); replicated."""
    v = config.as_tensor(v)
    return _rows_matvec(k, uprank(config.as_tensor(x_rows)), uprank(config.as_tensor(x_cols)),
                        v[:, None] if v.ndim == 1 else v, MeshAxis(mesh, axis), block)


def make_sharded_surrogate_grad(kernel_fn, mesh, axis="data", block=4096):
    """The NLML core's ``surrogate_grad_fn`` over the mesh: the gradient of
    the Hutchinson surrogate ``S = 0.5 (mean_i u_i^T (K + noise I) w_i -
    alpha^T (K + noise I) alpha)`` with respect to the parameter leaves,
    ``noise`` and ``x``.

    Each rank takes its rows' share, ``S_r = 0.5 ((sum U_r o (K(x_r, x)
    [w, alpha])[:, :p] + noise sum U_r o w_r) / p - sum alpha_r o (K(x_r,
    x) [w, alpha])[:, p] - noise sum alpha_r^2)``, and its gradient with
    respect to the leaves, ``noise``, its rows ``x_r`` and the columns
    ``x``, by ``torch.autograd.grad`` through one product with ``[w,
    alpha]``. The replicated inputs' gradients are summed over the axis in
    one all-reduce, and ``x``'s gradient is the columns' plus the rows'
    gathered. Padded rows carry zero weights, so they add neither value nor
    gradient. Float32 inputs are swept in float64 (the module docstring)."""

    def surrogate_grad(params, noise, x, U, w, alpha, need):
        ax = MeshAxis(mesh, axis)
        names = list(params)
        n = x.shape[0]
        n_pad, D = _padded_rows(n, ax)
        wide = torch.float64 if x.dtype == torch.float32 else x.dtype
        local_block = max(1, min(block, n_pad // D) * x.element_size()
                          // (torch.finfo(wide).bits // 8))
        *need_p, need_noise, need_x = (bool(b) for b in need)
        leaves = [params[k].detach().to(wide).requires_grad_(nd) for k, nd in zip(names, need_p)]
        noise_d = noise.detach().to(wide).requires_grad_(need_noise)
        x_cols = x.detach().to(wide).requires_grad_(need_x)
        x_rows = _local(x.detach().to(wide), n_pad, ax).clone().requires_grad_(need_x)
        U_r, w_r, a_r = (_local(t.to(wide), n_pad, ax) for t in (U, w, alpha))
        p = U.shape[1]
        V = torch.cat([w.to(wide), alpha.to(wide)[:, None]], dim=1)
        inputs = (*leaves, noise_d, x_rows, x_cols)
        with torch.enable_grad():
            KV = kernel_matvec(kernel_fn(dict(zip(names, leaves))), x_rows, V,
                               block=local_block, x_cols=x_cols)
            trace_est = (torch.sum(U_r * KV[:, :p]) + noise_d * torch.sum(U_r * w_r)) / p
            quad = torch.sum(a_r * KV[:, p]) + noise_d * torch.sum(a_r * a_r)
            S = 0.5 * (trace_est - quad)
            targets = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(S, targets, allow_unused=True))
        grads = []
        for t in inputs:
            g = next(got) if t.requires_grad else None
            grads.append(torch.zeros_like(t) if t.requires_grad and g is None else g)
        *leaf_bars, noise_bar, x_rows_bar, x_cols_bar = grads
        # The replicated inputs' gradients, summed over the axis at once.
        summed = [g for g in (*leaf_bars, noise_bar, x_cols_bar) if g is not None]
        flat = all_reduce(torch.cat([g.reshape(-1) for g in summed]), ax)
        parts = iter(torch.split(flat, [g.numel() for g in summed]))
        leaf_bars, noise_bar, x_cols_bar = (
            [None if g is None else next(parts).view_as(g) for g in leaf_bars],
            None if noise_bar is None else next(parts).view_as(noise_bar),
            None if x_cols_bar is None else next(parts).view_as(x_cols_bar),
        )
        x_bar = None
        if need_x:
            x_bar = (x_cols_bar + all_gather_rows(x_rows_bar, ax)[:n]).to(x.dtype)
        p_bar = {k: None if g is None else g.to(params[k].dtype)
                 for k, g in zip(names, leaf_bars)}
        return p_bar, None if noise_bar is None else noise_bar.to(noise.dtype), x_bar

    return surrogate_grad


@config.pin_matmul_precision
def sharded_iterative_nlml(
    kernel_fn,
    params,
    x,
    y,
    noise,
    generator,
    mesh,
    *,
    axis="data",
    num_probes=8,
    cg_tol=1e-3,
    max_cg_iters=200,
    slq_steps=16,
    precond_rank=64,
    precond_method="eig",
    precond_power_iters=1,
    precond_state=None,
    block=4096,
    return_info=False,
):
    """The exact-GP NLML estimate with every matvec distributed over the
    mesh: the multi-rank training objective, differentiable with respect to
    the tensors in ``params``, ``noise``, ``y`` and ``x``. It is
    ``iterative_nlml``'s core with the forward Gram matvec swapped for
    :func:`sharded_kernel_matvec` and the backward surrogate for
    :func:`make_sharded_surrogate_grad`. ``generator``: the probes ``u (n,
    num_probes)``, then the subspace block of a fresh eig preconditioner,
    as ``iterative_nlml`` draws them (the eig build touches the operator
    through the matvec only, so it distributes too). ``params`` may be
    ``None`` (``kernel_fn`` then gets an empty dict); ``precond_state`` and
    ``return_info`` as in ``iterative_nlml``. Every rank returns the same
    value and gradients."""
    x = uprank(config.as_tensor(x))
    y = config.as_tensor(y)
    n = x.shape[0]
    u = _randn((n, num_probes), generator, y)
    om = None
    if precond_state is None and precond_method == "eig" and precond_rank and precond_rank > 0:
        om = _randn((n, min(precond_rank, n)), generator, y)

    def matvec_fn(k, xx, v, nz):
        return sharded_kernel_matvec(k, xx, v, mesh, axis=axis, noise=nz, block=block)

    val, info = _nlml(
        {} if params is None else params, y, noise, x, u, om, precond_state, kernel_fn, cg_tol,
        max_cg_iters, slq_steps, precond_rank, precond_method, precond_power_iters, block=block,
        matvec_fn=matvec_fn,
        surrogate_grad_fn=make_sharded_surrogate_grad(kernel_fn, mesh, axis=axis, block=block),
    )
    return (val, info) if return_info else val
