"""The collectives of the distributed paths, and the only module of the
port that issues one.

Every function here takes a :class:`MeshAxis` (one named dimension of a
``torch.distributed.device_mesh.DeviceMesh``) and issues its collective
over that dimension's process group, with ``torch.distributed``'s calls:

- :func:`all_gather_rows`: the ranks' blocks stacked along dim 0, in rank
  order (the counterpart of ``lax.all_gather(..., tiled=True)``);
- :func:`all_reduce`: the sum over the ranks, on every rank (``psum``);
- :func:`reduce_to`: the sum over the ranks, on one rank;
- :func:`broadcast_from`: one rank's block, on every rank;
- :func:`all_to_all_rows`: row blocks exchanged, each rank sending a run
  of rows to every rank (``all_to_all``), with even or given splits;

and the autograd regions of decision 4 in ``parallel/__init__.py``:

- :func:`copy_to_mesh`: the identity forward, the sum of the gradient over
  the ranks backward. A replicated input (a hyperparameter, ``x``, ``z``,
  ``y``, the noise) enters every rank-local computation through it, so
  its gradient is the sum of the ranks' shares, as JAX's autodiff through
  ``shard_map`` sums a replicated input's cotangent;
- :func:`reduce_from_mesh`: the sum over the ranks forward, the identity
  backward. Every sum over the ranks in a forward pass goes through it,
  so the replicated work after it, which every rank runs, hands each rank
  the whole cotangent once and no sum multiplies it;
- :func:`gather_from_mesh`: the ranks' blocks stacked forward (a
  replicated result), this rank's block of the cotangent backward;
- :func:`replicate_from_root` and :func:`root_gradient`: rank 0's value
  forward and the cotangent as it is backward, and the identity forward
  and rank 0's cotangent backward. Replicated work that every rank runs
  on its own hands its outputs through the first and reads its inputs
  through the second, so its results and their gradients hold rank 0's
  bits on every rank, however a rank's own arithmetic rounded.

The collectives themselves have no autograd kernel: they write into
buffers that autograd cannot see through, so a gradient would be cut or,
worse, silently wrong. Each raises when grad mode is on and its operand
requires a gradient. A differentiable route goes through the regions
above, or through a ``torch.autograd.Function`` whose forward runs the
collectives without a gradient and whose backward issues its own.

(``torch.distributed.nn.functional.all_reduce`` all-reduces in its
backward too, which with replicated work after it multiplies the
gradient by the group size.)

Each call records itself in ``utils/comm.py``'s recorder: its call site
(the first frame outside this module), kind, operand bytes and group size.

A gloo group takes CUDA tensors as they are: gloo stages them through the
host itself, and it has the CUDA form of every collective issued here
(all-gather, all-reduce, reduce, broadcast and all-to-all with even,
uneven and empty splits, checked with torch 2.11 on an H100), so no
collective is copied through host memory here.
"""

import os
import sys

import torch
import torch.distributed as dist

from ..utils import comm as _traffic

__all__ = [
    "MeshAxis",
    "all_gather_rows",
    "all_reduce",
    "reduce_to",
    "broadcast_from",
    "all_to_all_rows",
    "copy_to_mesh",
    "reduce_from_mesh",
    "gather_from_mesh",
    "replicate_from_root",
    "root_gradient",
]

_HERE = os.path.abspath(__file__)
_PKG_ROOT = os.path.dirname(os.path.dirname(_HERE))

# ``all_gather_single`` replaces ``all_gather_into_tensor`` (deprecated)
# from torch 2.13; older releases have only the latter.
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class MeshAxis:
    """One named dimension of a ``DeviceMesh``: its process group, its size
    and this rank's coordinate along it."""

    def __init__(self, mesh, axis):
        names = mesh.mesh_dim_names or ()
        if axis not in names:
            raise ValueError(f"the mesh has no dimension {axis!r} (its dimensions: {names})")
        self.mesh = mesh
        self.name = axis
        self.dim = names.index(axis)
        self.group = mesh.get_group(axis)
        self.size = mesh.size(self.dim)
        self.rank = mesh.get_local_rank(axis)

    def global_rank(self, rank):
        """The global rank of the group's ``rank``."""
        return dist.get_global_rank(self.group, rank)


def _site():
    f = sys._getframe(1)
    while f is not None and os.path.abspath(f.f_code.co_filename) == _HERE:
        f = f.f_back
    if f is None:
        return "?"
    path = os.path.abspath(f.f_code.co_filename)
    if path.startswith(_PKG_ROOT + os.sep):
        path = os.path.relpath(path, os.path.dirname(_PKG_ROOT))
    return f"{path}:{f.f_lineno} ({f.f_code.co_name})"


def _record(kind, nbytes, ax, site=None):
    _traffic.record(site or _site(), kind, nbytes, ax.size)


def _no_gradient(kind, t):
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError(
            f"{kind} has no autograd kernel, and its operand requires a gradient: the gradient "
            "would be cut or wrong. Route it through copy_to_mesh, reduce_from_mesh or "
            "gather_from_mesh, or run it inside a torch.autograd.Function.")


def all_gather_rows(t, ax):
    """The ranks' ``t`` (each of the same shape) stacked along dim 0 in rank
    order, on every rank."""
    _no_gradient("all-gather", t)
    t = t.contiguous()
    out = t.new_empty((ax.size * t.shape[0],) + tuple(t.shape[1:]))
    _record("all-gather", out.numel() * out.element_size(), ax)
    _all_gather_single(out, t, group=ax.group)
    return out


def _inplace(kind, t, ax, call, site=None):
    _no_gradient(kind, t)
    if not t.is_contiguous():
        raise ValueError(f"{kind} writes into its operand, which must be contiguous")
    _record(kind, t.numel() * t.element_size(), ax, site)
    call(t)
    return t


def all_reduce(t, ax, site=None):
    """The sum of the ranks' ``t``, on every rank, written into ``t``
    (contiguous) and returned. ``site`` names the call site in the
    recorder where the caller is not (a backward pass)."""
    return _inplace("all-reduce", t, ax, lambda b: dist.all_reduce(b, group=ax.group), site)


def reduce_to(t, dst, ax):
    """The sum of the ranks' ``t`` written into ``t`` on the group's rank
    ``dst`` (contiguous); on the other ranks ``t`` is left unspecified."""
    dst = ax.global_rank(dst)
    return _inplace("reduce", t, ax, lambda b: dist.reduce(b, dst, group=ax.group))


def broadcast_from(t, src, ax):
    """The group's rank ``src``'s ``t``, written into ``t`` (contiguous, of
    the same shape on every rank) and returned."""
    src = ax.global_rank(src)
    return _inplace("broadcast", t, ax, lambda b: dist.broadcast(b, src, group=ax.group))


def all_to_all_rows(t, ax, in_splits=None, out_splits=None):
    """Rows exchanged between the ranks: this rank sends its rows
    ``t[sum(in_splits[:p]) : sum(in_splits[:p + 1])]`` to rank ``p`` and
    receives ``out_splits[q]`` rows from rank ``q``, stacked in rank order.
    Without splits, ``t``'s rows go out in ``size`` equal runs."""
    _no_gradient("all-to-all", t)
    t = t.contiguous()
    rows = t.shape[0] if out_splits is None else sum(out_splits)
    out = t.new_empty((rows,) + tuple(t.shape[1:]))
    _record("all-to-all", t.numel() * t.element_size(), ax)
    kwargs = {}
    if in_splits is not None:
        kwargs = {"output_split_sizes": list(out_splits), "input_split_sizes": list(in_splits)}
    dist.all_to_all_single(out, t, group=ax.group, **kwargs)
    return out


class _CopyToMesh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax, site):
        ctx.ax, ctx.site = ax, site
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.ax, ctx.site), None, None


class _ReduceFromMesh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax, site):
        return all_reduce(t.contiguous().clone(), ax, site)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromMesh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax, ctx.n = ax, t.shape[0]
        return all_gather_rows(t, ax)

    @staticmethod
    def backward(ctx, g):
        n, r = ctx.n, ctx.ax.rank
        return g[r * n:(r + 1) * n], None


class _FromRoot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax):
        return broadcast_from(t.contiguous().clone(), 0, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RootGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax, site):
        ctx.ax, ctx.site = ax, site
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        return _inplace("broadcast", g, ctx.ax, lambda b: dist.broadcast(
            b, ctx.ax.global_rank(0), group=ctx.ax.group), ctx.site), None, None


def copy_to_mesh(t, ax):
    """``t`` (a replicated tensor) as the input of a rank-local computation:
    the identity, whose backward sums the gradient over the ranks. A tensor
    through which no gradient flows is returned as it is."""
    if not (torch.is_grad_enabled() and t.requires_grad):
        return t
    return _CopyToMesh.apply(t, ax, _site() + " (backward)")


def reduce_from_mesh(t, ax):
    """The sum of the ranks' ``t``, on every rank; the backward passes the
    gradient through unchanged."""
    return _ReduceFromMesh.apply(t, ax, _site())


def replicate_from_root(t, ax):
    """``t``, a result of replicated work that every rank computes on its
    own, as rank 0's on every rank (one broadcast); the backward passes
    each rank's cotangent on unchanged."""
    return _FromRoot.apply(t, ax)


def root_gradient(t, ax):
    """``t`` (a replicated input) as the input of replicated work that every
    rank runs on its own: the identity, whose backward hands every rank
    rank 0's gradient (one broadcast). A tensor through which no gradient
    flows is returned as it is."""
    if not (torch.is_grad_enabled() and t.requires_grad):
        return t
    return _RootGradient.apply(t, ax, _site() + " (backward)")


def gather_from_mesh(t, ax):
    """The ranks' ``t`` stacked along dim 0, on every rank, as a replicated
    result: the backward hands this rank its block of the cotangent, which
    every rank holds whole."""
    return _GatherFromMesh.apply(t, ax)


def routed(node):
    """Whether ``node`` is :func:`copy_to_mesh`'s backward node."""
    return isinstance(node, _CopyToMesh._backward_cls)
