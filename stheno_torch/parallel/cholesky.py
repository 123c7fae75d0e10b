"""Distributed blocked Cholesky and triangular solve over the ranks of a
mesh axis.

Counterpart of ``stheno_tpu/parallel/cholesky.py``. The layout is row
block: rank ``d`` of ``D`` owns rows ``[d N/D, (d+1) N/D)`` of the N x N
matrix (``N % D == 0``), as a ``DTensor`` placed ``Shard(0)`` on the axis
(:func:`sharded`). The bodies work on each rank's ``(N/D, N)`` block and
issue every collective by hand through ``_comm.py``:

- the panel loop (:func:`_dist_cholesky_loop`, the recursion's base case)
  gathers each ``(N, block)`` column panel with one ``all_gather_rows``,
  factors its diagonal block (``torch.linalg.cholesky``, the JAX package's
  ``jnp.linalg.cholesky``, under ``config``'s jitter), triangular-solves
  the panel and applies the masked, full-width trailing update;
- the forward-substitution loop (:func:`_dist_solve_lower_loop`) sends the
  owner's diagonal block of ``L`` and block rows of the residual out with
  one ``broadcast_from`` per panel, where the JAX package psums the two
  masked blocks; only the owner's rows are nonzero there, so the result
  is the same;
- the recursions (:func:`dist_cholesky`, :func:`dist_cholesky_with_inv`,
  :func:`dist_solve_lower`) halve at and above ``_REC_BASE`` under the JAX
  package's conditions. Their reshards move row blocks with
  ``all_to_all_rows`` (:func:`_move_rows`, :func:`_transpose_rows`), and
  a product of a rank's rows with a row-sharded matrix streams that
  matrix's row blocks one at a time (:func:`_times_sharded`), so no rank
  gathers a whole block: each holds O(N^2/D + N block) of every N x N
  quantity.

The block size is clipped and halved as the JAX package does
(``min(block, N // D)``, halved until ``D * block`` divides N), so the
panel count, and with it the communicated bytes, are the same.

Gradients: the loops and recursions run without a gradient, inside two
``torch.autograd.Function``s with analytic backwards built on the same
distributed solves and products, so no rank holds an N x N array there
either. :class:`_Factor` (the factor, with or without its inverse) takes
the Murray adjoint ``Abar = sym(L^{-T} Phi(L^T Lbar) L^{-1})``, ``Phi`` the
lower triangle with the diagonal halved, as K2's backward does
(``ops/chol_tile.py``); :class:`_Solve` takes ``Bbar = L^{-T} Xbar`` and
``Lbar = -tril(Bbar X^T)`` (transposed for ``L^T X = B``). A layout's
operations (:class:`_Rows` here, the block-cyclic one in
``cholesky2d.py``) are all the adjoint needs. The Cholesky's derivative is
defined on symmetric directions, and the adjoint is the symmetric one; the
JAX package's loops concentrate theirs on the entries they read, which
agrees with it on every symmetric direction.
"""

import math

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import config
from ..matrix.ops import adaptive_jitter_eps
from ._comm import (
    MeshAxis,
    all_gather_rows,
    all_to_all_rows,
    broadcast_from,
    copy_to_mesh,
    gather_from_mesh,
    reduce_to,
)
from .hosts import device_type, init_single_rank

__all__ = [
    "dist_cholesky",
    "dist_cholesky_with_inv",
    "dist_solve_lower",
    "make_data_mesh",
]

#: Below this size the recursion hands over to the panel loop: one level of
#: halving only pays once the halves' products dominate the reshards.
_REC_BASE = 2048


def make_data_mesh(n_devices=None, axis="data"):
    """A 1-D ``DeviceMesh`` named ``axis`` over the ranks of the process
    group (or its first ``n_devices``). With no process group, it first
    makes a group of one rank (``hosts.init_single_rank``): NCCL when the
    default device is CUDA, gloo on the CPU. Every rank must call it."""
    if not torch.distributed.is_initialized():
        init_single_rank()
    world = torch.distributed.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices} but the process group has {world} ranks.")
    return DeviceMesh(device_type(), list(range(n)), mesh_dim_names=(axis,))


# ---------------------------------------------------------------------------
# Row-sharded tensors at the public boundary.


def sharded(local, ax, rows):
    """The DTensor of ``rows`` rows whose row block on this rank is
    ``local``: placed ``Shard(0)`` on ``ax``, replicated on the mesh's
    other dimensions."""
    placements = [Replicate()] * ax.mesh.ndim
    placements[ax.dim] = Shard(0)
    shape = (rows,) + tuple(local.shape[1:])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, ax.mesh, placements, shape=shape, stride=stride)


def local_rows(t, ax):
    """This rank's row block of ``t``: a DTensor placed ``Shard(0)`` on
    ``ax`` (and replicated elsewhere) gives its local block; a plain tensor
    is taken as replicated, enters through ``copy_to_mesh`` (its gradient
    is summed over the ranks) and gives rows ``[r N/D, (r+1) N/D)``. The
    rows must divide evenly: ``torch.chunk``'s uneven split never decides
    which rank owns a row."""
    rows = t.shape[0]
    if rows % ax.size:
        raise ValueError(f"Cannot tile {rows} rows evenly over {ax.size} ranks.")
    n = rows // ax.size
    if isinstance(t, DTensor):
        want = [Replicate()] * ax.mesh.ndim
        want[ax.dim] = Shard(0)
        if t.device_mesh != ax.mesh or list(t.placements) != want:
            raise ValueError(f"expected a DTensor placed {want} on the mesh, got {t.placements}.")
        return t.to_local()
    return copy_to_mesh(t, ax)[ax.rank * n:(ax.rank + 1) * n]


# ---------------------------------------------------------------------------
# Row movements between even layouts.


def _overlap(a0, a1, b0, b1):
    return max(0, min(a1, b1) - max(a0, b0))


def _move_rows(local, ax, src, dst):
    """Rows moved from one even layout to another. ``src = (start, count)``:
    rank ``q`` holds rows ``start + [q c/D, (q+1) c/D)`` as ``local``;
    ``dst`` likewise. Returns this rank's rows of ``dst`` that lie in
    ``src``'s range, in order, after one ``all_to_all_rows``."""
    D, r = ax.size, ax.rank
    (s0, sc), (d0, dc) = src, dst
    sn, dn = sc // D, dc // D

    def split(q, p):
        return _overlap(s0 + q * sn, s0 + (q + 1) * sn, d0 + p * dn, d0 + (p + 1) * dn)

    ins = [split(r, p) for p in range(D)]
    outs = [split(q, r) for q in range(D)]
    first = max(s0 + r * sn, d0) - (s0 + r * sn)
    send = local[first:first + sum(ins)] if sum(ins) else local[:0]
    return all_to_all_rows(send, ax, ins, outs)


def _join_rows(parts, ax, rows):
    """The even layout of ``rows`` rows from ``parts``, ``(local, start,
    count)`` each in its own even layout, which tile ``[0, rows)`` in
    order."""
    return torch.cat([_move_rows(p, ax, (s, c), (0, rows)) for p, s, c in parts])


def _transpose_rows(Y, ax, reverse=False):
    """The row block of ``Y^T`` (with ``reverse``: of ``J Y^T J``, ``J`` the
    reversal) from ``Y``'s row block, by one even ``all_to_all_rows``: rank
    ``s`` receives every rank's columns of block ``s`` (``D - 1 - s``)."""
    D = ax.size
    ra, c = Y.shape
    blocks = Y.reshape(ra, D, c // D)
    if reverse:
        blocks = blocks.flip(1)
    got = all_to_all_rows(blocks.transpose(0, 1).reshape(D * ra, c // D), ax)
    if reverse:
        got = got.flip(0).flip(1)
    return got.mT.contiguous()


def _reverse_rows(B, ax):
    """The row block of ``J B`` (the rows reversed) from ``B``'s."""
    D, r, n = ax.size, ax.rank, B.shape[0]
    splits = [n if p == D - 1 - r else 0 for p in range(D)]
    return all_to_all_rows(B, ax, splits, splits).flip(0)


def _times_sharded(A, X, ax):
    """``A @ X`` for ``A`` this rank's rows of a matrix whose columns are
    ``X``'s rows, ``X`` row-sharded: ``X``'s row blocks go out one at a time
    (``broadcast_from``), so no rank holds all of ``X``."""
    kx = X.shape[0]
    out = None
    for q in range(ax.size):
        Xq = X.contiguous() if q == ax.rank else X.new_empty(X.shape)
        broadcast_from(Xq, q, ax)
        part = A[:, q * kx:(q + 1) * kx] @ Xq
        out = part if out is None else out.add_(part)
    return out


def _tmm_rows(A, B, ax):
    """This rank's rows of ``A^T B`` from the row blocks of ``A`` and ``B``:
    for each row block ``s``, every rank forms ``A[:, cols_s]^T B``, and the
    partials are reduced to rank ``s``."""
    n = A.shape[1] // ax.size
    mine = None
    for s in range(ax.size):
        part = A[:, s * n:(s + 1) * n].mT @ B
        reduce_to(part, s, ax)
        if s == ax.rank:
            mine = part
    return mine


def _eye_rows(n, N, row0, like):
    """Rows ``[row0, row0 + n)`` of the N x N identity."""
    out = like.new_zeros((n, N))
    out.diagonal(row0).fill_(1.0)
    return out


# ---------------------------------------------------------------------------
# The panel loops.


def _chol_local(block_mat):
    """Panel-diagonal Cholesky under the dense path's jitter policy: fixed
    ``config.jitter``, or the escalating probe under
    ``config.set_adaptive_jitter(True)``. A factorisation that fails gives
    NaN, as ``jnp.linalg.cholesky`` does, and reads nothing back to the
    host (``torch.linalg.cholesky`` would, to raise, once per panel)."""
    eps = config.jitter(block_mat.dtype)
    if config.adaptive_jitter:
        eps = adaptive_jitter_eps(block_mat, eps)
    b = block_mat.shape[-1]
    eye = torch.eye(b, dtype=block_mat.dtype, device=block_mat.device)
    L, info = torch.linalg.cholesky_ex(block_mat + eps * eye)
    return L.masked_fill(info != 0, float("nan"))


def _panel_block(N, D, block):
    """``min(block, N // D)``, halved until ``D * block`` divides N (which
    also gives the JAX loop's second condition, ``b`` dividing N)."""
    b = min(block, N // D)
    while b > 0 and N % (D * b) != 0:
        b //= 2
    if b == 0:
        raise ValueError(f"Cannot tile N={N} over {D} devices.")
    return b


def _dist_cholesky_loop(K, ax, block):
    """The right-looking panel loop: ``K`` this rank's ``(N/D, N)`` rows;
    returns its rows of the lower factor."""
    n, N = K.shape
    block = _panel_block(N, ax.size, block)
    row0 = ax.rank * n
    rows = torch.arange(N, device=K.device)[:, None]
    A = K.clone()
    for c0 in range(0, N, block):
        c1 = c0 + block
        panel = all_gather_rows(A[:, c0:c1], ax)  # (N, block)
        L_jj = _chol_local(panel[c0:c1])
        # P = panel L_jj^{-T}, every row.
        P = torch.linalg.solve_triangular(L_jj.mT, panel, upper=True, left=False)
        P_below = torch.where(rows >= c1, P, 0.0)
        Lcol = P_below.clone()
        Lcol[c0:c1] = L_jj
        A[:, c0:c1] = Lcol[row0:row0 + n]
        # The masked trailing update: only rows and columns >= c1 change.
        A -= P_below[row0:row0 + n] @ P_below.mT
    return torch.tril(A, diagonal=row0)


def cyclic_index(n, tile, size, rank, device):
    """The global indices of a rank's ``n`` rows when rows are dealt out in
    tiles of ``tile`` rows over ``size`` ranks cyclically: local tile ``m``
    is global tile ``m * size + rank``."""
    li = torch.arange(n, device=device)
    return (li // tile * size + rank) * tile + li % tile


def _dist_solve_lower_loop(L, B, ax, block, tile=None):
    """Blocked forward substitution of ``L X = B``: ``L`` this rank's
    ``(n, N)`` rows of a lower-triangular matrix, ``B`` its ``(n, M)`` rows.
    Each panel's owner sends its diagonal block of ``L`` and its block rows
    of the residual out in one ``broadcast_from``. The rows are this rank's
    row block, or with ``tile`` its rows dealt out cyclically in tiles of
    ``tile`` rows (:func:`cyclic_index`; the panels are the tiles)."""
    n, N = L.shape
    D = ax.size
    if tile is None:
        block = _panel_block(N, D, block)
        grows = torch.arange(ax.rank * n, (ax.rank + 1) * n, device=L.device)[:, None]
    else:
        block = tile
        grows = cyclic_index(n, tile, D, ax.rank, L.device)[:, None]
    X = torch.zeros_like(B)
    R = B.clone()
    for c0 in range(0, N, block):
        c1 = c0 + block
        if tile is None:
            owner, off = divmod(c0, n)
        else:
            owner, off = c0 // tile % D, c0 // tile // D * tile
        if ax.rank == owner:
            buf = torch.cat([L[off:off + block, c0:c1], R[off:off + block]], dim=1)
        else:
            buf = B.new_empty((block, block + B.shape[1]))
        broadcast_from(buf, owner, ax)
        X_j = torch.linalg.solve_triangular(buf[:, :block], buf[:, block:], upper=False)
        if ax.rank == owner:
            X[off:off + block] = X_j
        R -= torch.where(grows >= c1, L[:, c0:c1] @ X_j, 0.0)
    return X


# ---------------------------------------------------------------------------
# The recursions, on row blocks.


def _recurse(N, D):
    h = N // 2
    return N >= _REC_BASE and h % D == 0 and h % 2 == 0


def _quarters(K, ax):
    """``K[:h, :h]``, ``K[:h, h:]`` and ``K[h:, h:]`` each spread evenly over
    the ranks, from ``K``'s row block."""
    N = K.shape[1]
    h = N // 2
    return (_move_rows(K[:, :h], ax, (0, N), (0, h)),
            _move_rows(K[:, h:], ax, (0, N), (0, h)),
            _move_rows(K[:, h:], ax, (0, N), (h, N - h)))


def _join_lower(T11, T21, T22, ax):
    """The row block of ``[[T11, 0], [T21, T22]]`` from the quarters' row
    blocks."""
    h, N = T11.shape[1], T11.shape[1] + T22.shape[1]
    top = _move_rows(T11, ax, (0, h), (0, N))
    top = torch.cat([top, top.new_zeros((top.shape[0], N - h))], dim=1)
    bot = _move_rows(torch.cat([T21, T22], dim=1), ax, (h, N - h), (0, N))
    return torch.cat([top, bot])


def _cholesky(K, ax, block):
    N = K.shape[1]
    if not _recurse(N, ax.size):
        return _dist_cholesky_loop(K, ax, block)
    A11, A12, A22 = _quarters(K, ax)
    L11 = _cholesky(A11, ax, block)
    # L21 = A21 L11^{-T}: solve L11 Y = A12, then L21 = Y^T.
    Y = _solve_lower(L11, A12, ax, block)
    L21 = _transpose_rows(Y, ax)
    L22 = _cholesky(A22 - _times_sharded(L21, Y, ax), ax, block)
    return _join_lower(L11, L21, L22, ax)


def _cholesky_with_inv(K, ax, block):
    n, N = K.shape
    if not _recurse(N, ax.size):
        L = _dist_cholesky_loop(K, ax, block)
        return L, _solve_lower(L, _eye_rows(n, N, ax.rank * n, K), ax, block)
    A11, A12, A22 = _quarters(K, ax)
    L11, I11 = _cholesky_with_inv(A11, ax, block)
    Y = _solve_lower(L11, A12, ax, block)
    L21 = _transpose_rows(Y, ax)
    L22, I22 = _cholesky_with_inv(A22 - _times_sharded(L21, Y, ax), ax, block)
    M21 = -_times_sharded(I22, _times_sharded(L21, I11, ax), ax)
    return _join_lower(L11, L21, L22, ax), _join_lower(I11, M21, I22, ax)


def _solve_lower(L, B, ax, block):
    N = L.shape[1]
    if not _recurse(N, ax.size):
        return _dist_solve_lower_loop(L, B, ax, block)
    h = N // 2
    L11 = _move_rows(L[:, :h], ax, (0, N), (0, h))
    L21 = _move_rows(L[:, :h], ax, (0, N), (h, N - h))
    L22 = _move_rows(L[:, h:], ax, (0, N), (h, N - h))
    X1 = _solve_lower(L11, _move_rows(B, ax, (0, N), (0, h)), ax, block)
    R2 = _move_rows(B, ax, (0, N), (h, N - h)) - _times_sharded(L21, X1, ax)
    X2 = _solve_lower(L22, R2, ax, block)
    return _join_rows([(X1, 0, h), (X2, h, N - h)], ax, N)


def _solve_upper(L, b, ax, block):
    """Solve ``L^T x = b`` with the lower solver on the reversed system:
    ``(L^T)^{-1} = J (J L^T J)^{-1} J``, ``J`` the reversal, and ``J L^T
    J`` is lower-triangular. Row blocks in, row blocks out."""
    xr = _solve_lower(_transpose_rows(L, ax, reverse=True), _reverse_rows(b, ax), ax, block)
    return _reverse_rows(xr, ax)


def _outer_rows(P, Q, ax):
    """This rank's rows of ``P Q^T`` from the row blocks of ``P`` and ``Q``:
    ``Q``'s row blocks go out one at a time (``broadcast_from``), each
    giving one column block."""
    kq = Q.shape[0]
    out = P.new_empty((P.shape[0], ax.size * kq))
    for q in range(ax.size):
        Qq = Q.contiguous() if q == ax.rank else Q.new_empty(Q.shape)
        broadcast_from(Qq, q, ax)
        out[:, q * kq:(q + 1) * kq] = P @ Qq.mT
    return out


# ---------------------------------------------------------------------------
# Gradients.


def lower(X, rows, cols, diag=1.0):
    """``X``'s entries on and below the global diagonal, the diagonal ones
    times ``diag``; ``rows`` and ``cols`` are the global indices of ``X``'s
    local rows and columns."""
    r, c = rows[:, None], cols[None, :]
    X = torch.where(r >= c, X, 0.0)
    return X if diag == 1.0 else torch.where(r == c, diag * X, X)


class _Rows:
    """The row-block layout's operations on local blocks, for
    :func:`factor_adjoint` and ``exact._NLMLParts``: ``factor``, ``T`` (the
    transpose), ``mm`` (a product), ``tmm`` (``A^T B``), ``outer`` (``P
    Q^T`` of two right-hand sides), ``solve`` (``L^{-1} B``), ``eye`` (the
    identity); the global ``rows`` and ``cols`` of a local block and the
    local positions of the global diagonal (``diagonal``)."""

    def __init__(self, ax, block, n, N, device):
        self.ax, self.block, self.n, self.N = ax, block, n, N
        self.rows = torch.arange(ax.rank * n, (ax.rank + 1) * n, device=device)
        self.cols = torch.arange(N, device=device)
        self.diagonal = (torch.arange(n, device=device), self.rows)

    def factor(self, K, with_inv):
        if with_inv:
            return _cholesky_with_inv(K, self.ax, self.block)
        return _cholesky(K, self.ax, self.block), None

    def T(self, X):
        return _transpose_rows(X, self.ax)

    def mm(self, A, X):
        return _times_sharded(A, X, self.ax)

    def tmm(self, A, B):
        return _tmm_rows(A, B, self.ax)

    def outer(self, P, Q):
        return _outer_rows(P, Q, self.ax)

    def solve(self, L, B):
        return _solve_lower(L, B, self.ax, self.block)

    def eye(self, like):
        return _eye_rows(self.n, self.N, self.ax.rank * self.n, like)


def factor_adjoint(ops, L, Linv, Lbar, Linvbar):
    """The cotangent of ``A`` for ``L = chol(A)`` (and ``Linv = L^{-1}``)
    from those of ``L`` and ``Linv`` (either may be None), on ``ops``'s
    layout: ``Lbar <- tril(Lbar) - tril(Linv^T tril(Linvbar) Linv^T)``, then
    ``S = Linv^T Phi(L^T Lbar) Linv`` and ``Abar = (S + S^T) / 2``."""
    rows, cols = ops.rows, ops.cols
    if Linv is None:
        Linv = ops.solve(L, ops.eye(L))
    LinvT = ops.T(Linv)
    Lbar = torch.zeros_like(L) if Lbar is None else lower(Lbar, rows, cols)
    if Linvbar is not None:
        extra = ops.mm(ops.mm(LinvT, lower(Linvbar, rows, cols)), LinvT)
        Lbar = Lbar - lower(extra, rows, cols)
    C = lower(ops.mm(ops.T(L), Lbar), rows, cols, diag=0.5)
    S = ops.mm(LinvT, ops.mm(C, Linv))
    return 0.5 * (S + ops.T(S))


class _Factor(torch.autograd.Function):
    """``L`` (or ``(L, L^{-1})`` with ``with_inv``) of the local block
    ``K`` on ``ops``'s layout, with :func:`factor_adjoint` as its
    backward."""

    @staticmethod
    def forward(ctx, K, ops, with_inv):
        ctx.set_materialize_grads(False)
        L, Linv = ops.factor(K, with_inv)
        ctx.ops = ops
        ctx.save_for_backward(L, Linv)
        return (L, Linv) if with_inv else L

    @staticmethod
    @config.pin_matmul_precision
    def backward(ctx, Lbar, Linvbar=None):
        L, Linv = ctx.saved_tensors
        return factor_adjoint(ctx.ops, L, Linv, Lbar, Linvbar), None, None


class _Solve(torch.autograd.Function):
    """``L^{-1} B`` (``L^{-T} B`` with ``trans``) on row blocks. Backward:
    ``Bbar = L^{-T} Xbar`` and ``Lbar = -tril(Bbar X^T)`` (``L^{-1} Xbar``
    and ``-tril(X Bbar^T)`` with ``trans``)."""

    @staticmethod
    def forward(ctx, L, B, ax, block, trans):
        X = (_solve_upper if trans else _solve_lower)(L, B, ax, block)
        ctx.ax, ctx.block, ctx.trans = ax, block, trans
        ctx.save_for_backward(L, X)
        return X

    @staticmethod
    @config.pin_matmul_precision
    def backward(ctx, Xbar):
        L, X = ctx.saved_tensors
        ax, block, trans = ctx.ax, ctx.block, ctx.trans
        Bbar = (_solve_lower if trans else _solve_upper)(L, Xbar.contiguous(), ax, block)
        Lbar = None
        if ctx.needs_input_grad[0]:
            n, N = L.shape
            P = _outer_rows(X, Bbar, ax) if trans else _outer_rows(Bbar, X, ax)
            rows = torch.arange(ax.rank * n, (ax.rank + 1) * n, device=L.device)
            Lbar = -lower(P, rows, torch.arange(N, device=L.device))
        return Lbar, Bbar, None, None, None


def solve_rows(L, B, ax, block, trans=False):
    """``L^{-1} B`` (``L^{-T} B`` with ``trans``) for this rank's row blocks
    ``L`` and ``B``, differentiable in both."""
    return _Solve.apply(L, B, ax, block, trans)


def factor_rows(K, ax, block, with_inv=False):
    """``L`` (with ``with_inv``, ``(L, L^{-1})``) for this rank's row block
    ``K``, differentiable."""
    n, N = K.shape
    return _Factor.apply(K, _Rows(ax, block, n, N, K.device), with_inv)


# ---------------------------------------------------------------------------
# The public functions.


def _padded_rows(K, ax, block):
    """This rank's rows of ``[[K, 0], [0, I]]``, padded to a multiple of
    ``D * block`` (``K`` replicated)."""
    N = K.shape[-1]
    tile = ax.size * block
    N_pad = -(-N // tile) * tile
    n = N_pad // ax.size
    row0 = ax.rank * n
    out = _eye_rows(n, N_pad, row0, K)
    # Every rank copies its rows of K, none on a rank past N, so that every
    # rank's block depends on K and runs the backward's collectives.
    hi = max(min(N, row0 + n), row0)
    out[:hi - row0, :N] = copy_to_mesh(K, ax)[row0:hi]
    return out


@config.pin_matmul_precision
def dist_cholesky(K, mesh, axis="data", block=256):
    """Lower Cholesky factor of ``K``, a row-sharded DTensor (or a
    replicated tensor), as a row-sharded DTensor; differentiable
    (:class:`_Factor`).

    Divide-and-conquer (factor the leading half, panel-solve the lower
    left against it, Schur-update, recurse) above ``_REC_BASE``, the panel
    loop below. An ``N`` that no ``D * b`` tiles (``N % D != 0``) is padded
    with an identity block, ``chol([[K, 0], [0, I]]) = [[L, 0], [0, I]]``,
    as the JAX package pads; ``K`` must then be a replicated tensor (a
    DTensor's rows would divide unevenly) and the factor comes back
    replicated, gathered from the padded factor's rows."""
    ax = MeshAxis(mesh, axis)
    N = K.shape[-1]
    if N % ax.size:
        if isinstance(K, DTensor):
            raise ValueError(f"N={N} rows do not divide evenly over {ax.size} ranks.")
        L_pad = factor_rows(_padded_rows(K, ax, block), ax, block)
        return gather_from_mesh(L_pad, ax)[:N, :N]
    return sharded(factor_rows(local_rows(K, ax), ax, block), ax, N)


@config.pin_matmul_precision
def dist_cholesky_with_inv(K, mesh, axis="data", block=256):
    """Lower Cholesky factor of ``K`` (a row-sharded DTensor or a
    replicated tensor) and its inverse ``L^{-1}``, both row-sharded
    DTensors; differentiable in ``K`` through both.

    The inverse rides the same recursion: ``inv([[L11, 0], [L21, L22]]) =
    [[I11, 0], [-I22 (L21 I11), I22]]``, two products per level; at the
    base, ``L^{-1}`` solves ``L X = I``. The factor never reads the
    inverse, and ``dist_nlml``'s value-only call skips this function."""
    ax = MeshAxis(mesh, axis)
    L, Linv = factor_rows(local_rows(K, ax), ax, block, with_inv=True)
    N = K.shape[-1]
    return sharded(L, ax, N), sharded(Linv, ax, N)


@config.pin_matmul_precision
def dist_solve_lower(L, B, mesh, axis="data", block=256):
    """Solve ``L X = B`` with ``L`` lower-triangular, both row-sharded
    DTensors (or replicated tensors); returns ``X`` row-sharded,
    differentiable in both (:class:`_Solve`).

    Divide-and-conquer: ``X1 = L11^{-1} B1``, ``X2 = L22^{-1} (B2 - L21
    X1)``, the product streaming ``X1``'s row blocks; the loop is the base
    case below ``_REC_BASE``."""
    ax = MeshAxis(mesh, axis)
    X = solve_rows(local_rows(L, ax), local_rows(B, ax), ax, block)
    return sharded(X, ax, L.shape[-1])
