"""2-D block-cyclic distributed Cholesky over an ``r x c`` grid of ranks.

Counterpart of ``stheno_tpu/parallel/cholesky2d.py``. With ``nb = N / b``
tiles of ``b x b`` per side, global tile row ``I`` lives on grid row ``I
mod r`` at local tile index ``I // r``, and tile column ``J`` on grid column
``J mod c`` at ``J // c`` (:func:`~.cholesky.cyclic_index`). Each rank
holds one ``(N/r) x (N/c)`` tile set, spread over the whole matrix, so the
active trailing block stays balanced as the factorisation shrinks it. ``c``
must be a multiple of ``r``: then every panel tile a rank's columns need
lives on one grid row.

The panel loop (:func:`_cyclic_loop`) issues the JAX body's collectives,
one set per panel: the diagonal tile as a masked all-reduce over the row
axis, then over the column axis; the solved column panel as a masked
all-reduce over the column axis (``P_rows``, ``(N/r, b)``); the panel for
this rank's columns as a masked all-reduce over the row axis (``Q_full``),
then an affine re-index; one ``(N/r, b) x (b, N/c)`` trailing product.

The recursion above ``_REC_BASE`` works on the same tiles. A half of the
matrix whose tile count ``r`` and ``c`` divide is block-cyclic on its own:
its tiles are the first (or last) half of each rank's local tiles, so the
quarters are local slices and the join is a local concatenation, where the
JAX package reshards through GSPMD. The half-size products are a SUMMA
written by hand (:func:`_summa`: for each grid column ``p``, that column's
tile set broadcast along the row, and the matching tile rows of the right
factor broadcast along the column), and ``Y^T`` is a general
redistribution (:func:`_transpose`: two all-to-alls, along each axis once).
The triangular solve's base case is the 1-D blocked substitution
(``cholesky._dist_solve_lower_loop``) along the row axis on the rank's
cyclic rows, vectorised over the right-hand side's columns, which are
zero-padded to a multiple of ``c`` and dealt out in even blocks over the
column axis.

Layouts at the boundary: a 2-D sharded matrix is a ``DTensor`` placed
``Shard(0)`` on the row axis and ``Shard(1)`` on the column axis, in global
block order (the counterpart of ``P(axis_r, axis_c)``); a plain tensor is
taken as replicated. Entering and leaving the cyclic layout moves tiles
with one ``all_to_all_rows`` per axis (:func:`_retile`), outside the loop.
Gradients: the factor's is the Murray adjoint of ``cholesky._Factor``, and
:func:`dist_nlml_2d`'s the analytic ``Kbar = g (m K^{-1} - alpha alpha^T) /
2``, ``ybar = g alpha`` of ``exact._NLMLParts``, both on :class:`Grid`'s
operations, so the tiles of ``K^{-1}`` and ``alpha alpha^T`` are formed in
the cyclic layout. A replicated input enters through ``copy_to_mesh`` over
both axes, so its gradient is summed once over every rank, and the NLML's
sums go through ``reduce_from_mesh`` over both.
"""

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import config
from ..kernels import pairwise
from ..kernels.util import uprank
from ..matrix import dense
from ._comm import (
    MeshAxis,
    all_gather_rows,
    all_reduce,
    all_to_all_rows,
    broadcast_from,
    copy_to_mesh,
    reduce_from_mesh,
)
from .cholesky import _Factor, _chol_local, _dist_solve_lower_loop, cyclic_index
from .exact import _NLMLParts, _route, check_routed
from .hosts import device_type, init_single_rank

__all__ = [
    "dist_cholesky_2d",
    "dist_cholesky_2d_with_inv",
    "dist_nlml_2d",
    "make_grid_mesh",
]

#: Recursion threshold, as in the 1-D path.
_REC_BASE = 2048

_LOG_2_PI = math.log(2 * math.pi)


def make_grid_mesh(r, c, axis_r="rows", axis_c="cols"):
    """An ``r x c`` ``DeviceMesh`` with dimensions named ``axis_r`` and
    ``axis_c`` over the process group's first ``r * c`` ranks (a group of
    one rank, made first, if there is none). Every rank must call it."""
    if not dist.is_initialized():
        init_single_rank()
    world = dist.get_world_size()
    if not 1 <= r * c <= world:
        raise ValueError(f"a {r}x{c} grid needs {r * c} ranks; the process group has {world}.")
    return DeviceMesh(device_type(), torch.arange(r * c).reshape(r, c),
                      mesh_dim_names=(axis_r, axis_c))


# ---------------------------------------------------------------------------
# The grid and its tiles.


def _check_mesh(r, c):
    if c % r != 0:
        raise ValueError(
            f"dist_cholesky_2d needs the column axis to be a multiple of the row axis; "
            f"got {r}x{c}.")


def _loop_tile(N, r, c, block):
    """The panel loop's tile: ``min(block, N // c)``, halved until ``c``
    tiles of it divide N."""
    b = min(block, N // c)
    while b > 0 and N % (c * b) != 0:
        b //= 2
    if b == 0 or N % (r * b) != 0:
        raise ValueError(f"Cannot tile N={N} over a {r}x{c} mesh.")
    return b


def _halves(N, r, c, b):
    """Whether an N-row matrix in tiles of ``b`` halves into two
    block-cyclic halves (both axes' tile counts divide ``N / 2b``)."""
    h = N // 2
    return h % (r * b) == 0 and h % (c * b) == 0


def _tile(N, r, c, block):
    """The tile of the whole recursion: ``block`` where the top level
    halves (every level below then halves or loops at ``block``), else the
    panel loop's."""
    if N >= _REC_BASE and _halves(N, r, c, block):
        return block
    return _loop_tile(N, r, c, block)


class Grid:
    """The block-cyclic layout of an N x N matrix in tiles of ``b`` over a
    grid's row and column axes: the global ``rows`` and ``cols`` of this
    rank's local tiles, the local positions of the global diagonal
    (``diagonal``), and the layout's operations for
    ``cholesky.factor_adjoint`` and ``exact._NLMLParts`` (``factor``,
    ``T``, ``mm``, ``tmm``, ``outer``, ``solve``, ``eye``)."""

    def __init__(self, ax_r, ax_c, b, N, device):
        self.ax_r, self.ax_c, self.b, self.N = ax_r, ax_c, b, N
        r, c, pr, pc = ax_r.size, ax_c.size, ax_r.rank, ax_c.rank
        self.r, self.c = r, c
        self.rows = cyclic_index(N // r, b, r, pr, device)
        self.cols = cyclic_index(N // c, b, c, pc, device)
        # Global tile I is on this rank's diagonal when I = pr (mod r) and
        # I = pc (mod c), at local tile (I // r, I // c): every lcm(r, c)-th
        # tile from the first such. Formed on the device, with no host read.
        nb = N // b
        first = next((I for I in range(pc, nb, c) if I % r == pr), nb)
        tiles = torch.arange(first, nb, math.lcm(r, c), device=device)[:, None]
        within = torch.arange(b, device=device)
        self.diagonal = ((tiles // r * b + within).reshape(-1),
                         (tiles // c * b + within).reshape(-1))

    @property
    def mesh(self):
        return self.ax_r.mesh

    def factor(self, K, with_inv):
        return _chol2d(K, self, with_inv)

    def T(self, X):
        return _transpose(X, self)

    def mm(self, A, B):
        return _summa(A, B, self)

    def tmm(self, A, B):
        return _summa(_transpose(A, self), B, self)

    def outer(self, P, Q):
        return _outer(P, Q, self)

    def solve(self, L, B):
        return _solve2d(L, B, self)

    def eye(self, like):
        return _eye_tiles(like, self)


def _eye_tiles(like, g):
    """This rank's tiles of the identity of ``like``'s size (a tile set)."""
    nlr, nlc = like.shape
    rows = cyclic_index(nlr, g.b, g.r, g.ax_r.rank, like.device)
    cols = cyclic_index(nlc, g.b, g.c, g.ax_c.rank, like.device)
    return (rows[:, None] == cols[None, :]).to(like.dtype)


def grid(mesh, N, axis_r="rows", axis_c="cols", block=256, device=None):
    """The :class:`Grid` that :func:`dist_cholesky_2d` and
    :func:`dist_nlml_2d` use for an N x N matrix over ``mesh``: raises the
    JAX function's ``ValueError`` for a grid whose column axis is not a
    multiple of its row axis or an N that no tiling fits."""
    ax_r, ax_c = MeshAxis(mesh, axis_r), MeshAxis(mesh, axis_c)
    _check_mesh(ax_r.size, ax_c.size)
    b = _tile(N, ax_r.size, ax_c.size, block)
    return Grid(ax_r, ax_c, b, N, config.resolve_device(device))


# ---------------------------------------------------------------------------
# Tile movements.


def _block_tiles(n_tiles, size):
    per = n_tiles // size
    return lambda q: range(q * per, (q + 1) * per)


def _cyclic_tiles(n_tiles, size):
    return lambda q: range(q, n_tiles, size)


def _retile(t, ax, b, have, want):
    """Rows of ``t`` moved between two tilings (tiles of ``b`` rows) of the
    same rows over ``ax``'s ranks by one ``all_to_all_rows``: rank ``q``
    holds the global tiles ``have(q)`` before and ``want(q)`` after, each
    in increasing order. Returns this rank's rows of ``want``."""
    size, me = ax.size, ax.rank
    mine = list(have(me))
    owner = {T: q for q in range(size) for T in want(q)}
    order = sorted(range(len(mine)), key=lambda k: (owner[mine[k]], mine[k]))
    ins = [sum(owner[T] == q for T in mine) * b for q in range(size)]
    wanted = set(want(me))
    got = [sorted(T for T in have(q) if T in wanted) for q in range(size)]
    tiles = t.reshape((len(mine), b) + tuple(t.shape[1:]))
    send = tiles[torch.tensor(order, dtype=torch.long, device=t.device)].reshape(t.shape)
    recv = all_to_all_rows(send, ax, ins, [len(g) * b for g in got])
    arrived = [T for g in got for T in g]
    back = sorted(range(len(arrived)), key=lambda k: arrived[k])
    recv = recv.reshape((len(arrived), b) + tuple(t.shape[1:]))
    return recv[torch.tensor(back, dtype=torch.long, device=t.device)].reshape(
        (len(arrived) * b,) + tuple(t.shape[1:]))


def _retile_dim(t, ax, b, have, want, dim):
    if ax.size == 1:
        return t
    if dim == 0:
        return _retile(t, ax, b, have, want)
    return _retile(t.mT.contiguous(), ax, b, have, want).mT.contiguous()


class _Retile(torch.autograd.Function):
    """:func:`_retile` along ``dim``; the backward moves the cotangent's
    tiles back (a permutation's adjoint is its inverse)."""

    @staticmethod
    def forward(ctx, t, ax, b, have, want, dim):
        ctx.args = (ax, b, want, have, dim)
        return _retile_dim(t, ax, b, have, want, dim)

    @staticmethod
    def backward(ctx, g):
        return _retile_dim(g.contiguous(), *ctx.args), None, None, None, None, None


def _to_cyclic(t, g):
    """The cyclic tile set from this rank's block of the matrix (global
    block order over both axes); differentiable."""
    nb = g.N // g.b
    t = _Retile.apply(t, g.ax_r, g.b, _block_tiles(nb, g.r), _cyclic_tiles(nb, g.r), 0)
    return _Retile.apply(t, g.ax_c, g.b, _block_tiles(nb, g.c), _cyclic_tiles(nb, g.c), 1)


def _from_cyclic(t, g):
    """Inverse of :func:`_to_cyclic`."""
    nb = g.N // g.b
    t = _Retile.apply(t, g.ax_r, g.b, _cyclic_tiles(nb, g.r), _block_tiles(nb, g.r), 0)
    return _Retile.apply(t, g.ax_c, g.b, _cyclic_tiles(nb, g.c), _block_tiles(nb, g.c), 1)


def _placements(g, col=Shard(1)):
    out = [Replicate()] * g.mesh.ndim
    out[g.ax_r.dim], out[g.ax_c.dim] = Shard(0), col
    return out


def _copy_to_grid(t, g):
    """A replicated ``t`` as the input of this rank's tiles: its gradient is
    summed over the row axis and then over the column axis, once over
    every rank."""
    return copy_to_mesh(copy_to_mesh(t, g.ax_r), g.ax_c)


def cyclic_local(K, g):
    """This rank's cyclic tile set of ``K``: a DTensor placed ``Shard(0)``,
    ``Shard(1)`` on the grid's axes (relaid out), or a replicated tensor
    (indexed); differentiable."""
    if isinstance(K, DTensor):
        if K.device_mesh != g.mesh or list(K.placements) != _placements(g):
            raise ValueError(f"expected a DTensor placed {_placements(g)} on the mesh, got "
                             f"{K.placements}.")
        return _to_cyclic(K.to_local(), g)
    K = _copy_to_grid(K, g)
    return K[g.rows[:, None], g.cols[None, :]]


def _as_dtensor(local, g, shape, col=Shard(1)):
    stride = (shape[1], 1)
    return DTensor.from_local(local, g.mesh, _placements(g, col), shape=shape, stride=stride)


def _global(L, g):
    """The cyclic tile set ``L`` as a DTensor in global block order."""
    return _as_dtensor(_from_cyclic(L, g), g, (g.N, g.N))


# ---------------------------------------------------------------------------
# The panel loop.


def _cyclic_loop(A, g):
    """The block-cyclic panel loop on this rank's tile set ``A`` (``N/r x
    N/c``); returns its tiles of the lower factor."""
    r, c, b = g.r, g.c, g.b
    ax_r, ax_c = g.ax_r, g.ax_c
    pr, pc = ax_r.rank, ax_c.rank
    nlr, nlc = A.shape
    N = nlr * r
    s = c // r
    g_row = cyclic_index(nlr, b, r, pr, A.device)
    g_col = cyclic_index(nlc, b, c, pc, A.device)
    A = A.clone()
    src_r = pc % r
    d0 = (pc - src_r) // r
    for k in range(N // b):
        owner_r, owner_c = k % r, k % c
        kr, col0 = k // r * b, k // c * b
        # The diagonal tile: masked all-reduce over the rows, then the columns.
        if pr == owner_r and pc == owner_c:
            diag = A[kr:kr + b, col0:col0 + b].clone()
        else:
            diag = A.new_zeros((b, b))
        all_reduce(diag, ax_r)
        all_reduce(diag, ax_c)
        L_kk = _chol_local(diag)
        below = (g_row >= (k + 1) * b)[:, None]
        # The owning column solves its rows against L_kk and keeps them.
        if pc == owner_c:
            P = torch.linalg.solve_triangular(L_kk.mT, A[:, col0:col0 + b], upper=True,
                                              left=False)
            P_rows = torch.where(below, P, 0.0).contiguous()
            Lcol = P_rows.clone()
            if pr == owner_r:
                Lcol[kr:kr + b] = L_kk
            A[:, col0:col0 + b] = Lcol
        else:
            P_rows = A.new_zeros((nlr, b))
        # The pieces of this rank's rows from its sibling in the owning column.
        all_reduce(P_rows, ax_c)
        # The pieces of this rank's columns: tile J = j c + pc lives on grid
        # row src_r = pc mod r at its local tile j s + d0.
        Q_full = P_rows.clone() if pr == src_r else A.new_zeros((nlr, b))
        all_reduce(Q_full, ax_r)
        Q_cols = Q_full.reshape(nlr // (s * b), s, b, b)[:, d0].reshape(nlc, b)
        Q_cols = torch.where((g_col >= (k + 1) * b)[:, None], Q_cols, 0.0)
        torch.addmm(A, P_rows, Q_cols.mT, alpha=-1.0, out=A)
    return torch.where(g_col[None, :] <= g_row[:, None], A, 0.0)


# ---------------------------------------------------------------------------
# Products, transposes and solves on the tiles.


def _summa(A, B, g):
    """This rank's tiles of ``A @ B``: ``A`` a cyclic tile set (``P x Q``),
    ``B`` this rank's cyclic rows of a ``Q``-row matrix with any columns.
    For each grid column ``p``, that column's tile set of ``A`` goes along
    the grid row and ``B``'s tile rows ``= p (mod c)`` along the grid
    column, from grid row ``p mod r``."""
    r, c, b = g.r, g.c, g.b
    i, j = g.ax_r.rank, g.ax_c.rank
    s = c // r
    nk = A.shape[1] // b
    w = B.shape[1]
    out = A.new_zeros((A.shape[0], w))
    for p in range(c):
        Ap = A.contiguous() if j == p else A.new_empty(A.shape)
        if c > 1:
            broadcast_from(Ap, p, g.ax_c)
        if i == p % r:
            Bp = B.reshape(nk, s, b, w)[:, p // r].reshape(nk * b, w).contiguous()
        else:
            Bp = B.new_empty((nk * b, w))
        if r > 1:
            broadcast_from(Bp, p % r, g.ax_r)
        torch.addmm(out, Ap, Bp, out=out)
    return out


def _outer(P, Q, g):
    """This rank's tiles of ``P Q^T`` from its blocks of ``P`` and ``Q``
    (its cyclic rows, its column block of their columns, as :func:`_rhs`
    deals them): ``P``'s columns gathered over the column axis, and ``Q``'s
    rows at this rank's tile columns picked from all of ``Q``, gathered
    over both axes."""
    if g.c > 1:
        P, Q = (all_gather_rows(t.mT.contiguous(), g.ax_c).mT.contiguous() for t in (P, Q))
    every = all_gather_rows(Q, g.ax_r) if g.r > 1 else Q
    order = torch.cat([cyclic_index(g.N // g.r, g.b, g.r, q, Q.device) for q in range(g.r)])
    where = torch.empty_like(order)
    where[order] = torch.arange(g.N, device=Q.device)
    return P @ every[where[g.cols]].mT


def _transpose(Y, g):
    """This rank's tiles of ``Y^T`` from its tiles of ``Y`` (``P x Q``): tile
    ``(J, I)`` goes to rank ``(I mod r, J mod c)``. Along the rows, every
    rank sends its tile set to grid row ``pc mod r``; along the columns,
    those ranks send each tile row ``J`` to grid column ``J mod c``."""
    r, c, b = g.r, g.c, g.b
    i, j = g.ax_r.rank, g.ax_c.rank
    s = c // r
    nlr, nlc = Y.shape
    P = nlr * r
    band = j % r
    if r > 1:
        ins = [nlr if q == band else 0 for q in range(r)]
        outs = [nlr if i == band else 0] * r
        Y = all_to_all_rows(Y, g.ax_r, ins, outs)
    # On the band ranks: every tile row J of Y (source-major) by this rank's
    # tile columns; into global order, then grouped by J mod c.
    if i == band:
        Y = Y.reshape(r, nlr // b, b, nlc).transpose(0, 1).reshape(P, nlc)
        Y = Y.reshape(P // (c * b), c, b, nlc).transpose(0, 1).reshape(P, nlc)
    if c > 1:
        ins = [P // c if i == band else 0] * c
        outs = [P // c if q % r == i else 0 for q in range(c)]
        Y = all_to_all_rows(Y if i == band else Y[:0], g.ax_c, ins, outs)
    # The s pieces from grid columns i, i + r, ...: tile I = m c + (i + t r)
    # is local tile m s + t of Y^T.
    pieces = Y.reshape(s, P // c, nlc).transpose(1, 2)
    return pieces.reshape(s, nlc // b, b, P // c).transpose(0, 1).reshape(s * nlc, P // c)


def _solve2d(L, B, g):
    """``L^{-1} B``: ``L`` a cyclic tile set (lower-triangular), ``B`` this
    rank's cyclic rows with any columns. Halves above ``_REC_BASE`` (the
    off-diagonal product a SUMMA), else the 1-D substitution along the row
    axis on the rank's cyclic rows, with ``L``'s rows gathered over the
    column axis."""
    nlr, nlc = L.shape
    N = nlr * g.r
    if N > _REC_BASE and _halves(N, g.r, g.c, g.b):
        hr, hc = nlr // 2, nlc // 2
        X1 = _solve2d(L[:hr, :hc], B[:hr], g)
        X2 = _solve2d(L[hr:, hc:], B[hr:] - _summa(L[hr:, :hc], X1, g), g)
        return torch.cat([X1, X2])
    rows = L
    if g.c > 1:
        # Every rank's columns (rank-major), then into global order.
        rows = all_gather_rows(L.mT.contiguous(), g.ax_c)
        rows = rows.reshape(g.c, nlc // g.b, g.b, nlr).transpose(0, 1).reshape(N, nlr).mT
    return _dist_solve_lower_loop(rows, B, g.ax_r, None, tile=g.b)


def _chol2d(K, g, with_inv):
    """``(L, L^{-1} or None)`` of the cyclic tile set ``K``."""
    nlr, nlc = K.shape
    N = nlr * g.r
    if N < _REC_BASE or not _halves(N, g.r, g.c, g.b):
        L = _cyclic_loop(K, g)
        return L, _solve2d(L, _eye_tiles(L, g), g) if with_inv else None
    hr, hc = nlr // 2, nlc // 2
    L11, I11 = _chol2d(K[:hr, :hc], g, with_inv)
    Y = _solve2d(L11, K[:hr, hc:], g)
    L21 = _transpose(Y, g)
    L22, I22 = _chol2d(K[hr:, hc:] - _summa(L21, Y, g), g, with_inv)
    zeros = K.new_zeros((hr, nlc - hc))
    L = torch.cat([torch.cat([L11, zeros], 1), torch.cat([L21, L22], 1)])
    if not with_inv:
        return L, None
    M21 = -_summa(I22, _summa(L21, I11, g), g)
    return L, torch.cat([torch.cat([I11, zeros], 1), torch.cat([M21, I22], 1)])


# ---------------------------------------------------------------------------
# The public functions.


@config.pin_matmul_precision
def _dist_cholesky_2d_loop(K, mesh, axis_r="rows", axis_c="cols", block=256):
    """The block-cyclic panel loop alone (no recursion), at the loop's
    tile; ``K`` as :func:`dist_cholesky_2d` takes it."""
    ax_r, ax_c = MeshAxis(mesh, axis_r), MeshAxis(mesh, axis_c)
    N = K.shape[-1]
    g = Grid(ax_r, ax_c, _loop_tile(N, ax_r.size, ax_c.size, block), N, K.device)
    with torch.no_grad():
        return _global(_cyclic_loop(cyclic_local(K, g), g), g)


@config.pin_matmul_precision
def dist_cholesky_2d(K, mesh, axis_r="rows", axis_c="cols", block=256):
    """Lower Cholesky factor of SPD ``K`` over an ``r x c`` grid (``r | c``),
    as a DTensor placed ``Shard(0)``, ``Shard(1)`` on ``(axis_r, axis_c)``.
    ``K`` is such a DTensor or a replicated tensor. Differentiable.

    Divide-and-conquer on the block-cyclic tiles above ``_REC_BASE`` (the
    half-size solve and Schur complement a SUMMA over both axes), the
    block-cyclic loop below."""
    N = K.shape[-1]
    g = grid(mesh, N, axis_r, axis_c, block, K.device)
    return _global(_Factor.apply(cyclic_local(K, g), g, False), g)


@config.pin_matmul_precision
def dist_cholesky_2d_with_inv(K, mesh, axis_r="rows", axis_c="cols", block=256):
    """``(L, L^{-1})`` over the grid, both DTensors as
    :func:`dist_cholesky_2d` returns ``L``: the inverse rides the recursion
    as two SUMMA products per level (``inv([[L11, 0], [L21, L22]]) =
    [[I11, 0], [-I22 (L21 I11), I22]]``); at the base, ``L^{-1}`` solves
    ``L X = I``. The factor never reads it. Differentiable through both."""
    N = K.shape[-1]
    g = grid(mesh, N, axis_r, axis_c, block, K.device)
    L, Linv = _Factor.apply(cyclic_local(K, g), g, True)
    return _global(L, g), _global(Linv, g)


def _rhs(B, g):
    """This rank's rows (cyclic) and column block of ``B`` (replicated, 2-D)
    with its columns zero-padded to a multiple of ``c``; and the padded
    width."""
    M = B.shape[1]
    w = -(-M // g.c)
    if w * g.c != M:
        B = torch.cat([B, B.new_zeros((B.shape[0], w * g.c - M))], 1)
    j = g.ax_c.rank
    return _copy_to_grid(B, g)[g.rows, j * w:(j + 1) * w], w


@config.pin_matmul_precision
@torch.no_grad()
def _solve_lower_2d(L, B, mesh, axis_r="rows", axis_c="cols", block=256):
    """``L^{-1} B`` over the grid for a replicated or 2-D sharded ``L`` and a
    replicated ``B`` (N x M): the base case shards ``L``'s rows over the row
    axis and ``B``'s columns, zero-padded to a multiple of ``c``, over the
    column axis. Returns a DTensor placed ``Shard(0)`` on the row axis and
    ``Shard(1)`` on the column axis where ``c`` divides M, else replicated
    over the columns. An N that no tile fits replicates ``L`` (``B``'s
    columns sharded where ``c`` divides M) and returns that."""
    ax_r, ax_c = MeshAxis(mesh, axis_r), MeshAxis(mesh, axis_c)
    r, c = ax_r.size, ax_c.size
    N, M = L.shape[-1], B.shape[-1]
    try:
        g = Grid(ax_r, ax_c, _tile(N, r, c, block), N, L.device)
    except ValueError:
        L = L.full_tensor() if isinstance(L, DTensor) else L
        if M % c:
            return torch.linalg.solve_triangular(L, B, upper=False)
        w = M // c
        X = torch.linalg.solve_triangular(L, B[:, ax_c.rank * w:(ax_c.rank + 1) * w],
                                          upper=False)
        out = [Replicate()] * mesh.ndim
        out[ax_c.dim] = Shard(1)
        return DTensor.from_local(X, mesh, out, shape=(N, M), stride=(M, 1))
    X, w = _rhs(B, g)
    X = _solve2d(cyclic_local(L, g), X, g)
    nb = N // g.b
    X = _Retile.apply(X, ax_r, g.b, _cyclic_tiles(nb, r), _block_tiles(nb, r), 0)
    if w * c == M:
        return _as_dtensor(X, g, (N, M))
    X = all_gather_rows(X.mT.contiguous(), ax_c).mT[:, :M] if c > 1 else X[:, :M]
    return _as_dtensor(X.contiguous(), g, (N, M), col=Replicate())


def nlml_cyclic(K, y, g):
    """:func:`dist_nlml_2d` from this rank's tile set ``K`` of ``g``'s
    layout (``cyclic_local``, ``cyclic_gram``)."""
    y = config.as_tensor(y)
    y2 = y[:, None] if y.ndim == 1 else y
    y_local, _ = _rhs(y2, g)
    need = torch.is_grad_enabled() and (K.requires_grad or y_local.requires_grad)
    parts = _NLMLParts.apply(K, y_local, g, need)
    parts = reduce_from_mesh(reduce_from_mesh(parts, g.ax_r), g.ax_c)
    m = y2.shape[-1]
    return 0.5 * (m * parts[0] + parts[1] + m * g.N * _LOG_2_PI)


@config.pin_matmul_precision
def dist_nlml_2d(K, y, mesh, axis_r="rows", axis_c="cols", block=256):
    """Negative log marginal likelihood with ``K`` over a 2-D grid (a
    DTensor placed ``Shard(0)``, ``Shard(1)``, or a replicated tensor);
    differentiable in ``K`` and ``y`` through the analytic gradient ``Kbar
    = g (m K^{-1} - alpha alpha^T) / 2``, ``ybar = g alpha``. ``y``
    (replicated) is ``(N,)`` or ``(N, m)``: the sum of the ``m`` per-column
    NLMLs. A call through which no gradient flows computes no
    ``L^{-1}``."""
    g = grid(mesh, K.shape[-1], axis_r, axis_c, block, K.device)
    return nlml_cyclic(cyclic_local(K, g), y, g)


@config.pin_matmul_precision
def cyclic_gram(kernel, x, g, noise=None):
    """This rank's tile set of the Gram ``k(x, x) (+ noise I)`` in ``g``'s
    layout, by one Gram call on the rank's cyclic row and column points
    (K1 for a fused kernel; its backward under a gradient). ``kernel``,
    ``x`` and ``noise`` are replicated and enter through ``copy_to_mesh``
    over both axes."""
    x = uprank(config.as_tensor(x))
    k, x = _route(_route(kernel, g.ax_r), g.ax_c), _copy_to_grid(x, g)
    K = dense(pairwise(k, x[g.rows], x[g.cols]))
    if noise is not None:
        noise = _copy_to_grid(config.as_scalar(noise, K.dtype, K.device), g)
        K = K.index_put(g.diagonal, K[g.diagonal] + noise)
    if K.requires_grad:
        check_routed(K, "cyclic_gram")
    return K
