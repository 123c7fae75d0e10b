"""Distributed exact and sparse GP inference over ``torch.distributed``.

Counterpart of ``stheno_tpu/parallel``: the 1-D row-sharded distributed
Cholesky and triangular solve (``cholesky.py``), the sharded Gram, NLML
and posterior (``exact.py``), the sparse ELBO and posterior
(``sparse.py``), the 2-D block-cyclic Cholesky and NLML over a grid of
ranks (``cholesky2d.py``), the matrix-free NLML and matvec with row-sharded
matvecs (``iterative.py``), process groups and meshes (``hosts.py``), and
the collectives (``_comm.py``).

Design:

1. A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
   dimensions (``"data"``; ``("chain", "data")`` for the hybrid mesh;
   ``("rows", "cols")`` for the grid of :func:`make_grid_mesh`), the
   counterpart of ``jax.sharding.Mesh``. :func:`make_data_mesh` and
   :func:`make_grid_mesh` build one over the process group's ranks, first
   making a group of one rank (over a ``FileStore`` in a temporary
   directory: NCCL for a CUDA default device, gloo on the CPU) if there is
   none.
2. A row-sharded matrix is a ``DTensor`` placed ``Shard(0)`` on the axis
   (the counterpart of ``NamedSharding(mesh, P(axis, None))``); a matrix
   sharded over a grid is a ``DTensor`` placed ``Shard(0)`` on the row
   axis and ``Shard(1)`` on the column axis, in global block order
   (``P("rows", "cols")``). Public functions take and return such
   DTensors where the JAX functions take and return sharded arrays, while
   ``x``, ``y``, ``z``, ``x_new`` and the scalars are plain replicated
   tensors (a plain matrix is taken as replicated too). Inside, the bodies
   work on the ``.to_local()`` blocks and issue every collective by hand:
   no DTensor operator does the math, since DTensor's sharding propagation
   would redistribute silently. Ownership is even (``N % D == 0`` after the
   JAX functions' own padding). The 2-D path works on block-cyclic tiles
   (``cholesky2d.py``): each rank holds one ``(N/r) x (N/c)`` tile set, and
   a matrix enters and leaves that layout with one all-to-all per axis.
3. ``_comm.py`` is the one module that issues collectives, and each one is
   recorded in ``utils.comm.collective_traffic``. A collective raises when
   grad mode is on and its operand requires a gradient: it has no
   autograd kernel, so the gradient would be cut or wrong.
4. Gradients of replicated inputs: JAX's autodiff sums a replicated
   input's cotangent over the devices implicitly; here each replicated
   input enters every rank-local computation through ``copy_to_mesh``
   (whose backward all-reduces the gradient), and each sum over the ranks
   in a forward pass goes through ``reduce_from_mesh`` (whose backward is
   the identity). On a grid, both run over each axis once, so a gradient
   is summed over every rank exactly once. The replicated work after a
   reduction runs on every rank and its gradient is not summed, so every
   rank ends with the same, whole gradient. The loops run without a
   gradient inside ``torch.autograd.Function``s with analytic backwards:
   the factor's Murray adjoint, the solve's, the NLMLs'.
5. Memory: no rank holds an N x N array. Each holds O(N^2/D + N block) of
   every N x N quantity: the recursion's reshards are ``all_to_all``
   exchanges of row blocks, a product with a row-sharded matrix streams
   its row blocks, the NLML backward's rows of ``K^{-1} = L^{-T} L^{-1}``
   are reduced block by block, and ``alpha = L^{-T} L^{-1} y`` is one
   product per rank, summed. On a grid, a rank holds its tile set and
   ``(N/r, b)`` and ``(N/c, b)`` panels; the products are a SUMMA.
6. Several ranks on one GPU: NCCL refuses them, so they share a gloo group
   (gloo takes CUDA tensors); the compute stays on the GPU.
7. ``hosts.initialize_hosts`` wraps ``init_process_group`` with the JAX
   function's semantics (idempotent; an explicit cluster that fails
   raises; a single process with no cluster logs and returns).
"""

from .cholesky import dist_cholesky, dist_cholesky_with_inv, dist_solve_lower, make_data_mesh
from .cholesky2d import dist_cholesky_2d, dist_cholesky_2d_with_inv, dist_nlml_2d, make_grid_mesh
from .exact import dist_nlml, dist_posterior_predict, sharded_gram
from .hosts import initialize_hosts, make_hybrid_mesh
from .iterative import sharded_iterative_nlml, sharded_kernel_matvec
from .sparse import dist_elbo, dist_sparse_posterior

__all__ = [
    "dist_cholesky",
    "dist_cholesky_with_inv",
    "dist_cholesky_2d",
    "dist_cholesky_2d_with_inv",
    "dist_nlml_2d",
    "dist_solve_lower",
    "make_data_mesh",
    "make_grid_mesh",
    "dist_nlml",
    "dist_posterior_predict",
    "sharded_gram",
    "sharded_iterative_nlml",
    "sharded_kernel_matvec",
    "dist_elbo",
    "dist_sparse_posterior",
    "initialize_hosts",
    "make_hybrid_mesh",
]
