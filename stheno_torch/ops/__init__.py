"""Hand-written CUDA kernels with their plain torch versions, and the
Cholesky recursion built on them. Submodules: ``gram`` (K1),
``chol_tile`` (K2), ``gram_matvec`` (K3), ``chol``, ``trimul``."""
