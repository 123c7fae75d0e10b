"""The float32 error of the N=10^6, M=512 VFE ELBO's gradient in ell on one
GPU, by ell: the single-device path (``entry.sparse_elbo``) beside the
distributed one on a mesh of one rank (``entry.dist_elbo_1m``, NCCL), and
the distributed one with its closed-form adjoint of ``log det A`` and
``c^T A^{-1} c`` replaced by autograd through the same operations.

    python3 scripts/torch_item12a.py [ell ...]

For each ``ell`` (default 0.9, 0.95, 1.0, 1.05, 1.1) on
``bench_dist_elbo_1m``'s data (``entry.sparse_1m_inputs``): the value and
``d ELBO / d ell`` in float32 under the adaptive jitter, against
``entry.sparse_elbo`` in float64 with the float32 probe's jitter fixed (as
``chip_smoke.py``'s phase ``item12a_path`` holds them), each as a relative
error: ``single``; ``dist``; ``dist_autograd_logdet_quad``
(``parallel/sparse.py:_LogdetQuad`` replaced by the factorisation, solve
and sums under autograd). One JSON line per ``ell``, then the card's name
and power limit.
"""

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stheno_torch import config  # noqa: E402
from stheno_torch import entry as E  # noqa: E402
from stheno_torch.ops import _build  # noqa: E402
from stheno_torch.parallel import make_data_mesh  # noqa: E402
from stheno_torch.parallel import sparse as S  # noqa: E402


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _logdet_quad_autograd(A, c):
    L = S._chol(A)
    w = S._solve_tri(L, c[:, None])
    return torch.stack([2.0 * torch.log(L.diagonal()).sum(), (w * w).sum()])


def _ablated(name, plain, call):
    """``call()`` with ``S.<name>.apply`` replaced by ``plain``."""
    fn = getattr(S, name)
    saved = fn.apply
    fn.apply = plain
    try:
        return call()
    finally:
        fn.apply = saved


def main(ells):
    _build.library()
    mesh = make_data_mesh()
    x, y, z, _ = E.sparse_1m_inputs()
    with config.matmul_precision_ctx():
        for ell in ells:
            e32 = torch.tensor(ell, device="cuda")
            eps = E.sparse_jitter(z, e32)
            rv, rg = E.sparse_elbo(x.double(), y.double(), z.double(), e32.double(), grad=True,
                                   jitter=eps)
            rg = rg["log_ell"] / ell
            sv, sg = E.sparse_elbo(x, y, z, e32, grad=True)
            out = {"ell": ell, "jitter": eps, "value_f64": float(rv), "grad_f64": float(rg),
                   "single_value_rel": _rel(sv, rv),
                   "single_grad_rel": _rel(sg["log_ell"] / ell, rg)}

            def dist():
                return E.dist_elbo_1m(mesh, e32, grad=True, inputs=(x, y, z, e32))

            for tag, call in (
                ("dist", dist),
                ("dist_autograd_logdet_quad",
                 lambda: _ablated("_LogdetQuad", _logdet_quad_autograd, dist)),
            ):
                dv, dg = call()
                out[f"{tag}_value_rel"], out[f"{tag}_grad_rel"] = _rel(dv, rv), _rel(dg, rg)
            print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main([float(a) for a in sys.argv[1:]] or [0.9, 0.95, 1.0, 1.05, 1.1])
