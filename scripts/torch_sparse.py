"""The sparse path's float32 accuracy at N=10^6, M=512 on one GPU by the
chunk length of ``matrix/ops.py:_contract``, and its N=2000 host cost.

    python3 scripts/torch_sparse.py

Builds the kernels and makes ``bench_dist_elbo_1m``'s data
(``entry.sparse_1m_inputs``). For each chunk length (10^6, that is one
product; 8192; 2048, the port's; 512), with ``_contract``'s ``_CHUNK``
set to it: ``entry.sparse_elbo`` (value and gradient) and
``entry.sparse_predict`` in float32 under the adaptive jitter, against
the same calls in float64 with the float32 probe's inducing-Gram jitter
fixed, as ``chip_smoke.py``'s phase ``sparse_path`` holds them: the
ELBO's relative error, the gradient's (normwise, and log ell's), the
posterior mean's and variance's largest error over the largest float64
value, and the jitter that the adaptive probe picked for each
factorisation, in the order the calls made them (the ELBO's K_z and A;
the prediction's K_z, A and S = L_z A L_z^T). Then ``entry.sparse_elbo``
at N=2000, M=100, value and value+grad, under the adaptive jitter and
with the jitter fixed at the probe's choice (``chip_smoke.time_ms``). One
JSON line each, then the card's name and power limit.
"""

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402
from stheno_torch import config  # noqa: E402
from stheno_torch import entry as E  # noqa: E402
from stheno_torch.matrix import ops  # noqa: E402
from stheno_torch.ops import _build  # noqa: E402


def main():
    _build.library()
    probed = []
    probe = ops.adaptive_jitter_eps

    def spy(mat, base):
        eps = probe(mat, base)
        probed.append(float(eps))
        return eps

    ops.adaptive_jitter_eps = spy
    x, y, z, ell = E.sparse_1m_inputs()
    x_new = torch.linspace(0.0, 10.0, 4096, device="cuda")
    eps = E.sparse_jitter(z, ell)
    x64, y64, z64, e64, n64 = (t.double() for t in (x, y, z, ell, x_new))
    with config.matmul_precision_ctx():
        ref_v, ref_g = E.sparse_elbo(x64, y64, z64, e64, grad=True, jitter=eps)
        ref_m, ref_var = E.sparse_predict(x64, y64, z64, e64, n64, jitter=eps)
        del x64, y64, z64, e64, n64
        for chunk in (x.shape[0], 8192, 2048, 512):
            ops._CHUNK = chunk
            probed.clear()
            v, g = E.sparse_elbo(x, y, z, ell, grad=True)
            m, var = E.sparse_predict(x, y, z, ell, x_new)
            rels = c._sparse_grad_rels(g, ref_g)
            print(json.dumps({
                "chunk": chunk, "jitters": list(probed), "elbo_rel": c._rel(v, ref_v),
                "grad_rel": rels["whole"], "grad_log_ell_rel": rels["log_ell"],
                **c._sparse_pred_rels((m, var), (ref_m, ref_var)),
            }), flush=True)
        ops._CHUNK = 2048
        x, y, z, ell = E.vfe_n2000_inputs()
        eps = E.sparse_jitter(z, ell)
        print(json.dumps({
            "n2000_value_ms_adaptive": c.time_ms(lambda: E.sparse_elbo(x, y, z, ell)),
            "n2000_value_ms_fixed": c.time_ms(lambda: E.sparse_elbo(x, y, z, ell, jitter=eps)),
            "n2000_vg_ms_adaptive": c.time_ms(lambda: E.sparse_elbo(x, y, z, ell, grad=True)),
            "n2000_vg_ms_fixed": c.time_ms(
                lambda: E.sparse_elbo(x, y, z, ell, grad=True, jitter=eps)),
        }), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
