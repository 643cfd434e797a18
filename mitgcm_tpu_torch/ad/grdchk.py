"""Gradient check: finite differences against the adjoint
(mitgcm_tpu/ad/grdchk.py; reference pkg/grdchk).

For each selected control element: perturb by +/-eps, rerun the forward
model, and compare the centred difference (fc+ - fc-)/(2 eps) with the
adjoint gradient component. The reference prints `1 - fd/adj`; O(1e-6)
with eps=1e-4 passes its ADM tests.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from mitgcm_tpu_torch.ad.adjoint import adjoint_gradient


def grdchk(objective: Callable, xx0, positions: Sequence[Tuple[int, ...]],
           eps: float = 1.0e-4) -> List[dict]:
    """One dict per checked position, under the JAX package's keys."""
    fc0, grad = adjoint_gradient(objective, xx0)
    results: List[dict] = []
    for pos in positions:
        e = torch.zeros_like(xx0)
        e[pos] = eps
        with torch.no_grad():
            fcp = objective(xx0 + e)
            fcm = objective(xx0 - e)
        fd = float((fcp - fcm) / (2.0 * eps))
        adj = float(grad[pos])
        results.append({
            "pos": pos,
            "fc_ref": float(fc0),
            "fc_plus": float(fcp),
            "fc_minus": float(fcm),
            "fd_grad": fd,
            "adj_grad": adj,
            "rel_err": 1.0 - fd / adj if adj != 0.0 else fd,
        })
    return results
