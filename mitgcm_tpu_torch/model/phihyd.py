"""Hydrostatic pressure (mitgcm_tpu/model/phihyd.py:calc_phi_hyd), the
oceanic z-coordinate branch without r* or quasi-hydrostatic terms."""

from __future__ import annotations

import torch

from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.ops.stencil import shift as sh


def calc_phi_hyd(cfg: Config, grid: Grid, rhoInSitu: torch.Tensor):
    """Return (phiHydC, dPhiHydX, dPhiHydY, totPhiHyd).

    The buoyancy b' = g rho'/rhoConst is integrated down each column with
    the half-cell weights dRlocM/dRlocP (calc_phi_hyd.F integr_GeoPot=2):
    phiHydC(k) = sum_{m<k} (dRlocM+dRlocP)(m) b(m) + dRlocM(k) b(k)."""
    nr = cfg.nr
    buoy = cfg.gravity * rhoInSitu * (1.0 / cfg.rhoConst)
    drC, rF, rC = grid.drC, grid.rF, grid.rC
    dRlocM = 0.5 * drC[0:nr]
    dRlocM[0] = rF[0] - rC[0]
    dRlocP = 0.5 * drC[1:nr + 1]
    dRlocP[nr - 1] = rC[nr - 1] - rF[nr]
    incr = (dRlocM + dRlocP)[:, None, None] * buoy
    # cumsum - incr as the JAX code writes it (an exclusive scan would move
    # the last digits)
    phiF = torch.cumsum(incr, dim=0) - incr
    phiC = phiF + dRlocM[:, None, None] * buoy
    dX = grid.recip_dxC * (phiC - sh(phiC, di=-1))
    dY = grid.recip_dyC * (phiC - sh(phiC, dj=-1))
    return phiC, dX, dY, phiC
