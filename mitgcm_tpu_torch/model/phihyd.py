"""Hydrostatic pressure (mitgcm_tpu/model/phihyd.py:calc_phi_hyd), the
oceanic z-coordinate branch without r* or quasi-hydrostatic terms.

`calc_phi_hyd` runs kernel D (kernels/csrc/phihyd.cu) on CUDA tensors and
its plain PyTorch twin `_phi_hyd_plain` on CPU tensors or with
impl="plain"; on the card its gradient is kernel D' (phihyd_adj.cu), whose
plain version is `phihyd_vjp_plain`, elsewhere autograd through the
twin."""

from __future__ import annotations

import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.ops.stencil import shift as sh

# calls of kernel D's twin, for the card's runs to show that the main path
# never ran it
plain_calls = 0


def _weights(cfg: Config, grid: Grid):
    """(dRlocM, dRlocP) [nr]: the half-cell weights of the running sum."""
    nr = cfg.nr
    drC, rF, rC = grid.drC, grid.rF, grid.rC
    dRlocM = 0.5 * drC[0:nr]
    dRlocM[0] = rF[0] - rC[0]
    dRlocP = 0.5 * drC[1:nr + 1]
    dRlocP[nr - 1] = rC[nr - 1] - rF[nr]
    return dRlocM, dRlocP


def _phi_hyd_plain(cfg: Config, grid: Grid, rhoInSitu: torch.Tensor):
    """Kernel D's twin: (phiHydC, dPhiHydX, dPhiHydY). The running sum
    adds level by level in k order, as kernel D does (JAX's cumsum - incr
    form, phihyd.py:225-227)."""
    nr = cfg.nr
    buoy = cfg.gravity * rhoInSitu * (1.0 / cfg.rhoConst)
    dRlocM, dRlocP = _weights(cfg, grid)
    incr = (dRlocM + dRlocP)[:, None, None] * buoy
    acc = torch.zeros_like(incr[0])
    phiF = []
    for k in range(nr):
        acc = acc + incr[k]
        phiF.append(acc - incr[k])
    phiC = torch.stack(phiF) + dRlocM[:, None, None] * buoy
    dX = grid.recip_dxC * (phiC - sh(phiC, di=-1))
    dY = grid.recip_dyC * (phiC - sh(phiC, dj=-1))
    return phiC, dX, dY


def _phi_hyd_kernel(cfg: Config, grid: Grid, rhoInSitu: torch.Tensor):
    """Kernel D on the card: (phiHydC, dPhiHydX, dPhiHydY)."""
    nr, nyp, nxp = cfg.nr, *rhoInSitu.shape[1:]
    dtype = rhoInSitu.dtype
    outs = tuple(torch.empty_like(rhoInSitu) for _ in range(3))
    kernels.check_fields(dtype, (nr, nyp, nxp), rho=rhoInSitu,
                         **dict(zip(("phiHydC", "dPhiHydX", "dPhiHydY"),
                                    outs)))
    kernels.check_fields(dtype, (nr + 1,), drC=grid.drC, rF=grid.rF)
    kernels.check_fields(dtype, (nr,), rC=grid.rC)
    kernels.check_fields(dtype, (nyp, nxp), recip_dxC=grid.recip_dxC,
                         recip_dyC=grid.recip_dyC)
    ins = (rhoInSitu, grid.drC, grid.rF, grid.rC, grid.recip_dxC,
           grid.recip_dyC)
    kernels.launch("phihyd", dtype,
                   *(t.data_ptr() for t in (*ins, *outs)),
                   nr, nyp, nxp, cfg.gravity, 1.0 / cfg.rhoConst)
    return outs


def phihyd_vjp_plain(cfg: Config, grid: Grid, phiC_bar, dX_bar, dY_bar):
    """Kernel D''s plain version, in its operation order: rho's cotangent
    from those of (phiHydC, dPhiHydX, dPhiHydY). The gradients' transposes
    gather the east and north neighbours; the running sum's transpose is
    the exclusive suffix sum S, walked from the bottom up."""
    ex = dX_bar * grid.recip_dxC
    ey = dY_bar * grid.recip_dyC
    P = (phiC_bar + (ex - sh(ex, di=1))) + (ey - sh(ey, dj=1))
    dRlocM, dRlocP = _weights(cfg, grid)
    wsum = dRlocM + dRlocP
    S = torch.zeros_like(P[0])
    rho_bar = [None] * cfg.nr
    for k in range(cfg.nr - 1, -1, -1):
        b = S * wsum[k] + P[k] * dRlocM[k]
        rho_bar[k] = (b * (1.0 / cfg.rhoConst)) * cfg.gravity
        S = S + P[k]
    return torch.stack(rho_bar)


def _phi_hyd_adj_kernel(cfg: Config, grid: Grid, phiC_bar, dX_bar, dY_bar):
    """Kernel D' on the card (phihyd_adj.cu): rho's cotangent, fresh."""
    rho_bar = torch.empty_like(phiC_bar)
    nr, nyp, nxp = rho_bar.shape
    dtype = rho_bar.dtype
    kernels.check_fields(dtype, (nr, nyp, nxp), phiC_bar=phiC_bar,
                         dPhiHydX_bar=dX_bar, dPhiHydY_bar=dY_bar,
                         rho_bar=rho_bar)
    kernels.check_fields(dtype, (nr + 1,), drC=grid.drC, rF=grid.rF)
    kernels.check_fields(dtype, (nr,), rC=grid.rC)
    kernels.check_fields(dtype, (nyp, nxp), recip_dxC=grid.recip_dxC,
                         recip_dyC=grid.recip_dyC)
    table = [phiC_bar, dX_bar, dY_bar, grid.drC, grid.rF, grid.rC,
             grid.recip_dxC, grid.recip_dyC, rho_bar]
    kernels.launch("phihyd_adj", dtype, kernels.pointer_table(table),
                   len(table), nr, nyp, nxp, cfg.gravity, 1.0 / cfg.rhoConst)
    return rho_bar


def calc_phi_hyd(cfg: Config, grid: Grid, rhoInSitu: torch.Tensor,
                 impl: str = None):
    """Return (phiHydC, dPhiHydX, dPhiHydY, totPhiHyd).

    The buoyancy b' = g rho'/rhoConst is integrated down each column with
    the half-cell weights dRlocM/dRlocP (calc_phi_hyd.F integr_GeoPot=2):
    phiHydC(k) = sum_{m<k} (dRlocM+dRlocP)(m) b(m) + dRlocM(k) b(k)."""
    if not kernels.use_kernel(rhoInSitu, impl):
        global plain_calls
        plain_calls += 1
        phiC, dX, dY = _phi_hyd_plain(cfg, grid, rhoInSitu)
    else:
        kernels.refuse_grad("calc_phi_hyd", drC=grid.drC, rF=grid.rF,
                            rC=grid.rC, recip_dxC=grid.recip_dxC,
                            recip_dyC=grid.recip_dyC)
        phiC, dX, dY = kernels.KernelVJP.apply(
            lambda rho: _phi_hyd_kernel(cfg, grid, rho),
            lambda need, *bars: (_phi_hyd_adj_kernel(cfg, grid, *bars),),
            rhoInSitu)
    return phiC, dX, dY, phiC
