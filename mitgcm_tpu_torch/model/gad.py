"""Generic advection-diffusion (mitgcm_tpu/model/gad.py) for centred
2nd-order advection (scheme 2) with Laplacian horizontal and explicit
vertical diffusion.

`calc_rhs` runs kernel C (kernels/csrc/gad_calc_rhs.cu) for CUDA tensors
and the plain PyTorch twin `_calc_rhs_plain` for CPU tensors or when
impl="plain" is asked for. The kernel writes zero halo cells; both agree
on the interior.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mitgcm_tpu.core.config import Config
from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.ops.stencil import shift as sh
from mitgcm_tpu_torch.ops.stencil import shift_k


class AdvFlow(NamedTuple):
    uTrans: torch.Tensor    # [nr, nyp, nxp]
    vTrans: torch.Tensor
    rTrans: torch.Tensor    # at interface k (surface index 0 = 0)
    rTransKp: torch.Tensor  # at interface k+1 (bottom = 0)
    maskUp: torch.Tensor
    xA: torch.Tensor
    yA: torch.Tensor


def calc_adv_flow(grid: Grid, u, v, w) -> AdvFlow:
    """model/src/calc_adv_flow.F, all levels at once."""
    drF = grid.drF[:, None, None]
    xA = grid.dyG * drF * grid.hFacW
    yA = grid.dxG * drF * grid.hFacS
    mC = grid.maskC
    maskUp = torch.cat([torch.zeros_like(mC[:1]), mC[1:] * mC[:-1]])
    rTrans = w * grid.rA * maskUp
    rTransKp = torch.cat([rTrans[1:], torch.zeros_like(rTrans[:1])])
    return AdvFlow(uTrans=u * xA, vTrans=v * yA, rTrans=rTrans,
                   rTransKp=rTransKp, maskUp=maskUp, xA=xA, yA=yA)


def adv_flux_x(uTrans, tracer):
    """Scheme-2 zonal advective flux at the west face (gad_c2_adv_x.F)."""
    return uTrans * 0.5 * (tracer + sh(tracer, di=-1))


def adv_flux_y(vTrans, tracer):
    return vTrans * 0.5 * (tracer + sh(tracer, dj=-1))


def adv_flux_r(grid: Grid, rTrans, tracer):
    """Scheme-2 vertical advective flux at interface k, zero at the surface
    (gad_c2_adv_r.F); the k-1 neighbours are clamped at the top."""
    tkm1 = torch.cat([tracer[:1], tracer[:-1]])
    mkm1 = torch.cat([grid.maskC[:1], grid.maskC[:-1]])
    flx = mkm1 * rTrans * 0.5 * (tracer + tkm1)
    flx[0] = 0.0
    return flx


def diff_flux_r(cfg: Config, grid: Grid, kappaR, maskUp, tracer):
    """gad_diff_r.F: interface diffusive flux [nr,...]; zero at surface."""
    flx = (-kappaR[:cfg.nr] * maskUp * grid.rA
           * grid.recip_drC[:cfg.nr, None, None]
           * (tracer - shift_k(tracer, -1)) * cfg.rkSign)
    flx[0] = 0.0
    return flx


def calc_rhs(cfg: Config, grid: Grid, flow: AdvFlow, tracer, kappaR,
             diffKh: float, impl: str = None) -> torch.Tensor:
    """gad_calc_rhs.F: explicit tendency of one tracer at all levels.
    kappaR: [nr, nyp, nxp] interface diffusivities."""
    if not kernels.use_kernel(tracer, impl):
        return _calc_rhs_plain(cfg, grid, flow, tracer, kappaR, diffKh)
    nr, nyp, nxp = tracer.shape
    fields3 = dict(uTrans=flow.uTrans, vTrans=flow.vTrans,
                   rTrans=flow.rTrans, xA=flow.xA, yA=flow.yA,
                   maskUp=flow.maskUp, tracer=tracer, kappaR=kappaR,
                   maskC=grid.maskC, recip_hFacC=grid.recip_hFacC)
    fields2 = {n: getattr(grid, n) for n in (
        "rA", "recip_dxC", "recip_dyC", "cosFacU", "recip_rA", "maskInC")}
    fields1 = dict(recip_drF=grid.recip_drF, recip_drC=grid.recip_drC)
    gTr = torch.empty_like(tracer)
    kernels.check_tensors(tracer.dtype, **fields3, **fields2, **fields1,
                          gTr=gTr)
    for name, t in fields3.items():
        kernels.check_shape(name, t, tracer.shape)
    for name, t in fields2.items():
        kernels.check_shape(name, t, (nyp, nxp))
    kernels.check_shape("recip_drF", grid.recip_drF, (nr,))
    kernels.check_shape("recip_drC", grid.recip_drC, (nr + 1,))
    # the order of kernels/csrc/gad_calc_rhs.cu:GadArgs
    table = [*fields3.values(), *fields2.values(), *fields1.values(), gTr]
    kernels.launch("gad_calc_rhs_c2", tracer.dtype,
                   kernels.pointer_table(table), len(table), nr,
                   nyp - 2 * cfg.oly, nxp - 2 * cfg.olx, cfg.oly, cfg.olx,
                   diffKh, cfg.rkSign)
    return gTr


def _calc_rhs_plain(cfg: Config, grid: Grid, flow: AdvFlow, tracer, kappaR,
                    diffKh: float) -> torch.Tensor:
    """gad.py:calc_rhs (:1038-1117) without GM, KPP or biharmonic terms,
    in its operation order."""
    fZon = adv_flux_x(flow.uTrans, tracer)
    fMer = adv_flux_y(flow.vTrans, tracer)
    fZon = fZon - (diffKh * flow.xA * grid.recip_dxC
                   * (tracer - sh(tracer, di=-1)) * grid.cosFacU)
    fMer = fMer - (diffKh * flow.yA * grid.recip_dyC
                   * (tracer - sh(tracer, dj=-1)))
    fVer = (adv_flux_r(grid, flow.rTrans, tracer) * grid.maskInC
            + diff_flux_r(cfg, grid, kappaR, flow.maskUp, tracer))
    fVerKp = torch.cat([fVer[1:], torch.zeros_like(fVer[:1])])
    divTrans = ((sh(flow.uTrans, di=1) - flow.uTrans)
                + (sh(flow.vTrans, dj=1) - flow.vTrans)
                + (flow.rTransKp - flow.rTrans) * cfg.rkSign)
    return -(grid.recip_hFacC * grid.recip_drF[:, None, None] * grid.recip_rA
             * (((sh(fZon, di=1) - fZon) + (sh(fMer, dj=1) - fMer))
                * grid.maskInC
                + (fVerKp - fVer) * cfg.rkSign
                - tracer * divTrans * grid.maskInC))
