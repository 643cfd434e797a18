"""Flux-form momentum tendencies (mitgcm_tpu/model/mom_fluxform.py;
reference pkg/mom_fluxform/mom_fluxform.F) on the branches of the gyre:
centred advection, constant harmonic viscosity with the explicit vertical
viscous flux, no-slip side and bottom drag, and Coriolis scheme 0.

`mom_fluxform` runs kernel B (kernels/csrc/mom_fluxform.cu) for CUDA
tensors and the plain PyTorch twin `_mom_fluxform_plain` for CPU tensors
or when impl="plain" is asked for. The kernel writes zero halo cells; the
twin's halo cells are the JAX code's garbage-by-design values. Both agree
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


class MomTend(NamedTuple):
    gU: torch.Tensor
    gV: torch.Tensor
    guDiss: torch.Tensor
    gvDiss: torch.Tensor


def calc_hfacz(grid: Grid) -> torch.Tensor:
    """Vorticity-point open fraction (mom_calc_hfacz.F)."""
    hW, hS = grid.hFacW, grid.hFacS
    mW, mS = grid.maskW, grid.maskS
    openJ = torch.minimum(hW, sh(hW, dj=-1)) * mW * sh(mW, dj=-1)
    openI = torch.minimum(hS, sh(hS, di=-1)) * mS * sh(mS, di=-1)
    return torch.minimum(openI, openJ) * mW * sh(mW, dj=-1)


def calc_ke(u, v) -> torch.Tensor:
    """Kinetic energy at cell centers, selectKEscheme 0 (mom_calc_ke.F)."""
    u2, v2 = u * u, v * v
    return 0.25 * ((u2 + sh(u2, di=1)) + (v2 + sh(v2, dj=1)))


def check_branches(cfg: Config) -> None:
    """Raise unless cfg selects exactly the branches ported here."""
    off = {
        "momAdvection": not cfg.momAdvection,
        "momViscosity": not cfg.momViscosity,
        "no_slip_sides": not cfg.no_slip_sides,
        "no_slip_bottom": not cfg.no_slip_bottom,
        "selectCoriScheme": cfg.selectCoriScheme != 0,
        "select3dCoriScheme": cfg.select3dCoriScheme != 0,
        "biharmonic viscosity": (cfg.viscA4 != 0.0 or cfg.viscA4D != 0.0
                                 or cfg.viscA4Z != 0.0),
        "variable viscosity": (cfg.viscAhGrid != 0.0 or cfg.viscA4Grid != 0.0
                               or cfg.viscC2smag != 0.0
                               or cfg.viscC4smag != 0.0
                               or cfg.viscC2leith != 0.0
                               or cfg.viscC2leithD != 0.0
                               or cfg.viscC2LeithQG != 0.0
                               or cfg.viscC4leith != 0.0
                               or cfg.viscC4leithD != 0.0),
        "implicitViscosity": cfg.implicitViscosity,
        "bottom drag beyond no-slip": (cfg.bottomDragLinear != 0.0
                                       or cfg.selectBotDragQuadr >= 0),
        "rigidLid": cfg.rigidLid,
        "select_rStar": cfg.select_rStar != 0,
        "useCDscheme": cfg.useCDscheme,
        "useNHMTerms": cfg.useNHMTerms,
        "spherical metric terms": cfg.usingSphericalPolarGrid,
    }
    bad = [name for name, is_off in off.items() if is_off]
    if bad:
        raise NotImplementedError(
            f"mom_fluxform: branches not ported: {', '.join(bad)}")


def mom_fluxform(cfg: Config, grid: Grid, u, v, w, kappaRU, kappaRV,
                 impl: str = None) -> MomTend:
    """gU/gV (advection + Coriolis) and guDiss/gvDiss (viscosity + drag),
    masked; kappaRU/kappaRV: [nr+1, nyp, nxp] interface viscosities."""
    check_branches(cfg)
    if not kernels.use_kernel(u, impl):
        return _mom_fluxform_plain(cfg, grid, u, v, w, kappaRU, kappaRV)
    nr, nyp, nxp = u.shape
    fields3 = dict(u=u, v=v, w=w, hFacC=grid.hFacC, hFacW=grid.hFacW,
                   hFacS=grid.hFacS, maskC=grid.maskC, maskW=grid.maskW,
                   maskS=grid.maskS, recip_hFacW=grid.recip_hFacW,
                   recip_hFacS=grid.recip_hFacS)
    kappas = dict(kappaRU=kappaRU, kappaRV=kappaRV)
    fields2 = {n: getattr(grid, n) for n in (
        "dxF", "dyF", "dxG", "dyG", "dxV", "dyU", "rA", "rAw", "rAs",
        "recip_dxF", "recip_dyF", "recip_dxV", "recip_dyU", "recip_rAw",
        "recip_rAs", "cosFacU", "cosFacV", "fCori")}
    fields1 = dict(drF=grid.drF, recip_drF=grid.recip_drF,
                   recip_drC=grid.recip_drC)
    out = MomTend(*(torch.empty_like(u) for _ in range(4)))
    outs = dict(zip(MomTend._fields, out))
    kernels.check_tensors(u.dtype, **fields3, **kappas, **fields2, **fields1,
                          **outs)
    for name, t in {**fields3, **outs}.items():
        kernels.check_shape(name, t, u.shape)
    for name, t in kappas.items():
        kernels.check_shape(name, t, (nr + 1, nyp, nxp))
    for name, t in fields2.items():
        kernels.check_shape(name, t, (nyp, nxp))
    kernels.check_shape("drF", grid.drF, (nr,))
    kernels.check_shape("recip_drF", grid.recip_drF, (nr,))
    kernels.check_shape("recip_drC", grid.recip_drC, (nr + 1,))
    # the order of kernels/csrc/mom_fluxform.cu:MomArgs
    table = [*fields3.values(), *kappas.values(), *fields2.values(),
             *fields1.values(), *out]
    kernels.launch("mom_fluxform", u.dtype, kernels.pointer_table(table),
                   len(table), nr, nyp - 2 * cfg.oly, nxp - 2 * cfg.olx,
                   cfg.oly, cfg.olx, cfg.viscAhD, cfg.viscAhZ,
                   cfg.sideDragFactor, cfg.rkSign)
    return out


def _mom_fluxform_plain(cfg: Config, grid: Grid, u, v, w, kappaRU,
                        kappaRV) -> MomTend:
    """mom_fluxform.py:122-451 on the gyre's branches, in its operation
    order. The biharmonic terms of the JAX code add exact zeros here and
    are left out."""
    nr = cfg.nr
    drF = grid.drF[:, None, None]
    recip_drF = grid.recip_drF[:, None, None]
    rkSign = cfg.rkSign
    xA = grid.dyG * drF * grid.hFacW
    yA = grid.dxG * drF * grid.hFacS
    uTrans = u * xA
    vTrans = v * yA
    hFacZ = calc_hfacz(grid)

    # ---------------- advection (:155-230) ----------------
    wrA = w * grid.rA
    rTransU = 0.5 * (wrA + sh(wrA, di=-1))
    rTransV = 0.5 * (wrA + sh(wrA, dj=-1))
    fZonU = 0.25 * (uTrans + sh(uTrans, di=1)) * (u + sh(u, di=1))
    fMerU = 0.25 * (vTrans + sh(vTrans, di=-1)) * (u + sh(u, dj=-1))
    fZonV = 0.25 * (uTrans + sh(uTrans, dj=-1)) * (v + sh(v, di=-1))
    fMerV = 0.25 * (vTrans + sh(vTrans, dj=1)) * (v + sh(v, dj=1))
    # vertical fluxes at interfaces [nr+1]: rTrans*u(1) at the surface,
    # the centred average plus the free-surface dmask correction inside,
    # zero below the bottom
    fVerU_mid = rTransU * 0.5 * (u + shift_k(u, -1))
    fVerV_mid = rTransV * 0.5 * (v + shift_k(v, -1))
    mC = grid.maskC
    dmask = mC - shift_k(mC, -1)
    fVerU_mid = fVerU_mid + 0.25 * (wrA * dmask + sh(wrA * dmask, di=-1)) * u
    fVerV_mid = fVerV_mid + 0.25 * (wrA * dmask + sh(wrA * dmask, dj=-1)) * v
    z1 = torch.zeros_like(u[:1])
    fVerU = torch.cat([rTransU[:1] * u[:1], fVerU_mid[1:], z1])
    fVerV = torch.cat([rTransV[:1] * v[:1], fVerV_mid[1:], z1])
    gU = -(grid.recip_hFacW * recip_drF * grid.recip_rAw
           * ((fZonU - sh(fZonU, di=-1))
              + (sh(fMerU, dj=1) - fMerU)
              + (fVerU[1:] - fVerU[:-1]) * rkSign))
    gV = -(grid.recip_hFacS * recip_drF * grid.recip_rAs
           * ((sh(fZonV, di=1) - fZonV)
              + (fMerV - sh(fMerV, dj=-1))
              + (fVerV[1:] - fVerV[:-1]) * rkSign))

    # ------- harmonic + explicit vertical viscosity (:233-307) -------
    AhD, AhZ = cfg.viscAhD, cfg.viscAhZ
    fZonU = (grid.dyF * drF * grid.hFacC * grid.recip_dxF
             * (-AhD * (sh(u, di=1) - u) * grid.cosFacU))
    fMerU = (grid.dxV * drF * hFacZ * grid.recip_dyU
             * (-AhZ * (u - sh(u, dj=-1))))
    fZonV = (grid.dyU * drF * hFacZ * grid.recip_dxV
             * (-AhZ * (v - sh(v, di=-1)) * grid.cosFacV))
    fMerV = (grid.dxF * drF * grid.hFacC * grid.recip_dyF
             * (-AhD * (sh(v, dj=1) - v)))
    recip_drC = grid.recip_drC[1:nr, None, None]
    rvU_mid = (-kappaRU[1:nr] * grid.rAw * (u[1:] - u[:-1]) * rkSign
               * recip_drC * grid.maskW[1:] * grid.maskW[:-1])
    rvV_mid = (-kappaRV[1:nr] * grid.rAs * (v[1:] - v[:-1]) * rkSign
               * recip_drC * grid.maskS[1:] * grid.maskS[:-1])
    rViscU = torch.cat([z1, rvU_mid, z1])
    rViscV = torch.cat([z1, rvV_mid, z1])
    dVrU = (rViscU[1:] - rViscU[:-1]) * rkSign
    dVrV = (rViscV[1:] - rViscV[:-1]) * rkSign
    guDiss = -(grid.recip_hFacW * recip_drF * grid.recip_rAw
               * ((fZonU - sh(fZonU, di=-1)) + (sh(fMerU, dj=1) - fMerU)
                  + dVrU))
    gvDiss = -(grid.recip_hFacS * recip_drF * grid.recip_rAs
               * ((sh(fZonV, di=1) - fZonV) + (fMerV - sh(fMerV, dj=-1))
                  + dVrV))

    # ---------------- no-slip side drag (:312-340) ----------------
    Ahu = AhZ * u
    uDrag = -(grid.recip_hFacW * recip_drF * grid.recip_rAw
              * ((grid.hFacW - hFacZ) * grid.dxV * grid.recip_dyU * Ahu
                 + (grid.hFacW - sh(hFacZ, dj=1)) * sh(grid.dxV, dj=1)
                 * sh(grid.recip_dyU, dj=1) * Ahu)
              * drF * cfg.sideDragFactor)
    Ahv = AhZ * v * grid.cosFacV
    vDrag = -(grid.recip_hFacS * recip_drF * grid.recip_rAs
              * ((grid.hFacS - hFacZ) * grid.dyU * grid.recip_dxV * Ahv
                 + (grid.hFacS - sh(hFacZ, di=1)) * sh(grid.dyU, di=1)
                 * sh(grid.recip_dxV, di=1) * Ahv)
              * drF * cfg.sideDragFactor)
    guDiss = guDiss + uDrag
    gvDiss = gvDiss + vDrag

    # ---- no-slip bottom drag (:343-381): where the cell below is dry ----
    recDr = torch.cat([grid.recip_drC[1:nr],
                       grid.recip_drF[nr - 1:nr]])[:, None, None]
    cDragU = kappaRU[1:nr + 1] * recDr * 2.0
    cDragV = kappaRV[1:nr + 1] * recDr * 2.0
    bottomW = grid.maskW * (1.0 - torch.cat([grid.maskW[1:], z1]))
    bottomS = grid.maskS * (1.0 - torch.cat([grid.maskS[1:], z1]))
    guDiss = guDiss - cDragU * bottomW * u * grid.recip_hFacW * recip_drF
    gvDiss = gvDiss - cDragV * bottomS * v * grid.recip_hFacS * recip_drF

    # ---------------- Coriolis, scheme 0 (:420-445) ----------------
    fC = grid.fCori
    uCf = (0.5 * (fC + sh(fC, di=-1))
           * 0.25 * (v + sh(v, dj=1) + sh(v, di=-1) + sh(v, di=-1, dj=1)))
    vCf = (-0.5 * (fC + sh(fC, dj=-1))
           * 0.25 * (u + sh(u, di=1) + sh(u, dj=-1) + sh(u, di=1, dj=-1)))
    gU = gU + uCf
    gV = gV + vCf
    return MomTend(gU=gU * grid.maskW, gV=gV * grid.maskS,
                   guDiss=guDiss * grid.maskW, gvDiss=gvDiss * grid.maskS)
