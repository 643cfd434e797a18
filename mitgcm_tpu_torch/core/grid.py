"""Grid generation: C-grid metrics, partial cells and masks
(mitgcm_tpu/core/grid.py:build_grid, z-coordinate Cartesian branch).

The geometry is computed in float64 numpy exactly as the JAX package does
and converted to tensors at the end, so every field is bit-equal to the
JAX grid. Horizontal fields are [ny+2*oly, nx+2*olx]; 3-D fields are
[nr, ny+2*oly, nx+2*olx]. The dataclass holds only the fields the ported
slice reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mitgcm_tpu_torch.core.config import Config


@dataclass(frozen=True)
class Grid:
    """Time-invariant geometry (reference: model/inc/GRID.h)."""

    # vertical (1-D)
    rF: torch.Tensor          # [nr+1] interface r
    rC: torch.Tensor          # [nr]   center r
    drF: torch.Tensor         # [nr]
    drC: torch.Tensor         # [nr+1]
    recip_drF: torch.Tensor
    recip_drC: torch.Tensor
    # horizontal metrics (2-D padded)
    dxF: torch.Tensor
    dyF: torch.Tensor
    dxG: torch.Tensor
    dyG: torch.Tensor
    dxC: torch.Tensor
    dyC: torch.Tensor
    dxV: torch.Tensor
    dyU: torch.Tensor
    rA: torch.Tensor
    rAw: torch.Tensor
    rAs: torch.Tensor
    recip_dxF: torch.Tensor
    recip_dyF: torch.Tensor
    recip_dxG: torch.Tensor
    recip_dyG: torch.Tensor
    recip_dxC: torch.Tensor
    recip_dyC: torch.Tensor
    recip_dxV: torch.Tensor
    recip_dyU: torch.Tensor
    recip_rA: torch.Tensor
    recip_rAw: torch.Tensor
    recip_rAs: torch.Tensor
    recip_rAz: torch.Tensor   # vorticity (corner) point area
    cosFacU: torch.Tensor
    cosFacV: torch.Tensor
    fCori: torch.Tensor
    fCoriG: torch.Tensor      # at vorticity points
    # partial cells and masks (3-D, except the maskIn* column masks)
    hFacC: torch.Tensor
    hFacW: torch.Tensor
    hFacS: torch.Tensor
    recip_hFacC: torch.Tensor
    recip_hFacW: torch.Tensor
    recip_hFacS: torch.Tensor
    maskC: torch.Tensor
    maskW: torch.Tensor
    maskS: torch.Tensor
    maskInC: torch.Tensor
    maskInW: torch.Tensor
    maskInS: torch.Tensor
    # the column's bottom and surface r (2-D), GGL90's mixing-length limits
    R_low: torch.Tensor
    Ro_surf: torch.Tensor
    # the same at U and V points (ini_masks_etc.F:330-360), calc_gw's
    # interface-centred face areas
    rLowW: torch.Tensor
    rSurfW: torch.Tensor
    rLowS: torch.Tensor
    rSurfS: torch.Tensor
    # the 1-based level of the column's top wet cell, nr + 1 in dry columns
    # (the JAX package's int array, held in the grid's float dtype)
    kSurfC: torch.Tensor
    # the horizontal component of the rotation vector (ini_cori.F: fPrime
    # on a Cartesian grid) and the grid's rotation (1 and 0 here): the 3-D
    # Coriolis terms of the non-hydrostatic path
    fCoriCos: torch.Tensor
    angleCosC: torch.Tensor
    angleSinC: torch.Tensor
    # linear free surface factors (ini_linear_phisurf.F)
    Bo_surf: torch.Tensor
    recip_Bo: torch.Tensor
    globalArea: torch.Tensor  # 0-d


def _extend_spacing(vals: np.ndarray, ol: int) -> np.ndarray:
    return np.concatenate([np.full(ol, vals[0]), vals, np.full(ol, vals[-1])])


def _safe_recip(a: np.ndarray) -> np.ndarray:
    """1/a where a != 0, else 0."""
    return np.divide(1.0, a, out=np.zeros_like(a), where=a != 0.0)


def _cyc(a: np.ndarray, oly: int, olx: int) -> np.ndarray:
    """Host-side cyclic halo fill (numpy twin of stencil.cyclic_fill_halo):
    the interior padded by wrapping, one copy."""
    ny = a.shape[-2] - 2 * oly
    nx = a.shape[-1] - 2 * olx
    inner = a[..., oly:oly + ny, olx:olx + nx]
    pad = [(0, 0)] * (a.ndim - 2) + [(oly, oly), (olx, olx)]
    return np.pad(inner, pad, mode="wrap")


def _hfac_column(rlow, rsurf, rF, drF, recip_drF, hFacMin, hFacMinDr):
    """Two-stage partial-cell fraction (ini_masks_etc.F:73-120)."""
    nr = drF.shape[0]
    hFac = np.zeros((nr,) + rlow.shape)
    for k in range(nr):
        hFacMnSz = max(hFacMin, min(hFacMinDr * recip_drF[k], 1.0))
        h1 = (rF[k] - rlow) * recip_drF[k]
        h1 = np.minimum(np.maximum(h1, 0.0), 1.0)
        low = np.where((h1 < hFacMnSz * 0.5) | (rlow >= rsurf), 0.0,
                       np.maximum(h1, hFacMnSz))
        h2 = (rF[k] - rsurf) * recip_drF[k]
        h = np.maximum(low - np.maximum(h2, 0.0), 0.0)
        hFac[k] = np.where(h < hFacMnSz * 0.5, 0.0, np.maximum(h, hFacMnSz))
    return hFac


def build_grid(cfg: Config, bathy: Optional[np.ndarray] = None,
               dtype: torch.dtype = torch.float64,
               device="cuda") -> Grid:
    """Cartesian z-coordinate grid. bathy: [ny, nx] bottom depths (negative
    r); a flat bottom at rF[nr] when None."""
    if not cfg.usingCartesianGrid or cfg.usingPCoords:
        raise NotImplementedError(
            "the port builds Cartesian z-coordinate grids only")
    if len(cfg.delRc) or cfg.useMin4hFacEdges or cfg.nFaces != 1:
        raise NotImplementedError(
            "delRc, useMin4hFacEdges and multi-face grids are not ported")
    if cfg.bathyFile:
        raise NotImplementedError("the port reads no bathymetry files")
    nx, ny, nr = cfg.nx, cfg.ny, cfg.nr
    olx, oly = cfg.olx, cfg.oly
    pshape = (ny + 2 * oly, nx + 2 * olx)

    # ---- vertical grid (ini_vertical_grid.F) ----
    delR = np.asarray(cfg.delR, dtype=np.float64)
    if delR.size == 0:
        delR = np.full(nr, 1.0)
    if delR.size < nr:
        delR = np.concatenate([delR, np.full(nr - delR.size, delR[-1])])
    drF = delR.copy()
    drC = np.zeros(nr + 1)
    drC[0] = 0.5 * drF[0]
    drC[1:nr] = 0.5 * (drF[:-1] + drF[1:])
    drC[nr] = 0.5 * drF[nr - 1]
    rF = np.zeros(nr + 1)
    rC = np.zeros(nr)
    rF[0] = cfg.seaLev_Z
    for k in range(nr):
        rF[k + 1] = rF[k] - drF[k]
    rC[0] = rF[0] - drC[0]
    for k in range(1, nr):
        rC[k] = rC[k - 1] - drC[k]

    # ---- horizontal coordinates (only y is needed, for Coriolis) ----
    delX = _extend_spacing(np.asarray(cfg.delX, dtype=np.float64), olx)
    delY = _extend_spacing(np.asarray(cfg.delY, dtype=np.float64), oly)
    yg1 = np.zeros(ny + 2 * oly + 1)
    yg1[oly] = cfg.ygOrigin
    for j in range(oly, ny + 2 * oly):
        yg1[j + 1] = yg1[j] + delY[j]
    for j in range(oly, 0, -1):
        yg1[j - 1] = yg1[j] - delY[j - 1]
    yG2 = np.broadcast_to(yg1[:, None], (ny + 2 * oly + 1, nx + 2 * olx + 1))
    yC = 0.25 * (yG2[:-1, :-1] + yG2[:-1, 1:] + yG2[1:, :-1] + yG2[1:, 1:])
    yG = yG2[:-1, :-1]

    dX2 = np.broadcast_to(delX[None, :], pshape).copy()
    dY2 = np.broadcast_to(delY[:, None], pshape).copy()
    dxF = dX2.copy(); dyF = dY2.copy()
    dxG = dX2.copy(); dyG = dY2.copy()
    rA = dxF * dyF
    cosU = np.ones(pshape); cosV = np.ones(pshape)

    dxC = np.zeros(pshape); dyC = np.zeros(pshape)
    dxV = np.zeros(pshape); dyU = np.zeros(pshape)
    dxC[:, 1:] = 0.5 * (dxF[:, 1:] + dxF[:, :-1])
    dyC[1:, :] = 0.5 * (dyF[1:, :] + dyF[:-1, :])
    dxV[1:, 1:] = 0.5 * (dxG[1:, 1:] + dxG[1:, :-1])
    dyU[1:, 1:] = 0.5 * (dyG[1:, 1:] + dyG[:-1, 1:])
    dxC[:, 0] = dxC[:, 1]; dyC[0, :] = dyC[1, :]
    dxV[:, 0] = dxV[:, 1]; dxV[0, :] = dxV[1, :]
    dyU[:, 0] = dyU[:, 1]; dyU[0, :] = dyU[1, :]
    rAw = dxC * dyG
    rAs = dxG * dyC
    rAz = dxV * dyU

    # ---- Coriolis (ini_cori.F, Cartesian: f-plane or beta-plane) ----
    if cfg.beta != 0.0:
        fCori = cfg.f0 + cfg.beta * yC
        fCoriG = cfg.f0 + cfg.beta * yG
    else:
        fCori = np.full(pshape, cfg.f0)
        fCoriG = np.full(pshape, cfg.f0)
    fCoriCos = np.full(pshape, cfg.fPrime)

    # ---- bathymetry & partial cells (ini_depths.F, ini_masks_etc.F) ----
    if bathy is None:
        bathy = np.full((ny, nx), rF[nr])
    R_low = np.zeros(pshape)
    R_low[oly:oly + ny, olx:olx + nx] = bathy
    R_low = np.minimum(_cyc(R_low, oly, olx), rF[0])
    Ro_surf = np.full(pshape, rF[0])
    recip_drF = _safe_recip(drF)
    recip_drC = _safe_recip(drC)

    rLowW = np.zeros(pshape); rSurfW = np.zeros(pshape)
    rLowS = np.zeros(pshape); rSurfS = np.zeros(pshape)
    rLowW[:, 1:] = np.maximum(R_low[:, 1:], R_low[:, :-1])
    rSurfW[:, 1:] = np.minimum(Ro_surf[:, 1:], Ro_surf[:, :-1])
    rLowS[1:, :] = np.maximum(R_low[1:, :], R_low[:-1, :])
    rSurfS[1:, :] = np.minimum(Ro_surf[1:, :], Ro_surf[:-1, :])
    rLowW[:, 0] = rF[0]; rSurfW[:, 0] = rF[0]
    rLowS[0, :] = rF[0]; rSurfS[0, :] = rF[0]
    rSurfW = np.maximum(rSurfW, rLowW)
    rSurfS = np.maximum(rSurfS, rLowS)

    # stage 1 clips against the lower boundary; R_low is regularised from
    # the stage-1 thickness, stage 2 clips against Ro_surf and Ro_surf is
    # re-derived (ini_masks_etc.F:104-195)
    hFacC = np.zeros((nr,) + pshape)
    for k in range(nr):
        hFacMnSz = max(cfg.hFacMin, min(cfg.hFacMinDr * recip_drF[k], 1.0))
        h1 = np.clip((rF[k] - R_low) * recip_drF[k], 0.0, 1.0)
        hFacC[k] = np.where((h1 < hFacMnSz * 0.5) | (R_low >= Ro_surf),
                            0.0, np.maximum(h1, hFacMnSz))
    R_low = rF[0] - np.tensordot(drF, hFacC, axes=(0, 0))
    for k in range(nr):
        hFacMnSz = max(cfg.hFacMin, min(cfg.hFacMinDr * recip_drF[k], 1.0))
        h2 = (rF[k] - Ro_surf) * recip_drF[k]
        h = np.maximum(hFacC[k] - np.maximum(h2, 0.0), 0.0)
        hFacC[k] = np.where(h < hFacMnSz * 0.5, 0.0, np.maximum(h, hFacMnSz))
    Ro_surf = R_low + np.tensordot(drF, hFacC, axes=(0, 0))

    kSurfC = np.full(pshape, nr + 1, dtype=np.int32)
    for k in range(nr - 1, -1, -1):
        kSurfC = np.where(hFacC[k] != 0.0, k + 1, kSurfC)
    maskInC = _cyc((kSurfC <= nr).astype(np.float64), oly, olx)
    kSurfC = _cyc(kSurfC, oly, olx)

    hFacW = _cyc(_hfac_column(rLowW, rSurfW, rF, drF, recip_drF,
                              cfg.hFacMin, cfg.hFacMinDr), oly, olx)
    hFacS = _cyc(_hfac_column(rLowS, rSurfS, rF, drF, recip_drF,
                              cfg.hFacMin, cfg.hFacMinDr), oly, olx)
    hFacC = _cyc(hFacC, oly, olx)
    R_low = _cyc(R_low, oly, olx)
    Ro_surf = _cyc(Ro_surf, oly, olx)
    # the face envelopes again, from the regularised columns
    # (ini_masks_etc.F:330-360)
    rLowW[:, 1:] = np.maximum(R_low[:, 1:], R_low[:, :-1])
    rSurfW[:, 1:] = np.minimum(Ro_surf[:, 1:], Ro_surf[:, :-1])
    rLowS[1:, :] = np.maximum(R_low[1:, :], R_low[:-1, :])
    rSurfS[1:, :] = np.minimum(Ro_surf[1:, :], Ro_surf[:-1, :])
    rSurfW = np.maximum(rSurfW, rLowW)
    rSurfS = np.maximum(rSurfS, rLowS)
    kSurfW = np.full(pshape, nr + 1, dtype=np.int32)
    kSurfS = np.full(pshape, nr + 1, dtype=np.int32)
    for k in range(nr - 1, -1, -1):
        kSurfW = np.where(hFacW[k] != 0.0, k + 1, kSurfW)
        kSurfS = np.where(hFacS[k] != 0.0, k + 1, kSurfS)

    inmask = np.zeros(pshape)
    inmask[oly:oly + ny, olx:olx + nx] = 1.0
    globalArea = float(np.sum(rA * maskInC * inmask))

    def T(a):   # C order: the kernels take contiguous tensors only
        a = torch.from_numpy(np.asarray(a, dtype=np.float64, order="C"))
        return a.to(device=device).to(dtype=dtype)

    return Grid(
        rF=T(rF), rC=T(rC), drF=T(drF), drC=T(drC),
        recip_drF=T(recip_drF), recip_drC=T(recip_drC),
        dxF=T(dxF), dyF=T(dyF), dxG=T(dxG), dyG=T(dyG),
        dxC=T(dxC), dyC=T(dyC), dxV=T(dxV), dyU=T(dyU),
        rA=T(rA), rAw=T(rAw), rAs=T(rAs),
        recip_dxF=T(_safe_recip(dxF)), recip_dyF=T(_safe_recip(dyF)),
        recip_dxG=T(_safe_recip(dxG)), recip_dyG=T(_safe_recip(dyG)),
        recip_dxC=T(_safe_recip(dxC)), recip_dyC=T(_safe_recip(dyC)),
        recip_dxV=T(_safe_recip(dxV)), recip_dyU=T(_safe_recip(dyU)),
        recip_rA=T(_safe_recip(rA)), recip_rAw=T(_safe_recip(rAw)),
        recip_rAs=T(_safe_recip(rAs)), recip_rAz=T(_safe_recip(rAz)),
        cosFacU=T(cosU), cosFacV=T(cosV), fCori=T(fCori),
        fCoriG=T(fCoriG),
        hFacC=T(hFacC), hFacW=T(hFacW), hFacS=T(hFacS),
        recip_hFacC=T(_safe_recip(hFacC)), recip_hFacW=T(_safe_recip(hFacW)),
        recip_hFacS=T(_safe_recip(hFacS)),
        maskC=T(hFacC > 0.0), maskW=T(hFacW > 0.0), maskS=T(hFacS > 0.0),
        maskInC=T(maskInC), maskInW=T(kSurfW <= nr), maskInS=T(kSurfS <= nr),
        R_low=T(R_low), Ro_surf=T(Ro_surf),
        rLowW=T(rLowW), rSurfW=T(rSurfW), rLowS=T(rLowS), rSurfS=T(rSurfS),
        kSurfC=T(kSurfC), fCoriCos=T(fCoriCos),
        angleCosC=T(np.ones(pshape)), angleSinC=T(np.zeros(pshape)),
        Bo_surf=T(np.full(pshape, cfg.gBaro)),
        recip_Bo=T(np.full(pshape, 1.0 / cfg.gBaro)),
        globalArea=T(globalArea),
    )
