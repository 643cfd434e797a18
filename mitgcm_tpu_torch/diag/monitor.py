"""Monitor statistics (mitgcm_tpu/diag/monitor.py: calc_stats, dynstat;
reference pkg/monitor/mon_calc_stats_rl.F and monitor.F)."""

from __future__ import annotations

from typing import Dict

import torch

from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.core.state import State
from mitgcm_tpu_torch.model.thsice import TH_FIELDS
from mitgcm_tpu_torch.ops.stencil import interior_mask, shift as sh


def calc_stats(cfg: Config, arr, hFac, mask2d, area, dr
               ) -> Dict[str, torch.Tensor]:
    """mon_calc_stats_rl.F: min, max, volume-weighted mean and sd, and the
    del2 roughness of arr over wet interior cells. arr/hFac: [nr', ...];
    mask2d/area: 2-D; dr: [nr']."""
    dt = arr.dtype
    imask = interior_mask(arr.shape, cfg.oly, cfg.olx, dt, arr.device)
    tmpMask = mask2d * hFac * imask
    wet = tmpMask > 0.0
    zero = torch.zeros_like(arr)
    big = torch.finfo(dt).max
    theMin = torch.min(torch.where(wet, arr, big))
    theMax = torch.max(torch.where(wet, arr, -big))

    ddx = torch.where(sh(hFac, di=1) * sh(hFac, di=-1) > 0.0,
                      (sh(arr, di=1) - arr) + (sh(arr, di=-1) - arr), zero)
    ddy = torch.where(sh(hFac, dj=1) * sh(hFac, dj=-1) > 0.0,
                      (sh(arr, dj=1) - arr) + (sh(arr, dj=-1) - arr), zero)
    del2_sum = torch.sum(torch.where(wet, ddx * ddx + ddy * ddy, zero))
    nPts = torch.sum(wet.to(dt))

    vol = area * dr[:, None, None] * tmpMask
    volSum = torch.sum(torch.where(wet, vol, zero))
    meanSum = torch.sum(torch.where(wet, vol * arr, zero))
    theMean = torch.where(volSum > 0.0, meanSum / volSum, 0.0)
    dev = arr - theMean
    sdSum = torch.sum(torch.where(wet, vol * (dev * dev), zero))
    theSD = torch.where(volSum > 0.0, torch.sqrt(sdSum / volSum), 0.0)
    theDel2 = torch.where(nPts > 0.0, torch.sqrt(del2_sum) / nPts, 0.0)
    any_wet = torch.any(wet)
    return {"max": torch.where(any_wet, theMax, 0.0),
            "min": torch.where(any_wet, theMin, 0.0),
            "mean": theMean, "sd": theSD, "del2": theDel2}


def dynstat(cfg: Config, grid: Grid, state: State
            ) -> Dict[str, torch.Tensor]:
    """monitor.F dynstat block, advective CFL, kinetic and potential
    energy, and the SST/SSS statistics (monitorSelect >= 3)."""
    out: Dict[str, torch.Tensor] = {}
    drF = grid.drF
    thickF = grid.drC[:cfg.nr]
    rows = (("eta", state.etaN[None], grid.maskInC[None], grid.maskInC,
             grid.rA, drF[:1]),
            ("uvel", state.uVel, grid.hFacW, grid.maskInW, grid.rAw, drF),
            ("vvel", state.vVel, grid.hFacS, grid.maskInS, grid.rAs, drF),
            ("wvel", state.wVel, grid.maskC, grid.maskInC, grid.rA, thickF),
            ("theta", state.theta, grid.hFacC, grid.maskInC, grid.rA, drF),
            ("salt", state.salt, grid.hFacC, grid.maskInC, grid.rA, drF))
    if cfg.monitorSelect >= 3:
        ks = cfg.ksurf0
        rows += (("sst", state.theta[ks][None], grid.maskInC[None],
                  grid.maskInC, grid.rA, drF[:1]),
                 ("sss", state.salt[ks][None], grid.maskInC[None],
                  grid.maskInC, grid.rA, drF[:1]))
    for name, arr, hFac, mask2d, area, dr in rows:
        for k, v in calc_stats(cfg, arr, hFac, mask2d, area, dr).items():
            out[f"dynstat_{name}_{k}"] = v

    # advective CFL numbers over interior cells (mon_advcfl.F)
    imask = interior_mask(state.etaN.shape, cfg.oly, cfg.olx,
                          state.etaN.dtype, state.etaN.device)
    dT = max(cfg.deltaTTracer, cfg.deltaTMom)
    out["advcfl_uvel_max"] = torch.max(
        torch.abs(state.uVel) * grid.recip_dxC * dT * imask)
    out["advcfl_vvel_max"] = torch.max(
        torch.abs(state.vVel) * grid.recip_dyC * dT * imask)
    out["advcfl_wvel_max"] = torch.max(
        torch.abs(state.wVel) * grid.recip_drC[:cfg.nr, None, None]
        * dT * imask)
    rhf = grid.recip_hFacC * grid.recip_drF[:, None, None]
    out["advcfl_W_hf_max"] = (
        torch.max(torch.abs(state.wVel[1:])
                  * torch.maximum(rhf[1:], rhf[:-1]) * dT * imask)
        if cfg.nr > 1 else torch.zeros((), dtype=imask.dtype,
                                       device=imask.device))

    # kinetic energy (mon_ke.F:68-127)
    u2w = state.uVel * state.uVel * grid.dyG * grid.dxC * grid.hFacW
    v2w = state.vVel * state.vVel * grid.dxG * grid.dyC * grid.hFacS
    tmp = 0.25 * ((u2w + sh(u2w, di=1)) + (v2w + sh(v2w, dj=1))
                  ) * grid.maskInC * imask
    ke_pt = tmp * grid.recip_hFacC * grid.recip_rA
    tmpA = tmp
    if cfg.nonHydrostatic:
        # the w^2 term (mon_ke.F:106-119); w at k = 0 is left out when
        # selectNHfreeSurf <= 0
        w = state.wVel
        k3 = torch.arange(cfg.nr, device=w.device)[:, None, None]
        msk1 = torch.where((k3 == 0) & (cfg.selectNHfreeSurf <= 0), 0.0, 1.0
                           ).to(w.dtype)
        w2 = w ** 2
        wkp1 = torch.cat([w2[1:], torch.zeros_like(w2[:1])])
        wke = (0.25 * (w2 * msk1 + wkp1) * grid.maskC * grid.maskInC
               * imask)
        tmpA = tmp + wke * grid.rA * grid.hFacC
        ke_pt = ke_pt + wke
    keVol = (grid.rA * grid.hFacC * drF[:, None, None] * grid.maskInC
             * imask)
    volSum = torch.sum(keVol)
    out["ke_max"] = torch.max(ke_pt)
    out["ke_mean"] = torch.where(
        volSum > 0, torch.sum(tmpA * drF[:, None, None]) / volSum, 0.0)
    out["ke_vol"] = volSum
    # surface potential energy (mon_ke.F:133-142)
    pe = (0.5 * grid.Bo_surf * (state.etaN * state.etaN) * grid.rA
          * grid.maskInC * imask)
    out["pe_b_mean"] = torch.where(volSum > 0, torch.sum(pe) / volSum, 0.0)
    return out


def seaice_stats(cfg: Config, grid: Grid, state: State
                 ) -> Dict[str, torch.Tensor]:
    """The seaice_* statistics (seaice_monitor.F; experiment.py:865-881 of
    the JAX package): uIce and vIce at U and V points, AREA, HEFF and
    HSNOW at C points, then each ice tracer as sitracer01, sitracer02, ...
    at C points, each over the surface layer's wet interior."""
    out: Dict[str, torch.Tensor] = {}
    drn = grid.drF[:1]
    rows = [("uice", state.uIce, grid.maskInW, grid.rAw),
            ("vice", state.vIce, grid.maskInS, grid.rAs),
            ("area", state.siAREA, grid.maskInC, grid.rA),
            ("heff", state.siHEFF, grid.maskInC, grid.rA),
            ("hsnow", state.siHSNOW, grid.maskInC, grid.rA)]
    if state.SItracer is not None:
        rows += [(f"sitracer{i + 1:02d}", tr, grid.maskInC, grid.rA)
                 for i, tr in enumerate(state.SItracer)]
    for name, fld, mk, ar in rows:
        for k, v in calc_stats(cfg, fld[None], mk[None], mk, ar, drn).items():
            out[f"seaice_{name}_{k}"] = v
    return out


def thsice_stats(thsice, state: State) -> Dict[str, torch.Tensor]:
    """The thSI_* statistics (thsice_monitor.F; experiment.py:889-894 of
    the JAX package) of the state's th* fields, by the ThSIce object's
    `monitor`: plain reductions, as seaice_stats's are."""
    return thsice.monitor({k: getattr(state, k) for k in TH_FIELDS})
