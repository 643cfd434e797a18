"""Tracer thermodynamics (mitgcm_tpu/model/thermodynamics.py): explicit
advection-diffusion step of theta (and salt when stepped) with AB-2 on the
tendency and the surface forcing inside the AB extrapolation."""

from __future__ import annotations

import torch

from mitgcm_tpu.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.core.state import Forcing, State
from mitgcm_tpu_torch.model import gad


def surface_forcing_ts(cfg: Config, grid: Grid, state: State,
                       forcing: Forcing):
    """external_forcing_surf.F + forcing_surf_relax.F: surfaceForcingT/S
    (linear free surface, no sea ice, no shortwave penetration)."""
    sfT = torch.zeros_like(state.etaN)
    sfS = torch.zeros_like(state.etaN)
    ks = cfg.ksurf0
    if cfg.tauThetaClimRelax > 0.0:
        lam = 1.0 / cfg.tauThetaClimRelax
        sfT = sfT - lam * (state.theta[ks] - forcing.SST) \
            * grid.drF[ks] * grid.hFacC[ks]
    if cfg.tauSaltClimRelax > 0.0:
        lam = 1.0 / cfg.tauSaltClimRelax
        sfS = sfS - lam * (state.salt[ks] - forcing.SSS) \
            * grid.drF[ks] * grid.hFacC[ks]
    recip_Cp = 1.0 / cfg.HeatCapacity_Cp
    sfT = sfT - forcing.Qnet * recip_Cp * cfg.mass2rUnit
    sfS = sfS - forcing.saltFlux * cfg.mass2rUnit
    # virtual E-P-R tracer flux (external_forcing_surf.F:130-208)
    if cfg.temp_EvPrRn is not None:
        sfT = sfT + forcing.EmPmR * (cfg.tRef[0]
                                     - cfg.temp_EvPrRn) * cfg.mass2rUnit
    if cfg.salt_EvPrRn is not None:
        sfS = sfS + forcing.EmPmR * (cfg.convertFW2Salt
                                     - cfg.salt_EvPrRn) * cfg.mass2rUnit
    return sfT, sfS


def tracer_kappa(cfg: Config, grid: Grid, diffKr: float) -> torch.Tensor:
    """calc_3d_diffusivity.F: the constant background profile [nr, ...]."""
    return torch.full((cfg.nr,) + tuple(grid.rA.shape), diffKr,
                      dtype=grid.rA.dtype, device=grid.rA.device)


def tracer_integrate(cfg: Config, grid: Grid, flow: gad.AdvFlow, tracer,
                     gNm1, kappaR, sfc_forc, diffKh: float, myIter: int,
                     impl: str = None):
    """temp_integrate.F for one tracer: (tracer', gNm1')."""
    from mitgcm_tpu_torch.model.step import adams_bashforth2

    gTr = gad.calc_rhs(cfg, grid, flow, tracer, kappaR, diffKh, impl=impl)
    ks = cfg.ksurf0
    gForc = torch.zeros_like(tracer)
    gForc[ks] = sfc_forc * grid.recip_drF[ks] * grid.recip_hFacC[ks]
    gTr = gTr + gForc
    gTr_ab, gNm1_new = adams_bashforth2(cfg, gTr, gNm1, myIter)
    return tracer + cfg.deltaTTracer * gTr_ab, gNm1_new


def thermodynamics(cfg: Config, grid: Grid, state: State, forcing: Forcing,
                   myIter: int, impl: str = None):
    """thermodynamics.F: returns (theta, salt, gtNm1, gsNm1)."""
    theta, salt = state.theta, state.salt
    gtNm1, gsNm1 = state.gtNm1, state.gsNm1
    if not (cfg.tempStepping or cfg.saltStepping):
        return theta, salt, gtNm1, gsNm1
    flow = gad.calc_adv_flow(grid, state.uVel, state.vVel, state.wVel)
    sfT, sfS = surface_forcing_ts(cfg, grid, state, forcing)
    if cfg.tempStepping:
        theta, gtNm1 = tracer_integrate(
            cfg, grid, flow, theta, gtNm1, tracer_kappa(cfg, grid,
                                                        cfg.diffKrT),
            sfT, cfg.diffKhT, myIter, impl=impl)
    if cfg.saltStepping:
        salt, gsNm1 = tracer_integrate(
            cfg, grid, flow, salt, gsNm1, tracer_kappa(cfg, grid,
                                                       cfg.diffKrS),
            sfS, cfg.diffKhS, myIter, impl=impl)
    return theta, salt, gtNm1, gsNm1
