"""The forward timestep (mitgcm_tpu/model/step.py:forward_step), reduced to
the main path of the wind-driven gyre:

  find_rho -> THERMODYNAMICS -> DYNAMICS -> fill u*,v* ->
  SOLVE_FOR_PRESSURE (cg2d) -> MOMENTUM_CORRECTION_STEP -> fill u,v ->
  INTEGR_CONTINUITY -> fill

`check_supported` raises for every configuration flag off that path, so
nothing the JAX step would do is silently skipped. `impl` is passed to the
three kernel wrappers: None runs the CUDA kernels on CUDA tensors and the
plain PyTorch twins on CPU tensors; "plain" runs the twins on any device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from mitgcm_tpu.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.core.state import Forcing, State
from mitgcm_tpu_torch.model import thermodynamics as thermo_mod
from mitgcm_tpu_torch.model.mom_fluxform import check_branches, mom_fluxform
from mitgcm_tpu_torch.model.phihyd import calc_phi_hyd
from mitgcm_tpu_torch.ops import eos
from mitgcm_tpu_torch.ops.stencil import (cyclic_fill_halo, interior_mask,
                                          shift as sh)
from mitgcm_tpu_torch.solver import cg2d as cg2d_mod


@dataclass
class StepDiag:
    cg2d_init_res: torch.Tensor
    cg2d_last_res: torch.Tensor
    cg2d_iters: int
    cg2d_host_syncs: int


_PACKAGES = ("useKPP", "useGGL90", "usePP81", "useMY82", "useOPPS",
             "useSEAICE", "useEXF", "useOBCS", "usePTRACERS", "useRBCS",
             "useAIM", "useLand", "useThSIce", "useZONAL_FILT", "useOffLine",
             "useGCHEM", "useGMRedi", "useSHAP_FILT")


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError unless cfg stays on the ported main path
    (Cartesian z-coordinates, linear EOS, flux-form momentum, AB-2,
    linear implicit free surface solved by cg2d, scheme-2 tracers)."""
    off = {
        "vectorInvariantMomentum": cfg.vectorInvariantMomentum,
        "useAB3": cfg.useAB3,
        "staggerTimeStep": cfg.staggerTimeStep,
        "nonlinFreeSurf>0": cfg.nonlinFreeSurf > 0,
        "exactConserv": cfg.exactConserv,
        "useRealFreshWaterFlux": cfg.useRealFreshWaterFlux,
        "convertFW2Salt=-1": cfg.convertFW2Salt == -1.0,
        "implicitDiffusion": cfg.implicitDiffusion,
        "implicitFreeSurface=F": not cfg.implicitFreeSurface,
        "implicSurfPress!=1": cfg.implicSurfPress != 1.0,
        "implicDiv2Dflow!=1": cfg.implicDiv2Dflow != 1.0,
        "nonHydrostatic": cfg.nonHydrostatic,
        "quasiHydrostatic": cfg.quasiHydrostatic,
        "p-coordinates": cfg.usingPCoords or not cfg.usingZCoords,
        "fluidIsAir": cfg.fluidIsAir,
        "non-Cartesian grid": (not cfg.usingCartesianGrid
                               or cfg.usingSphericalPolarGrid
                               or cfg.usingCurvilinearGrid
                               or cfg.nFaces != 1),
        "eosType": cfg.eosType.upper() != "LINEAR",
        "momStepping=F": not cfg.momStepping,
        "momPressureForcing=F": not cfg.momPressureForcing,
        "momForcing=F": not cfg.momForcing,
        "forcing outside AB": (cfg.momForcingOutAB != 0
                               or cfg.tracForcingOutAB != 0),
        "momDissip_In_AB=F": not cfg.momDissip_In_AB,
        "doAB_onGtGs=F": not cfg.doAB_onGtGs,
        "periodicExternalForcing": cfg.periodicExternalForcing,
        "allowFreezing": cfg.allowFreezing,
        "shortwaveHeating": cfg.shortwaveHeating,
        "ivdc_kappa": cfg.ivdc_kappa != 0.0,
        "cAdjFreq": cfg.cAdjFreq != 0.0,
        "Bryan-Lewis diffusivity": (cfg.diffKrBL79surf != 0.0
                                    or cfg.diffKrBL79deep != 0.0),
        "allow3dDiffKr": cfg.allow3dDiffKr,
        "biharmonic tracer diffusion": (cfg.diffK4T != 0.0
                                        or cfg.diffK4S != 0.0),
        "tracer advection scheme != 2": (
            cfg.tempAdvScheme != 2 or cfg.saltAdvScheme != 2
            or (cfg.tempVertAdvScheme or 2) != 2
            or (cfg.saltVertAdvScheme or 2) != 2),
        "cg2dExactSums": cfg.cg2dExactSums,
        "custom forcing hooks": (cfg.custom_forcing_uv is not None
                                 or cfg.custom_forcing_t is not None),
        "packages": any(getattr(cfg, p) for p in _PACKAGES),
    }
    bad = [name for name, is_off in off.items() if is_off]
    if bad:
        raise NotImplementedError(
            f"not on the ported main path: {', '.join(bad)}")
    check_branches(cfg)


def adams_bashforth2(cfg: Config, g, gNm1, myIter: int):
    """AB-2 extrapolation (adams_bashforth2.F): (g_extrap, gNm1'), with
    abFac = 0 on the cold-start first step."""
    startAB = 1 if cfg.startFromPickup else 0
    abFac = 0.0 if (myIter == cfg.nIter0 and startAB == 0) else 0.5 + cfg.abEps
    return g + abFac * (g - gNm1), g


def load_fields(forcing: Forcing) -> Forcing:
    """The (single, constant) forcing record as 2-D fields."""
    return Forcing(**{k: v[0] for k, v in forcing.__dict__.items()})


def apply_forcing_uv(cfg: Config, grid: Grid, forcing: Forcing):
    """Wind stress into the surface cell (apply_forcing.F)."""
    sfu = forcing.fu * cfg.mass2rUnit
    sfv = forcing.fv * cfg.mass2rUnit
    shape = (cfg.nr,) + tuple(sfu.shape)
    guExt = torch.zeros(shape, dtype=sfu.dtype, device=sfu.device)
    gvExt = torch.zeros_like(guExt)
    guExt[0] = sfu * grid.recip_drF[0] * grid.recip_hFacW[0]
    gvExt[0] = sfv * grid.recip_drF[0] * grid.recip_hFacS[0]
    return guExt, gvExt


def dynamics(cfg: Config, grid: Grid, state: State, forcing: Forcing,
             rhoInSitu, myIter: int, impl: str = None):
    """dynamics.F + timestep.F: (uStar, vStar, guNm1', gvNm1', totPhiHyd)."""
    u, v, w = state.uVel, state.vVel, state.wVel
    kshape = (cfg.nr + 1,) + tuple(u.shape[1:])
    kappaRU = torch.full(kshape, cfg.viscAr, dtype=u.dtype, device=u.device)
    kappaRV = torch.full(kshape, cfg.viscAr, dtype=u.dtype, device=u.device)
    _, dPhiHydX, dPhiHydY, totPhiHyd = calc_phi_hyd(cfg, grid, rhoInSitu)
    tend = mom_fluxform(cfg, grid, u, v, w, kappaRU, kappaRV, impl=impl)
    guExt, gvExt = apply_forcing_uv(cfg, grid, forcing)
    gU = tend.gU - dPhiHydX + tend.guDiss + guExt
    gV = tend.gV - dPhiHydY + tend.gvDiss + gvExt
    gU_ab, guNm1 = adams_bashforth2(cfg, gU, state.guNm1, myIter)
    gV_ab, gvNm1 = adams_bashforth2(cfg, gV, state.gvNm1, myIter)
    uStar = u + cfg.deltaTMom * gU_ab * grid.maskW
    vStar = v + cfg.deltaTMom * gV_ab * grid.maskS
    return uStar, vStar, guNm1, gvNm1, totPhiHyd


def solve_for_pressure(cfg: Config, grid: Grid, op, state: State, uStar,
                       vStar, impl: str = None):
    """solve_for_pressure.F, 2-D: cg2d for the new free surface.
    Returns (etaN, StepDiag)."""
    imask = interior_mask(state.etaN.shape, cfg.oly, cfg.olx,
                          uStar.dtype, uStar.device)
    drF = grid.drF[:, None, None]
    cg2d_x = grid.Bo_surf * state.etaN
    # divergence of the predicted transport, summed level by level in the
    # order k = Nr..1 (solve_for_pressure.F:146-152): a torch.sum over k
    # would change the digits of this cancellation-prone sum
    xA = grid.dyG * drF * grid.hFacW
    yA = grid.dxG * drF * grid.hFacS
    pfx = cfg.implicDiv2Dflow * xA * uStar / cfg.deltaTMom
    pfy = cfg.implicDiv2Dflow * yA * vStar / cfg.deltaTMom
    dbx = sh(pfx, di=1) - pfx
    dby = sh(pfy, dj=1) - pfy
    cg2d_b = torch.zeros_like(state.etaN)
    for k in range(cfg.nr - 1, -1, -1):
        cg2d_b = cg2d_b + dbx[k]
        cg2d_b = cg2d_b + dby[k]
    cg2d_b = cg2d_b - (cfg.freeSurfFac * grid.rA
                       / cfg.deltaTMom / cfg.deltaTFreeSurf) * state.etaN
    cg2d_b = cg2d_b * imask
    res = cg2d_mod.cg2d(cfg, op, cg2d_b, cg2d_x, impl=impl)
    return grid.recip_Bo * res.x, StepDiag(
        cg2d_init_res=res.first_residual, cg2d_last_res=res.last_residual,
        cg2d_iters=res.n_iters, cg2d_host_syncs=res.host_syncs)


def momentum_correction_step(cfg: Config, grid: Grid, etaN, uStar, vStar):
    """momentum_correction_step.F: subtract the new surface-pressure
    gradient."""
    BoEta = grid.Bo_surf * etaN
    phiSurfX = grid.recip_dxC * (BoEta - sh(BoEta, di=-1))
    phiSurfY = grid.recip_dyC * (BoEta - sh(BoEta, dj=-1))
    psFac = cfg.implicSurfPress
    u = (uStar - cfg.deltaTMom * psFac * phiSurfX * grid.maskW) * grid.maskW
    v = (vStar - cfg.deltaTMom * psFac * phiSurfY * grid.maskS) * grid.maskS
    return u, v


def integr_continuity(cfg: Config, grid: Grid, u, v, EmPmR):
    """integr_continuity.F + integrate_for_w.F for the linear free surface:
    returns (wVel, PmEpR'). w is integrated bottom-up level by level."""
    drF = grid.drF[:, None, None]
    uTrans = u * grid.dyG * drF * grid.hFacW
    vTrans = v * grid.dxG * drF * grid.hFacS
    div2d = (sh(uTrans, di=1) - uTrans) + (sh(vTrans, dj=1) - vTrans)
    cr = -div2d * grid.recip_rA
    w = torch.empty_like(cr)
    w_below = torch.zeros_like(cr[0])
    for k in range(cfg.nr - 1, -1, -1):
        w_below = (w_below + cr[k]) * grid.maskC[k]
        w[k] = w_below
    return w, -EmPmR


def forward_step(cfg: Config, grid: Grid, op, state: State,
                 forcing: Forcing, myIter: int, impl: str = None
                 ) -> Tuple[State, StepDiag]:
    """One timestep; myIter is the start-of-step iteration number."""
    check_supported(cfg)

    def fill(a):
        return cyclic_fill_halo(a, cfg.oly, cfg.olx)

    forc = load_fields(forcing)
    # in-situ density from the start-of-step tracers (do_oceanic_phys.F)
    rhoInSitu = eos.find_rho(cfg, state.theta, state.salt) * grid.maskC
    theta, salt, gtNm1, gsNm1 = thermo_mod.thermodynamics(
        cfg, grid, state, forc, myIter, impl=impl)
    uStar, vStar, guNm1, gvNm1, totPhiHyd = dynamics(
        cfg, grid, state, forc, rhoInSitu, myIter, impl=impl)
    uStar, vStar = fill(uStar), fill(vStar)
    etaN, diag = solve_for_pressure(cfg, grid, op, state, uStar, vStar,
                                    impl=impl)
    u, v = momentum_correction_step(cfg, grid, etaN, uStar, vStar)
    u, v = fill(u), fill(v)
    w, PmEpR = integr_continuity(cfg, grid, u, v, forc.EmPmR)
    new_state = State(
        uVel=u, vVel=v, wVel=fill(w), theta=fill(theta), salt=fill(salt),
        etaN=fill(etaN), etaH=fill(state.etaH),
        dEtaHdt=fill(state.dEtaHdt), PmEpR=fill(PmEpR),
        guNm1=guNm1, gvNm1=gvNm1, gtNm1=gtNm1, gsNm1=gsNm1,
        totPhiHyd=totPhiHyd)
    return new_state, diag
