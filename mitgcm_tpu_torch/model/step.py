"""The forward timestep (mitgcm_tpu/model/step.py:forward_step), reduced to
the ported paths of the wind-driven gyre:

  find_rho -> THERMODYNAMICS -> DYNAMICS -> fill u*,v* ->
  SOLVE_FOR_PRESSURE (cg2d) -> MOMENTUM_CORRECTION_STEP -> fill u,v ->
  INTEGR_CONTINUITY -> fill

The paths that go through it: the gyre (flux-form momentum, linear EOS,
AB-2, explicit vertical mixing), the vi-gyre (vector-invariant momentum, a
JMD95 or MDJWF EOS, AB-3, implicit vertical viscosity and diffusion), the
kpp-gyre (the vi-gyre with KPP boundary-layer mixing, run on the
start-of-step state before THERMODYNAMICS), the ggl90-gyre (the
kpp-gyre's set-up with GGL90 TKE mixing in place of KPP, on the same
state, and DST-3 flux-limited tracers under the multi-dimensional
advection) and its variants: the os7mp- and pqm-gyre (OS7MP, or monotone
PPM and PQM tracers, on halos of 4), the idemix-gyre (GGL90 with IDEMIX and
the Langmuir parameterization), the som-gyre (second-order-moment
tracers) and the nh-convection box (the non-hydrostatic path under
flux-form momentum: calc_gw and the AB step of w in DYNAMICS, the cg3d
solve for phi_nh after cg2d, and its gradient in the correction), and any
mix of those options.
`check_supported` raises for every
configuration flag off them, so nothing the JAX step would do is silently
skipped. `impl` is passed to the kernel wrappers: None runs the CUDA
kernels on CUDA tensors and the plain PyTorch twins on CPU tensors;
"plain" runs the twins on any device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.core.state import Forcing, State
from mitgcm_tpu_torch.model import calc_gw as calc_gw_mod
from mitgcm_tpu_torch.model import gad
from mitgcm_tpu_torch.model import ggl90 as ggl90_mod
from mitgcm_tpu_torch.model import kpp as kpp_mod
from mitgcm_tpu_torch.model import som as som_mod
from mitgcm_tpu_torch.model import thermodynamics as thermo_mod
from mitgcm_tpu_torch.model.mom_fluxform import check_branches, mom_fluxform
from mitgcm_tpu_torch.model.mom_vecinv import check_branches_vecinv, mom_vecinv
from mitgcm_tpu_torch.model.phihyd import calc_phi_hyd
from mitgcm_tpu_torch.ops import eos
from mitgcm_tpu_torch.ops.stencil import (cyclic_fill_halo, interior_mask,
                                          shift as sh)
from mitgcm_tpu_torch.solver import cg2d as cg2d_mod
from mitgcm_tpu_torch.solver import cg3d as cg3d_mod


@dataclass
class StepDiag:
    cg2d_init_res: torch.Tensor
    cg2d_last_res: torch.Tensor
    cg2d_iters: int
    cg2d_host_syncs: int
    # the non-hydrostatic 3-D solve's (solve_for_pressure.F:340-355); None
    # on the hydrostatic paths
    cg3d_init_res: torch.Tensor = None
    cg3d_last_res: torch.Tensor = None
    cg3d_iters: int = None
    cg3d_host_syncs: int = None


_PACKAGES = ("usePP81", "useMY82", "useOPPS",
             "useSEAICE", "useEXF", "useOBCS", "usePTRACERS", "useRBCS",
             "useAIM", "useLand", "useThSIce", "useZONAL_FILT", "useOffLine",
             "useGCHEM", "useGMRedi", "useSHAP_FILT")


def _tracer_schemes_off(cfg: Config) -> dict:
    """The refusals of the tracer advection schemes: scheme 2 in both
    directions (kernel C), SOM (80 or 81, kernel H-SOM) with its vertical
    scheme unset or equal, with or without the multi-dimensional advection
    (SOM comes first in JAX), or under the multi-dimensional advection a
    horizontal scheme of gad.MULTIDIM_SCHEMES with a vertical scheme of
    gad.VERT_SCHEMES (kernels M, O and P), each other pair named (JAX runs
    SOM whatever the vertical scheme says; the port refuses that)."""
    off = {}
    for tr in ("temp", "salt"):
        h = getattr(cfg, f"{tr}AdvScheme")
        v = getattr(cfg, f"{tr}VertAdvScheme") or h
        multidim = (gad.is_multidim(cfg, h) and v in gad.VERT_SCHEMES)
        som = h in som_mod.SOM_SCHEMES and v == h
        if not ((h, v) == (2, 2) or multidim or som):
            off[f"{tr}AdvScheme={h}, {tr}VertAdvScheme={v}, "
                f"multiDimAdvection={cfg.multiDimAdvection}"] = True
    return off


def check_supported(cfg: Config, kpp=None, ggl90=None, impl: str = None,
                    op3=None) -> None:
    """Raise NotImplementedError unless cfg stays on the ported paths
    (Cartesian z-coordinates, a LINEAR, JMD95Z/P, UNESCO or MDJWF EOS,
    flux-form or vector-invariant momentum, AB-2 or AB-3, linear implicit
    free surface solved by cg2d, scheme-2 tracers or the schemes of the
    multi-dimensional advection or SOM, explicit or implicit vertical
    diffusion, KPP given as a model/kpp.py:KPP object without the options
    that check_kpp refuses, or GGL90 as a model/ggl90.py:GGL90 object without
    the options that check_ggl90 refuses, with Langmuir only under
    vector-invariant momentum, and with at most ggl90.MAX_NR levels, IDEMIX
    included, when its tensors are on the card and impl does not ask for
    the plain path; nonHydrostatic under flux-form momentum with op3, a
    solver/cg3d.py:CG3DOperator, and without the options that
    calc_gw.check_nh refuses)."""
    g9_kernel = ggl90 is not None and kernels.use_kernel(ggl90.klowC, impl)
    off = {
        "useKPP without a KPP object": cfg.useKPP and kpp is None,
        "useGGL90 without a GGL90 object": cfg.useGGL90 and ggl90 is None,
        "useKPP with useGGL90": cfg.useKPP and cfg.useGGL90,
        f"GGL90 with nr > {ggl90_mod.MAX_NR} on the kernel path":
            g9_kernel and cfg.nr > ggl90_mod.MAX_NR,
        # the Coriolis-Stokes force is a term of flux-form momentum (JAX
        # mom_fluxform.py:422-426), which kernel B does not have
        "useLANGMUIR under flux-form momentum": (
            ggl90 is not None and ggl90.p["useLANGMUIR"]
            and not cfg.vectorInvariantMomentum),
        "staggerTimeStep": cfg.staggerTimeStep,
        "nonlinFreeSurf>0": cfg.nonlinFreeSurf > 0,
        "exactConserv": cfg.exactConserv,
        "useRealFreshWaterFlux": cfg.useRealFreshWaterFlux,
        "convertFW2Salt=-1": cfg.convertFW2Salt == -1.0,
        "implicitFreeSurface=F": not cfg.implicitFreeSurface,
        "implicSurfPress!=1": cfg.implicSurfPress != 1.0,
        "implicDiv2Dflow!=1": cfg.implicDiv2Dflow != 1.0,
        "nonHydrostatic without a CG3DOperator": (cfg.nonHydrostatic
                                                  and op3 is None),
        "quasiHydrostatic": cfg.quasiHydrostatic,
        "p-coordinates": cfg.usingPCoords or not cfg.usingZCoords,
        "fluidIsAir": cfg.fluidIsAir,
        "non-Cartesian grid": (not cfg.usingCartesianGrid
                               or cfg.usingSphericalPolarGrid
                               or cfg.usingCurvilinearGrid
                               or cfg.nFaces != 1),
        f"eosType={cfg.eosType}": (cfg.eosType.upper() != "LINEAR"
                                   and cfg.eosType.upper()
                                   not in eos.NONLINEAR),
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
        **_tracer_schemes_off(cfg),
        "cg2dExactSums": cfg.cg2dExactSums,
        "custom forcing hooks": (cfg.custom_forcing_uv is not None
                                 or cfg.custom_forcing_t is not None),
        "packages": any(getattr(cfg, p) for p in _PACKAGES),
    }
    bad = [name for name, is_off in off.items() if is_off]
    if bad:
        raise NotImplementedError(
            f"not on the ported paths: {', '.join(bad)}")
    if kpp is not None:
        kpp_mod.check_kpp(kpp)
    if ggl90 is not None:
        ggl90_mod.check_ggl90(ggl90)
    if cfg.nonHydrostatic:
        calc_gw_mod.check_nh(cfg)
    if cfg.vectorInvariantMomentum:
        check_branches_vecinv(cfg)
    else:
        check_branches(cfg)


def adams_bashforth2(cfg: Config, g, gNm1, myIter: int):
    """AB-2 extrapolation (adams_bashforth2.F): (g_extrap, gNm1'), with
    abFac = 0 on the cold-start first step."""
    startAB = 1 if cfg.startFromPickup else 0
    abFac = 0.0 if (myIter == cfg.nIter0 and startAB == 0) else 0.5 + cfg.abEps
    return g + abFac * (g - gNm1), g


def adams_bashforth3(cfg: Config, g, gNm1, gNm2, myIter: int):
    """AB-3 extrapolation (adams_bashforth3.F): (g_extrap, gNm1', gNm2').
    gNm1 holds the last raw tendency, gNm2 the one before. Forward Euler on
    the cold-start step, AB-2-like (alph only) on the next, full AB-3
    after; a restart from a pickup holds both levels (startAB = 2) and
    starts with full AB-3. `levels` is the JAX package's count of the
    levels available, which a straight run and its restart reach by the
    same arithmetic."""
    startAB = 2 if cfg.startFromPickup else 0
    alph, beta = cfg.alph_AB, cfg.beta_AB
    levels = myIter - (cfg.nIter0 - startAB)
    first, second = levels == 0, levels == 1
    ab0 = 0.0 if first else alph + (0.0 if second else beta)
    ab1 = 0.0 if first else -alph - (0.0 if second else 2.0 * beta)
    ab2 = 0.0 if (first or second) else beta
    return g + (ab0 * g + ab1 * gNm1 + ab2 * gNm2), g, gNm1


def adams_bashforth(cfg: Config, g, gNm1, gNm2, myIter: int):
    """AB-3 when cfg.useAB3 (alph_AB set), else AB-2 with gNm2 passed
    through: (g_extrap, gNm1', gNm2')."""
    if cfg.useAB3:
        return adams_bashforth3(cfg, g, gNm1, gNm2, myIter)
    g_ext, gNm1_new = adams_bashforth2(cfg, g, gNm1, myIter)
    return g_ext, gNm1_new, gNm2


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
             rhoInSitu, myIter: int, impl: str = None, kpp_fields=None,
             ggl90_fields=None):
    """dynamics.F + timestep.F: (uStar, vStar, guNm1', gvNm1', guNm2',
    gvNm2', totPhiHyd, nh). kpp_fields: KPP.calc's output, whose viscosity
    is blended into kappaRU/RV (calc_viscosity.F), or None; ggl90_fields:
    GGL90.calc's viscArU/viscArV, added to kappaRU/RV, or None. nh: with
    nonHydrostatic, w* and the w-tendency history (dynamics.F:642-652,
    CALC_GW + TIMESTEP_WVEL; step.py:341-357 of the JAX package), else
    None."""
    u, v, w = state.uVel, state.vVel, state.wVel
    nr = cfg.nr
    kshape = (nr + 1,) + tuple(u.shape[1:])
    kappaRU = torch.full(kshape, cfg.viscAr, dtype=u.dtype, device=u.device)
    kappaRV = torch.full(kshape, cfg.viscAr, dtype=u.dtype, device=u.device)
    if kpp_fields is not None:
        kappaRU[:nr], kappaRV[:nr] = kpp_mod.visc_uv(
            cfg, grid, kpp_fields, kappaRU[:nr], kappaRV[:nr])
    if ggl90_fields is not None:
        # ggl90_calc_visc.F: KappaRU += GGL90viscArU - viscArNr
        kappaRU[:nr] += ggl90_fields["viscArU"] - cfg.viscAr
        kappaRV[:nr] += ggl90_fields["viscArV"] - cfg.viscAr
    _, dPhiHydX, dPhiHydY, totPhiHyd = calc_phi_hyd(cfg, grid, rhoInSitu)
    momentum = mom_vecinv if cfg.vectorInvariantMomentum else mom_fluxform
    tend = momentum(cfg, grid, u, v, w, kappaRU, kappaRV, impl=impl)
    guExt, gvExt = apply_forcing_uv(cfg, grid, forcing)
    gU = tend.gU - dPhiHydX + tend.guDiss + guExt
    gV = tend.gV - dPhiHydY + tend.gvDiss + gvExt
    gU_ab, guNm1, guNm2 = adams_bashforth(cfg, gU, state.guNm1, state.guNm2,
                                          myIter)
    gV_ab, gvNm1, gvNm2 = adams_bashforth(cfg, gV, state.gvNm1, state.gvNm2,
                                          myIter)
    uStar = u + cfg.deltaTMom * gU_ab * grid.maskW
    vStar = v + cfg.deltaTMom * gV_ab * grid.maskS
    if cfg.implicitViscosity:
        uStar = thermo_mod.impldiff(cfg, grid, uStar, kappaRU,
                                    grid.recip_hFacW, cfg.deltaTMom,
                                    impl=impl)
        vStar = thermo_mod.impldiff(cfg, grid, vStar, kappaRV,
                                    grid.recip_hFacS, cfg.deltaTMom,
                                    impl=impl)
    nh = None
    if cfg.nonHydrostatic:
        gW, gwDiss = calc_gw_mod.calc_gw(cfg, grid, u, v, w, kappaRU,
                                         kappaRV, impl=impl)
        gw_ab, gwNm1, gwNm2 = adams_bashforth(cfg, gW + gwDiss, state.gwNm1,
                                              state.gwNm2, myIter)
        nh = {"wStar": calc_gw_mod.timestep_wvel(cfg, grid, w, gw_ab),
              "gwNm1": gwNm1, "gwNm2": gwNm2}
    return uStar, vStar, guNm1, gvNm1, guNm2, gvNm2, totPhiHyd, nh


def solve_for_pressure(cfg: Config, grid: Grid, op, state: State, uStar,
                       vStar, impl: str = None, nh=None, op3=None):
    """solve_for_pressure.F: cg2d for the new free surface, and with nh
    (dynamics' non-hydrostatic output) the cg3d solve for phi_nh
    (pre_cg3d.F, step.py:418-506 of the JAX package). Returns (etaN,
    phi_nh or None, StepDiag)."""
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
    surfC = (cfg.freeSurfFac * grid.rA / cfg.deltaTMom / cfg.deltaTFreeSurf)
    if nh is None:
        cg2d_b = cg2d_b - surfC * state.etaN
    else:
        # oldFreeSurfTerm (solve_for_pressure.F:195-210): the surface term
        # carries etaN + phi_nh(ks)/Bo, added to both right sides
        k3 = torch.arange(cfg.nr, device=uStar.device)[:, None, None]
        selS = (k3 == grid.kSurfC[None] - 1) & (grid.kSurfC[None] <= cfg.nr)
        zero = torch.zeros((), dtype=uStar.dtype, device=uStar.device)
        surfT = -surfC * (state.etaN + torch.sum(
            torch.where(selS, state.phi_nh, zero), dim=0) * grid.recip_Bo)
        cg2d_b = cg2d_b + surfT
        cg3d_b = dbx + dby + torch.where(selS, surfT[None], zero)
    cg2d_b = cg2d_b * imask
    res = cg2d_mod.cg2d(cfg, op, cg2d_b, cg2d_x, impl=impl)
    etaN = grid.recip_Bo * res.x
    diag = StepDiag(
        cg2d_init_res=res.first_residual, cg2d_last_res=res.last_residual,
        cg2d_iters=res.n_iters, cg2d_host_syncs=res.host_syncs)
    if nh is None:
        return etaN, None, diag

    # pre_cg3d.F, oldFreeSurfTerm: the surface-pressure correction flow of
    # the new cg2d solution and the vertical transport of w*
    cg2dx = res.x
    psFac = cfg.implicSurfPress * cfg.implicDiv2Dflow
    uf = -grid.recip_dxC * psFac * (cg2dx - sh(cg2dx, di=-1))
    vf = -grid.recip_dyC * psFac * (cg2dx - sh(cg2dx, dj=-1))
    fx = drF * grid.dyG[None] * grid.hFacW * uf[None]
    fy = drF * grid.dxG[None] * grid.hFacS * vf[None]
    wk = nh["wStar"]
    wkp1 = torch.cat([wk[1:], torch.zeros_like(wk[:1])])
    maskC_km1 = torch.cat([torch.ones_like(grid.maskC[:1]),
                           grid.maskC[:-1]])
    wterm = torch.where(
        k3 == 0, cfg.freeSurfFac * etaN[None] / cfg.deltaTFreeSurf - wkp1,
        wk * maskC_km1 - wkp1) * grid.rA[None] / cfg.deltaTMom
    cg3d_b = cg3d_b + (sh(fx, di=1) - fx)
    cg3d_b = cg3d_b + (sh(fy, dj=1) - fy)
    cg3d_b = cg3d_b + wterm
    res3 = cg3d_mod.cg3d(cfg, grid, op3, cg3d_b, state.phi_nh, impl=impl)
    diag.cg3d_init_res = res3.first_residual
    diag.cg3d_last_res = res3.last_residual
    diag.cg3d_iters = res3.n_iters
    diag.cg3d_host_syncs = res3.host_syncs
    return etaN, res3.x, diag


def momentum_correction_step(cfg: Config, grid: Grid, etaN, uStar, vStar,
                             phi_nh=None):
    """momentum_correction_step.F: subtract the new surface-pressure
    gradient, and with phi_nh the non-hydrostatic one
    (correction_step.F:137-160)."""
    BoEta = grid.Bo_surf * etaN
    phiSurfX = grid.recip_dxC * (BoEta - sh(BoEta, di=-1))
    phiSurfY = grid.recip_dyC * (BoEta - sh(BoEta, dj=-1))
    psFac = cfg.implicSurfPress
    if phi_nh is None:
        u = (uStar - cfg.deltaTMom * psFac * phiSurfX * grid.maskW) \
            * grid.maskW
        v = (vStar - cfg.deltaTMom * psFac * phiSurfY * grid.maskS) \
            * grid.maskS
        return u, v
    nhFac = cfg.implicitNHPress
    dpx = (psFac * phiSurfX[None] + nhFac * grid.recip_dxC[None]
           * (phi_nh - sh(phi_nh, di=-1)))
    dpy = (psFac * phiSurfY[None] + nhFac * grid.recip_dyC[None]
           * (phi_nh - sh(phi_nh, dj=-1)))
    u = (uStar - cfg.deltaTMom * dpx * grid.maskW) * grid.maskW
    v = (vStar - cfg.deltaTMom * dpy * grid.maskS) * grid.maskS
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
                 forcing: Forcing, myIter: int, impl: str = None, kpp=None,
                 ggl90=None, op3=None) -> Tuple[State, StepDiag]:
    """One timestep; myIter is the start-of-step iteration number; kpp: a
    model/kpp.py:KPP object when useKPP; ggl90: a model/ggl90.py:GGL90
    object when useGGL90; op3: a solver/cg3d.py:CG3DOperator when
    nonHydrostatic."""
    check_supported(cfg, kpp, ggl90, impl, op3)

    def fill(a):
        return cyclic_fill_halo(a, cfg.oly, cfg.olx)

    forc = load_fields(forcing)
    # in-situ density from the start-of-step tracers (do_oceanic_phys.F)
    rhoInSitu = eos.find_rho(cfg, grid, state.theta, state.salt,
                             totPhiHyd=state.totPhiHyd,
                             impl=impl) * grid.maskC
    # KPP on the start-of-step state with this step's surface forcing
    # (do_oceanic_phys.F KPP_CALC; step.py:940-955 of the JAX package)
    kpp_fields = None
    if kpp is not None:
        sfT, sfS = thermo_mod.surface_forcing_ts(cfg, grid, state, forc)
        kpp_fields = kpp.calc(
            state.uVel, state.vVel, state.theta, state.salt,
            state.totPhiHyd, forc.fu * cfg.mass2rUnit,
            forc.fv * cfg.mass2rUnit, sfT, sfS, forc.Qsw,
            thermo_mod.tracer_kappa(cfg, grid, cfg.diffKrT),
            thermo_mod.tracer_kappa(cfg, grid, cfg.diffKrS), impl=impl)
    # GGL90 on the start-of-step state, with the vertical density gradient
    # (do_oceanic_phys.F GGL90_CALC; step.py:915-970 of the JAX package)
    # (with useLANGMUIR the JAX step also computes the Stokes drift, which
    # only flux-form momentum reads: check_supported refuses that pair)
    ggl90_fields = None
    tkeNew, idemixE = state.GGL90TKE, state.IDEMIX_E
    if ggl90 is not None:
        sigmaR = thermo_mod.calc_sigmaR(cfg, grid, rhoInSitu, state.theta,
                                        state.salt,
                                        totPhiHyd=state.totPhiHyd, impl=impl)
        tkeNew, viscU, viscV, diffKr, idemixE = ggl90.calc(
            state.uVel, state.vVel, state.GGL90TKE, sigmaR,
            forc.fu * cfg.mass2rUnit, forc.fv * cfg.mass2rUnit,
            idemix_E=state.IDEMIX_E, impl=impl)
        ggl90_fields = {"viscArU": viscU, "viscArV": viscV, "diffKr": diffKr}
    (theta, salt, gtNm1, gsNm1, gtNm2, gsNm2, somT,
     somS) = thermo_mod.thermodynamics(
        cfg, grid, state, forc, myIter, impl=impl, kpp_fields=kpp_fields,
        ggl90_fields=ggl90_fields)
    uStar, vStar, guNm1, gvNm1, guNm2, gvNm2, totPhiHyd, nh = dynamics(
        cfg, grid, state, forc, rhoInSitu, myIter, impl=impl,
        kpp_fields=kpp_fields, ggl90_fields=ggl90_fields)
    uStar, vStar = fill(uStar), fill(vStar)
    etaN, phi_nh, diag = solve_for_pressure(cfg, grid, op, state, uStar,
                                            vStar, impl=impl, nh=nh, op3=op3)
    u, v = momentum_correction_step(cfg, grid, etaN, uStar, vStar, phi_nh)
    u, v = fill(u), fill(v)
    w, PmEpR = integr_continuity(cfg, grid, u, v, forc.EmPmR)

    def fill_if(a, used):
        return fill(a) if used else a

    new_state = State(
        uVel=u, vVel=v, wVel=fill(w), theta=fill(theta), salt=fill(salt),
        etaN=fill(etaN), etaH=fill(state.etaH),
        dEtaHdt=fill(state.dEtaHdt), PmEpR=fill(PmEpR),
        guNm1=guNm1, gvNm1=gvNm1, gtNm1=gtNm1, gsNm1=gsNm1,
        guNm2=guNm2, gvNm2=gvNm2, gtNm2=gtNm2, gsNm2=gsNm2,
        totPhiHyd=totPhiHyd,
        GGL90TKE=fill_if(tkeNew, ggl90 is not None),
        IDEMIX_E=fill_if(idemixE, ggl90 is not None
                         and ggl90.p["useIDEMIX"]),
        # the SOM moments' exchange (do_fields_blocking_exchanges.F:79);
        # it also overwrites the non-finite first padded row and column
        somT=fill_if(somT, somT is not None and somT.numel() > 0),
        somS=fill_if(somS, somS is not None and somS.numel() > 0),
        # the non-hydrostatic pressure and w-tendency history (NH_VARS.h)
        phi_nh=state.phi_nh if nh is None else fill(phi_nh),
        gwNm1=state.gwNm1 if nh is None else nh["gwNm1"],
        gwNm2=state.gwNm2 if nh is None else nh["gwNm2"])
    return new_state, diag
