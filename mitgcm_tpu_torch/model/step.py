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
tracers), the nh-convection box (the non-hydrostatic path under
flux-form momentum: calc_gw and the AB step of w in DYNAMICS, the cg3d
solve for phi_nh after cg2d, and its gradient in the correction) and the
ice-gyre (the kpp-gyre under a sea-ice cover: model/seaice.py's step runs
after the forcing is loaded and before DO_OCEANIC_PHYS, and overwrites
fu, fv, Qnet, Qsw, EmPmR and saltFlux), the gm- and gm-bolus-gyre (the
kpp-gyre with GM-Redi in its skew-flux or advective form: model/gmredi.py's
tensor and bolus streamfunction from the start-of-step density, before
THERMODYNAMICS), and any mix of those options.
`check_supported` raises for every
configuration flag off them, so nothing the JAX step would do is silently
skipped. `impl` is passed to the kernel wrappers: None runs the CUDA
kernels on CUDA tensors and the plain PyTorch twins on CPU tensors;
"plain" runs the twins on any device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.core.state import Forcing, State
from mitgcm_tpu_torch.model import calc_gw as calc_gw_mod
from mitgcm_tpu_torch.model import gad
from mitgcm_tpu_torch.model.gad import _div
from mitgcm_tpu_torch.model import ggl90 as ggl90_mod
from mitgcm_tpu_torch.model import gmredi
from mitgcm_tpu_torch.model import kpp as kpp_mod
from mitgcm_tpu_torch.model import seaice as seaice_mod
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


# calls of the twins of kernels E and G in this module (cg2d_rhs,
# continuity, mom_ab_step, mom_correction), for the card's runs to show
# that the main path never ran them
plain_calls = 0


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
    # the sea ice's LSR: (ICOUNT1, ICOUNT2) and the host reads of each
    # Picard pass (seaice.py:1053-1055); None without sea ice
    lsr_iters: list = None
    lsr_host_syncs: list = None


_PACKAGES = ("usePP81", "useMY82", "useOPPS", "useEXF", "useOBCS",
             "usePTRACERS", "useRBCS",
             "useAIM", "useLand", "useThSIce", "useZONAL_FILT", "useOffLine",
             "useGCHEM", "useSHAP_FILT")


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
                    op3=None, seaice=None) -> None:
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
    calc_gw.check_nh refuses; useSEAICE with seaice, a model/seaice.py:
    SeaIce object, without the options that seaice.check_seaice refuses;
    useGMRedi without the settings that gmredi.check_gmredi refuses)."""
    g9_kernel = ggl90 is not None and kernels.use_kernel(ggl90.klowC, impl)
    off = {
        "useKPP without a KPP object": cfg.useKPP and kpp is None,
        "useGGL90 without a GGL90 object": cfg.useGGL90 and ggl90 is None,
        "useSEAICE without a SeaIce object": cfg.useSEAICE and seaice is None,
        "a SeaIce object without useSEAICE": (seaice is not None
                                              and not cfg.useSEAICE),
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
    if seaice is not None:
        seaice_mod.check_seaice(cfg, seaice)
    if cfg.useGMRedi:
        gmredi.check_gmredi(cfg)
    if cfg.vectorInvariantMomentum:
        check_branches_vecinv(cfg)
    else:
        check_branches(cfg)


def _ab2_fac(cfg: Config, myIter: int) -> float:
    """AB-2's abFac: 0 on the cold-start first step."""
    startAB = 1 if cfg.startFromPickup else 0
    return 0.0 if (myIter == cfg.nIter0 and startAB == 0) else 0.5 + cfg.abEps


def _ab3_coeffs(cfg: Config, myIter: int):
    """AB-3's (ab0, ab1, ab2). Forward Euler on the cold-start step,
    AB-2-like (alph only) on the next, full AB-3 after; a restart from a
    pickup holds both levels (startAB = 2) and starts with full AB-3.
    `levels` is the JAX package's count of the levels available, which a
    straight run and its restart reach by the same arithmetic."""
    startAB = 2 if cfg.startFromPickup else 0
    alph, beta = cfg.alph_AB, cfg.beta_AB
    levels = myIter - (cfg.nIter0 - startAB)
    first, second = levels == 0, levels == 1
    ab0 = 0.0 if first else alph + (0.0 if second else beta)
    ab1 = 0.0 if first else -alph - (0.0 if second else 2.0 * beta)
    ab2 = 0.0 if (first or second) else beta
    return ab0, ab1, ab2


def ab_params(cfg: Config, myIter: int, use_ab: bool = True) -> tuple:
    """The host numbers that kernel G takes for the extrapolation: (order,
    abFac, ab0, ab1, ab2), order 2 or 3, or 0 without AB (use_ab False)."""
    if not use_ab:
        return 0, 0.0, 0.0, 0.0, 0.0
    if cfg.useAB3:
        return (3, 0.0) + _ab3_coeffs(cfg, myIter)
    return 2, _ab2_fac(cfg, myIter), 0.0, 0.0, 0.0


def adams_bashforth2(cfg: Config, g, gNm1, myIter: int):
    """AB-2 extrapolation (adams_bashforth2.F): (g_extrap, gNm1'), with
    abFac = 0 on the cold-start first step (computed, not skipped, as JAX
    does)."""
    return g + _ab2_fac(cfg, myIter) * (g - gNm1), g


def adams_bashforth3(cfg: Config, g, gNm1, gNm2, myIter: int):
    """AB-3 extrapolation (adams_bashforth3.F): (g_extrap, gNm1', gNm2').
    gNm1 holds the last raw tendency, gNm2 the one before."""
    ab0, ab1, ab2 = _ab3_coeffs(cfg, myIter)
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
    return Forcing(**{k: None if v is None else v[0]
                      for k, v in forcing.__dict__.items()})


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


def _mom_ab_step_plain(cfg: Config, grid: Grid, myIter: int, gU, dPhiX,
                       guDiss, guExt, guNm1, guNm2, u, gV, dPhiY, gvDiss,
                       gvExt, gvNm1, gvNm2, v, gW=None, gwDiss=None,
                       gwNm1=None, gwNm2=None, w=None):
    """Kernel G's mom_ab_step twin (step.py:dynamics of the JAX package,
    :300-357): (gU, uStar, gV, vStar[, gW, wStar]), the raw tendencies
    (the next step's gNm1) and the predictors; w's with gW."""
    out = []
    for terms, gNm1, gNm2, x, mask in (
            ((gU, dPhiX, guDiss, guExt), guNm1, guNm2, u, grid.maskW),
            ((gV, dPhiY, gvDiss, gvExt), gvNm1, gvNm2, v, grid.maskS)):
        tend, dPhi, diss, ext = terms
        g = tend - dPhi + diss + ext
        g_ab = adams_bashforth(cfg, g, gNm1, gNm2, myIter)[0]
        out += [g, x + cfg.deltaTMom * g_ab * mask]
    if gW is not None:
        g = gW + gwDiss
        g_ab = adams_bashforth(cfg, g, gwNm1, gwNm2, myIter)[0]
        out += [g, calc_gw_mod.timestep_wvel(cfg, grid, w, g_ab)]
    return tuple(out)


# the inputs of mom_ab_step in its table's order, each component's mask
# after its velocity (step_glue.cu:MomAbArgs)
_MOM_AB_IN = ("gU", "dPhiHydX", "guDiss", "guExt", "guNm1", "guNm2", "u",
              "gV", "dPhiHydY", "gvDiss", "gvExt", "gvNm1", "gvNm2", "v",
              "gW", "gwDiss", "gwNm1", "gwNm2", "w")


def _mom_ab_step_kernel(cfg: Config, grid: Grid, myIter: int, *tensors):
    """Kernel G's mom_ab_step on the card (step_glue.cu)."""
    u = tensors[6]
    nh = len(tensors) > 14
    order, abFac, ab0, ab1, ab2 = ab_params(cfg, myIter)
    outs = tuple(torch.empty_like(u) for _ in range(6 if nh else 4))
    # the slots that the launch does not read (gNm2 under AB-2, w's on a
    # hydrostatic step) hold u
    ins = dict.fromkeys(_MOM_AB_IN, u)
    ins.update((n, t) for n, t in zip(_MOM_AB_IN, tensors) if t is not None)
    if order == 2:
        ins.update(guNm2=u, gvNm2=u, gwNm2=u)
    masks = dict(maskW=grid.maskW, maskS=grid.maskS,
                 **({"maskC": grid.maskC} if nh else {}))
    kernels.check_fields(u.dtype, u.shape, **ins, **masks,
                         **{f"out{k}": t for k, t in enumerate(outs)})
    vals = list(ins.values())
    table = (vals[:7] + [grid.maskW] + vals[7:14] + [grid.maskS]
             + vals[14:] + [grid.maskC] + list(outs) + [u] * (6 - len(outs)))
    nh_fac = 1.0 / cfg.nh_Am2 if cfg.nh_Am2 != 0.0 else 0.0
    kernels.launch("mom_ab_step", u.dtype, kernels.pointer_table(table),
                   len(table), *u.shape, order, int(nh), abFac, ab0, ab1,
                   ab2, cfg.deltaTMom, cfg.deltaTMom * nh_fac)
    return outs


def mom_ab_step(cfg: Config, grid: Grid, state: State, tend, dPhiHydX,
                dPhiHydY, guExt, gvExt, myIter: int, impl: str = None,
                gw=None):
    """The total momentum tendencies, their AB extrapolation and the
    predictors (dynamics.F + timestep.F): (uStar, vStar, guNm1', gvNm1',
    guNm2', gvNm2', nh). gw: with nonHydrostatic, calc_gw's (gW, gwDiss),
    and nh holds w* and the w-tendency history (dynamics.F:642-652,
    TIMESTEP_WVEL), else None. Kernel G's mom_ab_step on CUDA tensors, its
    twin on CPU tensors or with impl="plain"."""
    tensors = [tend.gU, dPhiHydX, tend.guDiss, guExt, state.guNm1,
               state.guNm2, state.uVel, tend.gV, dPhiHydY, tend.gvDiss,
               gvExt, state.gvNm1, state.gvNm2, state.vVel]
    if gw is not None:
        tensors += [*gw, state.gwNm1, state.gwNm2, state.wVel]

    def twin(*ts):
        return _mom_ab_step_plain(cfg, grid, myIter, *ts)

    if kernels.use_kernel(state.uVel, impl):
        outs = kernels.TwinVJP.apply(
            lambda *ts: _mom_ab_step_kernel(cfg, grid, myIter, *ts), twin,
            *tensors)
    else:
        global plain_calls
        plain_calls += 1
        outs = twin(*tensors)
    guNm1, uStar, gvNm1, vStar = outs[:4]
    # the level before: AB-3 shifts the raw history down, AB-2 keeps gNm2
    guNm2, gvNm2, gwNm2 = ((state.guNm1, state.gvNm1, state.gwNm1)
                           if cfg.useAB3 else
                           (state.guNm2, state.gvNm2, state.gwNm2))
    nh = None
    if gw is not None:
        nh = {"wStar": outs[5], "gwNm1": outs[4], "gwNm2": gwNm2}
    return uStar, vStar, guNm1, gvNm1, guNm2, gvNm2, nh


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
    _, dPhiHydX, dPhiHydY, totPhiHyd = calc_phi_hyd(cfg, grid, rhoInSitu,
                                                    impl=impl)
    momentum = mom_vecinv if cfg.vectorInvariantMomentum else mom_fluxform
    tend = momentum(cfg, grid, u, v, w, kappaRU, kappaRV, impl=impl)
    guExt, gvExt = apply_forcing_uv(cfg, grid, forcing)
    gw = None
    if cfg.nonHydrostatic:
        gw = calc_gw_mod.calc_gw(cfg, grid, u, v, w, kappaRU, kappaRV,
                                 impl=impl)
    uStar, vStar, guNm1, gvNm1, guNm2, gvNm2, nh = mom_ab_step(
        cfg, grid, state, tend, dPhiHydX, dPhiHydY, guExt, gvExt, myIter,
        impl=impl, gw=gw)
    if cfg.implicitViscosity:
        uStar = thermo_mod.impldiff(cfg, grid, uStar, kappaRU,
                                    grid.recip_hFacW, cfg.deltaTMom,
                                    impl=impl)
        vStar = thermo_mod.impldiff(cfg, grid, vStar, kappaRV,
                                    grid.recip_hFacS, cfg.deltaTMom,
                                    impl=impl)
    return uStar, vStar, guNm1, gvNm1, guNm2, gvNm2, totPhiHyd, nh


def _predicted_transport(cfg: Config, grid: Grid, uStar, vStar):
    """(pfx, pfy): the predicted transports over deltaTMom
    (calc_div_ghat.F), divided as tensors (model/gad.py:_div): one IEEE
    division on every device, as kernel E divides."""
    drF = grid.drF[:, None, None]
    xA = grid.dyG * drF * grid.hFacW
    yA = grid.dxG * drF * grid.hFacS
    pfx = _div(cfg.implicDiv2Dflow * xA * uStar, cfg.deltaTMom)
    pfy = _div(cfg.implicDiv2Dflow * yA * vStar, cfg.deltaTMom)
    return pfx, pfy


def _surf_c(cfg: Config, grid: Grid):
    """freeSurfFac * rA / deltaTMom / deltaTFreeSurf, divided as tensors."""
    return _div(_div(cfg.freeSurfFac * grid.rA, cfg.deltaTMom),
                cfg.deltaTFreeSurf)


def _cg2d_rhs_plain(cfg: Config, grid: Grid, uStar, vStar, etaN,
                    hydrostatic: bool):
    """Kernel E's cg2d_rhs twin: the divergence of the predicted transport
    summed level by level in the order k = Nr..1 (solve_for_pressure.F:
    146-152; a torch.sum over k would change the digits of this
    cancellation-prone sum). hydrostatic: (cg2d_b,), minus the surface
    term, masked to the interior; else (cg2d_b, div), div the divergence
    of each level, the first term of the cg3d right-hand side
    (step.py:421 of the JAX package)."""
    pfx, pfy = _predicted_transport(cfg, grid, uStar, vStar)
    dbx = sh(pfx, di=1) - pfx
    dby = sh(pfy, dj=1) - pfy
    cg2d_b = torch.zeros_like(etaN)
    for k in range(cfg.nr - 1, -1, -1):
        cg2d_b = cg2d_b + dbx[k]
        cg2d_b = cg2d_b + dby[k]
    if not hydrostatic:
        return cg2d_b, dbx + dby
    imask = interior_mask(etaN.shape, cfg.oly, cfg.olx, etaN.dtype,
                          etaN.device)
    return ((cg2d_b - _surf_c(cfg, grid) * etaN) * imask,)


def _cg2d_rhs_kernel(cfg: Config, grid: Grid, uStar, vStar, etaN,
                     hydrostatic: bool):
    """Kernel E's cg2d_rhs on the card (step_scans.cu), the twin's
    outputs."""
    out = torch.empty_like(etaN)
    # the hydrostatic launch writes no div: its slot holds out
    outs = (out,) if hydrostatic else (out, torch.empty_like(uStar))
    dtype = uStar.dtype
    kernels.check_fields(dtype, uStar.shape, uStar=uStar, vStar=vStar,
                         hFacW=grid.hFacW, hFacS=grid.hFacS, **(
                             {} if hydrostatic else {"div": outs[1]}))
    kernels.check_fields(dtype, etaN.shape, dyG=grid.dyG, dxG=grid.dxG,
                         rA=grid.rA, etaN=etaN, out=out)
    kernels.check_fields(dtype, (cfg.nr,), drF=grid.drF)
    table = [uStar, vStar, grid.hFacW, grid.hFacS, grid.dyG, grid.dxG,
             grid.rA, etaN, grid.drF, out, outs[-1]]
    kernels.launch("cg2d_rhs", dtype, kernels.pointer_table(table),
                   len(table), *uStar.shape, cfg.oly, cfg.olx,
                   int(hydrostatic), cfg.implicDiv2Dflow, cfg.deltaTMom,
                   cfg.freeSurfFac, cfg.deltaTFreeSurf)
    return outs


def cg2d_rhs(cfg: Config, grid: Grid, uStar, vStar, etaN,
             hydrostatic: bool = True, impl: str = None):
    """The cg2d right-hand side (solve_for_pressure.F:146-152): with
    hydrostatic (cg2d_b,), the whole of it; else (the transport divergence
    summed, each level's divergence): the non-hydrostatic caller adds
    pre_cg3d's surface term and the mask to the first and builds the cg3d
    right-hand side on the second. Kernel E's cg2d_rhs on CUDA tensors,
    its twin on CPU tensors or with impl="plain"."""
    if not kernels.use_kernel(uStar, impl):
        global plain_calls
        plain_calls += 1
        return _cg2d_rhs_plain(cfg, grid, uStar, vStar, etaN, hydrostatic)
    return kernels.TwinVJP.apply(
        lambda *ts: _cg2d_rhs_kernel(cfg, grid, *ts, hydrostatic),
        lambda *ts: _cg2d_rhs_plain(cfg, grid, *ts, hydrostatic),
        uStar, vStar, etaN)


def solve_for_pressure(cfg: Config, grid: Grid, op, state: State, uStar,
                       vStar, impl: str = None, nh=None, op3=None):
    """solve_for_pressure.F: cg2d for the new free surface, and with nh
    (dynamics' non-hydrostatic output) the cg3d solve for phi_nh
    (pre_cg3d.F, step.py:418-506 of the JAX package). Returns (etaN,
    phi_nh or None, StepDiag)."""
    cg2d_x = grid.Bo_surf * state.etaN
    cg2d_b, *div = cg2d_rhs(cfg, grid, uStar, vStar, state.etaN,
                            hydrostatic=nh is None, impl=impl)
    if nh is not None:
        # oldFreeSurfTerm (solve_for_pressure.F:195-210): the surface term
        # carries etaN + phi_nh(ks)/Bo, added to both right sides
        drF = grid.drF[:, None, None]
        k3 = torch.arange(cfg.nr, device=uStar.device)[:, None, None]
        selS = (k3 == grid.kSurfC[None] - 1) & (grid.kSurfC[None] <= cfg.nr)
        zero = torch.zeros((), dtype=uStar.dtype, device=uStar.device)
        surfT = -_surf_c(cfg, grid) * (state.etaN + torch.sum(
            torch.where(selS, state.phi_nh, zero), dim=0) * grid.recip_Bo)
        imask = interior_mask(state.etaN.shape, cfg.oly, cfg.olx,
                              uStar.dtype, uStar.device)
        cg2d_b = (cg2d_b + surfT) * imask
        cg3d_b = div[0] + torch.where(selS, surfT[None], zero)
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


def _mom_correction_plain(cfg: Config, grid: Grid, etaN, uStar, vStar,
                          phi_nh=None):
    """Kernel G's mom_correction twin: (u, v), momentum_correction_step.F
    with, given phi_nh, the non-hydrostatic gradient
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


def _mom_correction_kernel(cfg: Config, grid: Grid, etaN, uStar, vStar,
                           phi_nh=None):
    """Kernel G's mom_correction on the card (step_glue.cu)."""
    u, v = torch.empty_like(uStar), torch.empty_like(vStar)
    nh = phi_nh is not None
    ph = phi_nh if nh else uStar    # not read without the flag
    dtype = uStar.dtype
    kernels.check_fields(dtype, uStar.shape, uStar=uStar, vStar=vStar,
                         maskW=grid.maskW, maskS=grid.maskS, phi_nh=ph, u=u,
                         v=v)
    kernels.check_fields(dtype, etaN.shape, etaN=etaN, Bo_surf=grid.Bo_surf,
                         recip_dxC=grid.recip_dxC, recip_dyC=grid.recip_dyC)
    table = [uStar, vStar, grid.maskW, grid.maskS, ph, etaN, grid.Bo_surf,
             grid.recip_dxC, grid.recip_dyC, u, v]
    psFac = cfg.implicSurfPress
    kernels.launch("mom_correction", dtype, kernels.pointer_table(table),
                   len(table), *uStar.shape, int(nh), cfg.deltaTMom * psFac,
                   psFac, cfg.implicitNHPress, cfg.deltaTMom)
    return u, v


def momentum_correction_step(cfg: Config, grid: Grid, etaN, uStar, vStar,
                             phi_nh=None, impl: str = None):
    """momentum_correction_step.F: subtract the new surface-pressure
    gradient, and with phi_nh the non-hydrostatic one
    (correction_step.F:137-160). Kernel G's mom_correction on CUDA
    tensors, its twin on CPU tensors or with impl="plain"."""
    if not kernels.use_kernel(uStar, impl):
        global plain_calls
        plain_calls += 1
        return _mom_correction_plain(cfg, grid, etaN, uStar, vStar, phi_nh)
    return kernels.TwinVJP.apply(
        lambda *ts: _mom_correction_kernel(cfg, grid, *ts),
        lambda *ts: _mom_correction_plain(cfg, grid, *ts),
        etaN, uStar, vStar, phi_nh)


def _continuity_plain(cfg: Config, grid: Grid, u, v, EmPmR):
    """Kernel E's continuity twin: (wVel, PmEpR'), w integrated bottom-up
    level by level (integrate_for_w.F)."""
    drF = grid.drF[:, None, None]
    uTrans = u * grid.dyG * drF * grid.hFacW
    vTrans = v * grid.dxG * drF * grid.hFacS
    div2d = (sh(uTrans, di=1) - uTrans) + (sh(vTrans, dj=1) - vTrans)
    cr = -div2d * grid.recip_rA
    w = []
    w_below = torch.zeros_like(cr[0])
    for k in range(cfg.nr - 1, -1, -1):
        w_below = (w_below + cr[k]) * grid.maskC[k]
        w.append(w_below)
    return torch.stack(w[::-1]), -EmPmR


def _continuity_kernel(cfg: Config, grid: Grid, u, v, EmPmR):
    """Kernel E's continuity on the card (step_scans.cu)."""
    w, PmEpR = torch.empty_like(u), torch.empty_like(EmPmR)
    kernels.check_fields(u.dtype, u.shape, u=u, v=v, hFacW=grid.hFacW,
                         hFacS=grid.hFacS, maskC=grid.maskC, w=w)
    kernels.check_fields(u.dtype, EmPmR.shape, dyG=grid.dyG, dxG=grid.dxG,
                         recip_rA=grid.recip_rA, EmPmR=EmPmR, PmEpR=PmEpR)
    kernels.check_fields(u.dtype, (cfg.nr,), drF=grid.drF)
    table = [u, v, grid.hFacW, grid.hFacS, grid.maskC, grid.dyG, grid.dxG,
             grid.recip_rA, EmPmR, grid.drF, w, PmEpR]
    kernels.launch("continuity", u.dtype, kernels.pointer_table(table),
                   len(table), *u.shape)
    return w, PmEpR


def integr_continuity(cfg: Config, grid: Grid, u, v, EmPmR,
                      impl: str = None):
    """integr_continuity.F + integrate_for_w.F for the linear free surface:
    returns (wVel, PmEpR'). Kernel E's continuity on CUDA tensors, its twin
    on CPU tensors or with impl="plain"."""
    if not kernels.use_kernel(u, impl):
        global plain_calls
        plain_calls += 1
        return _continuity_plain(cfg, grid, u, v, EmPmR)
    return kernels.TwinVJP.apply(
        lambda *ts: _continuity_kernel(cfg, grid, *ts),
        lambda *ts: _continuity_plain(cfg, grid, *ts), u, v, EmPmR)


def forward_step(cfg: Config, grid: Grid, op, state: State,
                 forcing: Forcing, myIter: int, impl: str = None, kpp=None,
                 ggl90=None, op3=None, seaice=None
                 ) -> Tuple[State, StepDiag]:
    """One timestep; myIter is the start-of-step iteration number; kpp: a
    model/kpp.py:KPP object when useKPP; ggl90: a model/ggl90.py:GGL90
    object when useGGL90; op3: a solver/cg3d.py:CG3DOperator when
    nonHydrostatic; seaice: a model/seaice.py:SeaIce when useSEAICE."""
    check_supported(cfg, kpp, ggl90, impl, op3, seaice)

    def fill(a):
        return cyclic_fill_halo(a, cfg.oly, cfg.olx, impl=impl)

    forc = load_fields(forcing)
    # the sea ice (do_oceanic_phys.F:448 SEAICE_MODEL; step.py:783-822 of
    # the JAX package): the ice state steps on the surface level's
    # start-of-step ocean, and the ocean then sees its fluxes
    ice_diag = None
    if seaice is not None:
        ice = seaice_mod.IceState(
            uIce=state.uIce, vIce=state.vIce, AREA=state.siAREA,
            HEFF=state.siHEFF, HSNOW=state.siHSNOW, HSALT=state.siHSALT,
            TICES=state.siTICES, SItracer=state.SItracer,
            sigma=state.siSigma)
        ks = cfg.ksurf0
        ice, upd, ice_diag = seaice.step(
            ice, forc, state.uVel[ks], state.vVel[ks], state.etaN,
            state.theta[ks], state.salt[ks], forc.fu, forc.fv, impl=impl)
        forc = dataclasses.replace(forc, **upd)
        state = dataclasses.replace(
            state, uIce=ice.uIce, vIce=ice.vIce, siAREA=ice.AREA,
            siHEFF=ice.HEFF, siHSNOW=ice.HSNOW, siHSALT=ice.HSALT,
            siTICES=ice.TICES, siSigma=ice.sigma)
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
    # the vertical density gradient that GM-Redi and GGL90 share
    # (do_oceanic_phys.F:803-830; step.py:917-925 of the JAX package)
    sigmaR = None
    if cfg.useGMRedi or ggl90 is not None:
        sigmaR = thermo_mod.calc_sigmaR(cfg, grid, rhoInSitu, state.theta,
                                        state.salt,
                                        totPhiHyd=state.totPhiHyd, impl=impl)
    # the GM-Redi tensor and, in the advective form, the bolus
    # streamfunction with its halos filled (do_oceanic_phys.F:1039,
    # gmredi_do_exch.F; step.py:926-939 of the JAX package)
    gm = gm_psi = None
    if cfg.useGMRedi:
        gm = gmredi.gm_tensor(cfg, grid, cfg.gmredi, rhoInSitu, sigmaR,
                              impl=impl)
        if cfg.gmredi.advForm:
            psiX, psiY = gmredi.gm_psi_b(cfg, grid, cfg.gmredi, rhoInSitu,
                                         sigmaR, impl=impl)
            gm_psi = (fill(psiX), fill(psiY))
    # GGL90 on the start-of-step state, with the vertical density gradient
    # (do_oceanic_phys.F GGL90_CALC; step.py:915-970 of the JAX package)
    # (with useLANGMUIR the JAX step also computes the Stokes drift, which
    # only flux-form momentum reads: check_supported refuses that pair)
    ggl90_fields = None
    tkeNew, idemixE = state.GGL90TKE, state.IDEMIX_E
    if ggl90 is not None:
        tkeNew, viscU, viscV, diffKr, idemixE = ggl90.calc(
            state.uVel, state.vVel, state.GGL90TKE, sigmaR,
            forc.fu * cfg.mass2rUnit, forc.fv * cfg.mass2rUnit,
            idemix_E=state.IDEMIX_E, impl=impl)
        ggl90_fields = {"viscArU": viscU, "viscArV": viscV, "diffKr": diffKr}
    (theta, salt, gtNm1, gsNm1, gtNm2, gsNm2, somT,
     somS) = thermo_mod.thermodynamics(
        cfg, grid, state, forc, myIter, impl=impl, kpp_fields=kpp_fields,
        ggl90_fields=ggl90_fields, gm=gm, gm_psi=gm_psi)
    uStar, vStar, guNm1, gvNm1, guNm2, gvNm2, totPhiHyd, nh = dynamics(
        cfg, grid, state, forc, rhoInSitu, myIter, impl=impl,
        kpp_fields=kpp_fields, ggl90_fields=ggl90_fields)
    uStar, vStar = fill(uStar), fill(vStar)
    etaN, phi_nh, diag = solve_for_pressure(cfg, grid, op, state, uStar,
                                            vStar, impl=impl, nh=nh, op3=op3)
    u, v = momentum_correction_step(cfg, grid, etaN, uStar, vStar, phi_nh,
                                    impl=impl)
    u, v = fill(u), fill(v)
    w, PmEpR = integr_continuity(cfg, grid, u, v, forc.EmPmR, impl=impl)

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
        gwNm2=state.gwNm2 if nh is None else nh["gwNm2"],
        uIce=state.uIce, vIce=state.vIce, siAREA=state.siAREA,
        siHEFF=state.siHEFF, siHSNOW=state.siHSNOW, siHSALT=state.siHSALT,
        siTICES=state.siTICES, SItracer=state.SItracer,
        siSigma=state.siSigma)
    if ice_diag is not None:
        diag.lsr_iters = ice_diag["lsr_iters"]
        diag.lsr_host_syncs = ice_diag["lsr_host_syncs"]
    return new_state, diag
