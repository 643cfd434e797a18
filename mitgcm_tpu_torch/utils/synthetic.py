"""Synthetic wind-driven gyre (mitgcm_tpu/utils/synthetic.py): file-free
configurations for the entry point, the card smoke run and the tests: the
gyre, the vi-gyre, the kpp-gyre, the ggl90-gyre and its variants, the
os7mp-gyre and the pqm-gyre (high-order advection), the idemix-gyre (IDEMIX
and Langmuir in GGL90), the som-gyre (second-order-moment tracers), the
ice-gyre (the kpp-gyre under a sea-ice cover), the thsice-gyre (the
ice-gyre's ocean and atmosphere under Winton's thermodynamic sea ice),
the gm- and
gm-bolus-gyre (the kpp-gyre with GM-Redi and a temperature front), and
the visc-gyre, visc-vi-gyre and st-vi-gyre (variable and biharmonic
viscosity, the strain-tension form, quadratic bottom drag), the pp81-,
my82- and opps-gyre (the kpp-gyre with PP81's or MY82's
Richardson-number mixing or OPPS plume convection in place of KPP), the
cd-gyre and cd-vi-gyre (the gyre and the vi-gyre under the CD scheme's
Coriolis) and the shap-gyre (the gyre with the Shapiro filter); and
the nh-convection box, a
rotating, surface-cooled non-hydrostatic convection box. The set-ups put
their tensors on the CUDA device unless device="cpu" is asked for, and take
an already built grid of the same configuration (`grid=`) to skip building
it again."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid, build_grid
from mitgcm_tpu_torch.core.state import init_state, zero_forcing
from mitgcm_tpu_torch.model.ggl90 import GGL90
from mitgcm_tpu_torch.model.gmredi import GMParams
from mitgcm_tpu_torch.model.kpp import DEFAULT_OPTIONS, KPP
from mitgcm_tpu_torch.model.opps import OPPS
from mitgcm_tpu_torch.model.seaice import SeaIce, params_from_namelists
from mitgcm_tpu_torch.model.shap_filt import ShapParams
from mitgcm_tpu_torch.model.step import integr_continuity
from mitgcm_tpu_torch.model import thsice as thsice_mod
from mitgcm_tpu_torch.model.vertmix import MY82, PP81
from mitgcm_tpu_torch.ops.stencil import cyclic_fill_halo, shift as sh
from mitgcm_tpu_torch.solver.cg2d import build_cg2d
from mitgcm_tpu_torch.solver.cg3d import build_cg3d


def gyre_config(nx=64, ny=64, nr=4, dx=20.0e3, depth=5000.0,
                deltaT=1200.0, n_steps=10, olx=2, oly=2, **extra) -> Config:
    """A wind-driven beta-plane gyre (tutorial_barotropic_gyre-like) of
    any size, with stratified T when nr > 1. `extra` sets further Config
    fields before finalize()."""
    kwargs = dict(
        nx=nx, ny=ny, nr=nr, olx=olx, oly=oly,
        viscAh=4.0e2, f0=1.0e-4, beta=1.0e-11,
        rhoConst=1000.0, gBaro=9.81,
        implicitFreeSurface=True, rigidLid=False,
        tempStepping=nr > 1, saltStepping=False,
        tempAdvection=True,
        usingCartesianGrid=True, usingSphericalPolarGrid=False,
        delX=tuple([dx] * nx), delY=tuple([dx] * ny),
        delR=tuple([depth / nr] * nr),
        xgOrigin=-dx, ygOrigin=-dx,
        nIter0=0, nTimeSteps=n_steps, deltaT=deltaT,
        cg2dTargetResidual=1.0e-7, cg2dMaxIters=1000,
        diffKhT=1.0e3, diffKrT=1.0e-5,
        tRef=tuple(np.linspace(24.0, 10.0, nr)),
    )
    return Config(**{**kwargs, **extra}).finalize()


def vi_gyre_config(nx=64, ny=64, nr=4, deltaT=1200.0, n_steps=10,
                   eosType="JMD95Z", **kw) -> Config:
    """The gyre as a realistic ocean run sets it up (the "vi-gyre"):
    vector-invariant momentum, implicit vertical viscosity (viscAr 1e-3)
    and diffusion, a nonlinear EOS with salt stepped from a sRef profile
    of 35 to 34.5, and AB-3 (alph_AB 0.5, beta_AB 5/12). finalize()
    derives useAB3 and selectP_inEOS_Zc (2 for MDJWF, 0 for JMD95Z)."""
    vi = dict(vectorInvariantMomentum=True, implicitViscosity=True,
              implicitDiffusion=True, viscAr=1.0e-3, eosType=eosType,
              saltStepping=True, sRef=tuple(np.linspace(35.0, 34.5, nr)),
              diffKhS=1.0e3, diffKrS=1.0e-5, alph_AB=0.5,
              beta_AB=5.0 / 12.0)
    return gyre_config(nx=nx, ny=ny, nr=nr, deltaT=deltaT, n_steps=n_steps,
                       **{**vi, **kw})


# the variable and biharmonic viscosity of visc_gyre_config and
# visc_vi_gyre_config: Smagorinsky's harmonic viscosity, Leith's harmonic
# and biharmonic ones on vorticity and divergence, capped by the grid
# limits (a share of the CFL limits L^2/(4 dt) and L^4/(32 dt)) and floored
# by the grid-Reynolds limits, in the ranges MITgcm's documentation gives
_VISC = dict(viscC2smag=2.2, viscC2leith=1.85, viscC2leithD=1.85,
             viscC4leith=2.0, viscC4leithD=2.0, viscAhGridMax=1.0,
             viscA4GridMax=0.8, viscAhReMax=10.0, viscA4ReMax=10.0)


def visc_gyre_config(nx=64, ny=64, nr=4, **kw) -> Config:
    """The gyre (flux-form momentum) with variable and biharmonic viscosity
    (_VISC) and quadratic bottom drag (bottomDragQuadratic 2.5e-3,
    selectBotDragQuadr 0), on halos of 4: the Leith viscosity's gradient of
    the vorticity reaches three cells from u (the "visc-gyre"). Set up by
    gyre_setup."""
    vs = dict(olx=4, oly=4, bottomDragQuadratic=2.5e-3,
              selectBotDragQuadr=0, **_VISC)
    return gyre_config(nx=nx, ny=ny, nr=nr, **{**vs, **kw})


def visc_vi_gyre_config(nx=64, ny=64, nr=4, **kw) -> Config:
    """The vi-gyre with the visc-gyre's viscosities under the full Leith
    form (useFullLeith), on halos of 4, selectBotDragQuadr 0 with no
    quadratic coefficient (the "visc-vi-gyre"). Set up by gyre_setup."""
    vs = dict(olx=4, oly=4, selectBotDragQuadr=0, useFullLeith=True,
              **_VISC)
    return vi_gyre_config(nx=nx, ny=ny, nr=nr, **{**vs, **kw})


def st_vi_gyre_config(nx=64, ny=64, nr=4, **kw) -> Config:
    """The vi-gyre with the strain-tension form of the harmonic
    dissipation (useStrainTensionVisc) and a Smagorinsky viscosity capped
    by the grid limit, no biharmonic viscosity, on halos of 4,
    selectBotDragQuadr 0 with no quadratic coefficient (the
    "st-vi-gyre"). Set up by gyre_setup."""
    st = dict(olx=4, oly=4, selectBotDragQuadr=0, useStrainTensionVisc=True,
              viscC2smag=2.2, viscAhGridMax=1.0)
    return vi_gyre_config(nx=nx, ny=ny, nr=nr, **{**st, **kw})


def kpp_gyre_config(nx=64, ny=64, nr=12, depth=5000.0, stretch=1.15,
                    mld=60.0, **kw) -> Config:
    """The vi-gyre with KPP boundary-layer mixing (the "kpp-gyre"): levels
    stretched as delR_k = depth * stretch^k / sum_j stretch^j (a 8.7 m top
    and a 660 m bottom layer at 32 levels and 5000 m), and a surface mixed
    layer: tRef 24 degC and sRef 35 at layer centres shallower than mld,
    falling linearly below it to 10 degC and 34.5 at the bottom layer's
    centre."""
    w = stretch ** np.arange(nr)
    delR = depth * w / w.sum()
    zc = np.cumsum(delR) - 0.5 * delR
    frac = np.clip((zc - mld) / (zc[-1] - mld), 0.0, 1.0)
    kpp = dict(useKPP=True, delR=tuple(delR),
               tRef=tuple(24.0 + (10.0 - 24.0) * frac),
               sRef=tuple(35.0 + (34.5 - 35.0) * frac))
    return vi_gyre_config(nx=nx, ny=ny, nr=nr, **{**kpp, **kw})


def ggl90_gyre_config(nx=64, ny=64, nr=12, depth=5000.0, stretch=1.15,
                      mld=60.0, **kw) -> Config:
    """The kpp-gyre with GGL90 TKE mixing in place of KPP and DST-3
    flux-limited tracer advection (scheme 33, the vertical schemes left to
    default to it) under the multi-dimensional advection (the "ggl90-gyre")."""
    g9 = dict(useKPP=False, useGGL90=True, tempAdvScheme=33,
              saltAdvScheme=33, multiDimAdvection=True)
    return kpp_gyre_config(nx=nx, ny=ny, nr=nr, depth=depth,
                           stretch=stretch, mld=mld, **{**g9, **kw})


def os7mp_gyre_config(nx=64, ny=64, nr=12, depth=5000.0, **kw) -> Config:
    """The ggl90-gyre with OS7MP tracers (scheme 7, the vertical schemes
    left to default to it) on halos of 4 (the "os7mp-gyre"): OS7MP's
    stencil reaches four cells upwind, and its flux kernels write the
    columns [4, nxp - 3) only. Set up by ggl90_gyre_setup."""
    o7 = dict(olx=4, oly=4, tempAdvScheme=7, saltAdvScheme=7)
    return ggl90_gyre_config(nx=nx, ny=ny, nr=nr, depth=depth,
                             **{**o7, **kw})


def pqm_gyre_config(nx=64, ny=64, nr=12, depth=5000.0, **kw) -> Config:
    """The ggl90-gyre with theta advected by monotone PPM (scheme 41) and
    salt by monotone PQM (scheme 51), the vertical schemes left to default
    to them, on halos of 4 (the "pqm-gyre"): PQM's flux band has a margin
    of 4. Set up by ggl90_gyre_setup."""
    pq = dict(olx=4, oly=4, tempAdvScheme=41, saltAdvScheme=51)
    return ggl90_gyre_config(nx=nx, ny=ny, nr=nr, depth=depth,
                             **{**pq, **kw})


def idemix_gyre_config(nx=64, ny=64, nr=12, depth=5000.0, **kw) -> Config:
    """The ggl90-gyre with GGL90's IDEMIX internal-wave energy and the
    Langmuir parameterization (the "idemix-gyre"): the GGL90 namelist
    settings ride in cfg.extra["ggl90"], which ggl90_gyre_setup reads, with
    the tidal (bottom) and wind (surface) energy-flux maps named after
    IDEMIX_MAPS."""
    g9 = {"useIDEMIX": True, "useLANGMUIR": True,
          "IDEMIX_tidal_file": "idemix_tidal",
          "IDEMIX_wind_file": "idemix_wind"}
    return ggl90_gyre_config(nx=nx, ny=ny, nr=nr, depth=depth,
                             **{"extra": {"ggl90": g9}, **kw})


def som_gyre_config(nx=64, ny=64, nr=12, depth=5000.0, **kw) -> Config:
    """The ggl90-gyre with second-order-moment tracers (the "som-gyre"):
    theta by Prather's limited scheme 81, salt by the unlimited 80, the
    vertical schemes left unset, as advect_xz and advect_xy run them. Set
    up by ggl90_gyre_setup."""
    sm = dict(tempAdvScheme=81, saltAdvScheme=80)
    return ggl90_gyre_config(nx=nx, ny=ny, nr=nr, depth=depth,
                             **{**sm, **kw})


def idemix_maps(cfg: Config, wet: np.ndarray, dtype, device) -> dict:
    """IDEMIX's energy-flux maps for the idemix-gyre, by file name, as
    halo-filled [nyp, nxp] fields in W/m2 (before init_idemix_forc's clip to
    [0, 1] and scaling): a tidal flux of 2.5-7.5 mW/m2 varying as
    cos(2 pi x / Lx) sin(pi y / Ly), and a wind flux of 1-3 mW/m2 falling
    from the south to the north, on the wet columns `wet` [ny, nx]."""
    x = (np.arange(cfg.nx) + 0.5) / cfg.nx
    y = (np.arange(cfg.ny)[:, None] + 0.5) / cfg.ny
    tidal = 5e-3 * (1.0 + 0.5 * np.cos(2.0 * np.pi * x) * np.sin(np.pi * y))
    wind = 2e-3 * (1.0 + 0.5 * np.cos(np.pi * y)) * np.ones_like(x)
    return {"idemix_tidal": _fill2(cfg, tidal * wet, dtype, device)[0],
            "idemix_wind": _fill2(cfg, wind * wet, dtype, device)[0]}


# The CD scheme's relaxation time of MITgcm's global_ocean.90x40x15 deck
# (tauCD = 321428 s, its data file, not part of this repository): at
# deltaT = 600 s the D-grid velocities keep rCD = 1 - 600 / 321428 of
# their own step each step. The default, tauCD = deltaTMom, would make
# rCD 0 and multiply the D-grid step away.
CD_SETTINGS = dict(useCDscheme=True, tauCD=321428.0)


def cd_gyre_config(nx=64, ny=64, nr=4, **kw) -> Config:
    """The gyre (flux-form momentum, LINEAR, AB-2) with the CD scheme's
    Coriolis (CD_SETTINGS; the "cd-gyre"). Set up by gyre_setup."""
    return gyre_config(nx=nx, ny=ny, nr=nr, **{**CD_SETTINGS, **kw})


def cd_vi_gyre_config(nx=64, ny=64, nr=4, **kw) -> Config:
    """The vi-gyre (vector-invariant momentum, implicit viscosity, AB-3,
    JMD95Z) with the CD scheme's Coriolis (CD_SETTINGS; the
    "cd-vi-gyre"). Set up by gyre_setup."""
    return vi_gyre_config(nx=nx, ny=ny, nr=nr, **{**CD_SETTINGS, **kw})


def shap_gyre_config(nx=64, ny=64, nr=4, shap=None, **kw) -> Config:
    """The gyre with the Shapiro filter (the "shap-gyre"): hs94's
    Shap_funct 2 and nShapUV 4 (tests/test_hs94.py), the velocities
    filtered after the momentum correction (shap_filt_uvStar=F), theta and
    salt 4 passes each (the third fills), index space for both, the taus
    the time steps; `shap` sets further ShapParams fields. Set up by
    gyre_setup."""
    cfg = gyre_config(nx=nx, ny=ny, nr=nr, useSHAP_FILT=True, **kw)
    cfg.shap = ShapParams(**{
        "Shap_funct": 2, "nShapUV": 4, "shap_filt_uvStar": False,
        "nShapT": 4, "nShapS": 4, "Shap_uvtau": cfg.deltaTMom,
        "Shap_Trtau": cfg.deltaTTracer, **(shap or {})})
    return cfg


def gyre_grid(cfg: Config, dtype: torch.dtype = torch.float32,
              device="cuda") -> Grid:
    """The gyres' grid: a flat bottom with walls on the edges."""
    nx, ny = cfg.nx, cfg.ny
    bathy = np.full((ny, nx), -sum(cfg.delR))
    bathy[0, :] = 0.0
    bathy[:, 0] = 0.0
    bathy[-1, :] = 0.0
    bathy[:, -1] = 0.0
    return build_grid(cfg, bathy=bathy, dtype=dtype, device=device)


def gyre_setup(cfg: Config, dtype: torch.dtype = torch.float32,
               device="cuda", grid: Grid = None):
    """(grid, state, forcing, op) with walls and a sinusoidal zonal wind."""
    nx, ny = cfg.nx, cfg.ny
    if grid is None:
        grid = gyre_grid(cfg, dtype=dtype, device=device)
    state = init_state(cfg, grid)
    forcing = zero_forcing(cfg, dtype, device)
    # zonal wind: tau = -0.1 cos(pi y / L)  (gendata.m of the reference deck)
    y = np.arange(ny) * cfg.delY[0]
    L = ny * cfg.delY[0]
    taux = -0.1 * np.cos(np.pi * (y[:, None] + 0.5 * cfg.delY[0]) / L)
    forcing.fu = _fill2(cfg, taux, dtype, device)
    return grid, state, forcing, build_cg2d(cfg, grid)


def _fill2(cfg: Config, a: np.ndarray, dtype, device) -> torch.Tensor:
    """An interior [ny, nx] field as a halo-filled [1, nyp, nxp] record (an
    interior [nr, ny, nx] field as a halo-filled [nr, nyp, nxp] one)."""
    a = a if a.ndim == 3 else a[None]
    out = np.zeros(a.shape[:1] + (cfg.ny + 2 * cfg.oly, cfg.nx + 2 * cfg.olx))
    out[:, cfg.oly:cfg.oly + cfg.ny, cfg.olx:cfg.olx + cfg.nx] = a
    return cyclic_fill_halo(torch.as_tensor(out, dtype=dtype, device=device),
                            cfg.oly, cfg.olx)


def _heat_forced_setup(cfg: Config, dtype, device, grid=None):
    """gyre_setup with a net upward heat flux Qnet = -200 cos(pi (j + 1/2)
    / ny) W/m2 (heating in the south, cooling in the north) and a shortwave
    Qsw = -100 W/m2 on wet points."""
    grid, state, forcing, op = gyre_setup(cfg, dtype=dtype, device=device,
                                          grid=grid)
    ol_y, ol_x = cfg.oly, cfg.olx
    wet = grid.maskC[0, ol_y:ol_y + cfg.ny, ol_x:ol_x + cfg.nx].cpu().numpy()
    j = np.arange(cfg.ny)[:, None]
    forcing.Qnet = _fill2(cfg, -200.0 * np.cos(np.pi * (j + 0.5) / cfg.ny)
                          * wet, dtype, device)
    forcing.Qsw = _fill2(cfg, -100.0 * wet, dtype, device)
    return grid, state, forcing, op


def kpp_gyre_setup(cfg: Config, dtype: torch.dtype = torch.float32,
                   device="cuda", grid: Grid = None):
    """(grid, state, forcing, op, kpp) of the kpp-gyre: the gyre's wind,
    the heat fluxes of `_heat_forced_setup`, and KPP with the KPP_PARM01
    defaults and the default KPP_OPTIONS.h (KPP_GHAT, KPP_SMOOTH_SHSQ,
    KPP_SMOOTH_DBLOC)."""
    grid, state, forcing, op = _heat_forced_setup(cfg, dtype, device, grid)
    return grid, state, forcing, op, KPP(cfg, grid, {},
                                         options=DEFAULT_OPTIONS)


def ggl90_gyre_setup(cfg: Config, dtype: torch.dtype = torch.float32,
                     device="cuda", grid: Grid = None):
    """(grid, state, forcing, op, ggl90) of the ggl90-gyre and its variants:
    the kpp-gyre's wind, Qnet and Qsw, GGL90 with mxlMaxFlag = 2, the
    settings of cfg.extra["ggl90"] and the other ggl90_readparms.F
    defaults, and the TKE at GGL90TKEmin; with useIDEMIX the energy fluxes
    of idemix_maps and IDEMIX_E = 0 (ggl90_init_varia.F)."""
    grid, state, forcing, op = _heat_forced_setup(cfg, dtype, device, grid)
    ggl90 = GGL90(cfg, grid, {"mxlMaxFlag": 2, **cfg.extra.get("ggl90", {})})
    state.GGL90TKE = ggl90.init_tke(dtype)
    if ggl90.p["useIDEMIX"]:
        ol_y, ol_x = cfg.oly, cfg.olx
        wet = grid.maskC[0, ol_y:ol_y + cfg.ny, ol_x:ol_x + cfg.nx]
        maps = idemix_maps(cfg, wet.cpu().numpy(), dtype, device)
        ggl90.init_idemix_forc(maps.__getitem__)
        state.IDEMIX_E = torch.zeros_like(state.GGL90TKE)
    return grid, state, forcing, op, ggl90


# The Richardson-number and plume paths: the kpp-gyre (vector-invariant
# momentum, JMD95Z, AB-3, 32 levels stretched by 1.15 at full size, the
# heat flux of _heat_forced_setup) with KPP off and one of PP81, MY82 or
# OPPS on. Their namelists (verification/vermix's input.pp81, input.my82
# and input.opps) are not part of this repository, so the packages run
# their documented defaults. Vertical viscosity and diffusion stay
# implicit, as the kpp-gyre has them: PP81's and MY82's viscosity reaches
# 1 m2/s, which on the 8.7 m top layer at deltaT = 600 s is
# 1 * 600 / 8.7^2 ~ 8, sixteen times the explicit limit of 1/2.
def pp81_gyre_config(nx=64, ny=64, nr=12, depth=5000.0, **kw) -> Config:
    """The kpp-gyre with PP81 (Pacanowski & Philander 1981) in place of
    KPP (the "pp81-gyre"): PP81_PARM01's defaults as pp81_readparms.F sets
    them (PPnRi 2, PPnu0 1e-2, PPalpha 5, PPviscMax 1 m2/s, RiLimit derived
    from them and viscAr, pp81_readparms.F:84-90). Implicit vertical
    viscosity and diffusion (see above). Set up by vertmix_gyre_setup."""
    return kpp_gyre_config(nx=nx, ny=ny, nr=nr, depth=depth,
                           **{"useKPP": False, "usePP81": True, **kw})


def my82_gyre_config(nx=64, ny=64, nr=12, depth=5000.0, **kw) -> Config:
    """The kpp-gyre with MY82 (Mellor & Yamada level 2.0) in place of KPP
    (the "my82-gyre"): MY_PARM01's defaults (MYviscMax and MYdiffMax 1
    m2/s, MYhblScale 0.1, RiMax 0.195) and my82_init_varia.F's constants.
    Implicit vertical viscosity and diffusion (see above). Set up by
    vertmix_gyre_setup."""
    return kpp_gyre_config(nx=nx, ny=ny, nr=nr, depth=depth,
                           **{"useKPP": False, "useMY82": True, **kw})


def opps_gyre_config(nx=64, ny=64, nr=12, depth=5000.0, **kw) -> Config:
    """The kpp-gyre with OPPS plume convection in place of KPP (the
    "opps-gyre"): OPPS_PARM01's defaults (opps_readparms.F: a 100 m plume
    launched at 0.03 m/s, STABILITY_THRESHOLD -1e-4, entrainment -0.05,
    FRACTIONAL_AREA 0.1, one adjustment iteration) with useGCMwVel off.
    The cooled north densifies its surface cells past the threshold from
    the second step, so plumes launch there and not in the heated south.
    Set up by opps_gyre_setup."""
    return kpp_gyre_config(nx=nx, ny=ny, nr=nr, depth=depth,
                           **{"useKPP": False, "useOPPS": True, **kw})


def vertmix_gyre_setup(cfg: Config, dtype: torch.dtype = torch.float32,
                       device="cuda", grid: Grid = None):
    """(grid, state, forcing, op, vmix) of the pp81- or my82-gyre: the
    kpp-gyre's wind, Qnet and Qsw, and PP81 or MY82 (as cfg asks) with its
    defaults."""
    grid, state, forcing, op = _heat_forced_setup(cfg, dtype, device, grid)
    scheme = PP81 if cfg.usePP81 else MY82
    return grid, state, forcing, op, scheme(cfg, grid)


def opps_gyre_setup(cfg: Config, dtype: torch.dtype = torch.float32,
                    device="cuda", grid: Grid = None):
    """(grid, state, forcing, op, opps) of the opps-gyre: the kpp-gyre's
    wind, Qnet and Qsw, and OPPS with its defaults."""
    grid, state, forcing, op = _heat_forced_setup(cfg, dtype, device, grid)
    return grid, state, forcing, op, OPPS(cfg, grid)


# the gm-gyre's GM-Redi settings: tutorial_global_oce_latlon's and
# global_ocean.90x40x15's kind (GM_background_K 1000 m2/s, isopycK left to
# default to it, the gkw91 taper with GM_maxSlope 1e-2), with GM_Kmin_horiz
# 100 m2/s, this configuration's own choice, so that the tapered Kux/Kvy
# reach their floor where the taper bites
GM_GYRE = GMParams(background_K=1000.0, taper_scheme="gkw91", maxSlope=1.0e-2,
                   Kmin_horiz=100.0)


def gm_gyre_config(nx=64, ny=64, nr=12, depth=5000.0, **kw) -> Config:
    """The kpp-gyre with GM-Redi in its skew-flux form (GM_AdvForm=F) and
    GM_NON_UNITY_DIAGONAL, the settings of GM_GYRE (the "gm-gyre"): KPP
    with GM, and Kwz in the implicit vertical solve, as lab_sea and
    global_ocean run them. Set up by gm_gyre_setup."""
    return kpp_gyre_config(nx=nx, ny=ny, nr=nr, depth=depth,
                           **{"useGMRedi": True, "gmredi": GM_GYRE, **kw})


def gm_bolus_gyre_config(nx=64, ny=64, nr=12, depth=5000.0, **kw) -> Config:
    """The gm-gyre in GM-Redi's advective (bolus) form with the dm95 taper
    (Scrit and Sd at their defaults), as tutorial_reentrant_channel runs
    them; isopycK stays at GM_background_K, so GM_ExtraDiag's Kuz and Kvz
    are on (the "gm-bolus-gyre"). Set up by gm_gyre_setup."""
    gm = dataclasses.replace(GM_GYRE, advForm=True, taper_scheme="dm95")
    return gm_gyre_config(nx=nx, ny=ny, nr=nr, depth=depth,
                          **{"gmredi": gm, **kw})


def front_theta(cfg: Config, dtype, device) -> torch.Tensor:
    """The gm-gyres' temperature front [nr, nyp, nxp] (halos filled): 2 degC
    warmer to the south of a line that meanders about the basin's middle
    latitude with an amplitude of a tenth of the basin's width and 4
    wavelengths across it, 2 (1 - tanh((y - y_front(x)) / 100 km)) / 2,
    decaying with depth as exp(z / 1000 m) at the layer centres."""
    Lx, Ly = cfg.nx * cfg.delX[0], cfg.ny * cfg.delY[0]
    x = (np.arange(cfg.nx) + 0.5) * cfg.delX[0]
    y = (np.arange(cfg.ny)[:, None] + 0.5) * cfg.delY[0]
    y_front = 0.5 * Ly + 0.1 * Lx * np.sin(2.0 * np.pi * 4.0 * x / Lx)
    delR = np.asarray(cfg.delR)
    zc = -(np.cumsum(delR) - 0.5 * delR)
    front = 0.5 * 2.0 * (1.0 - np.tanh((y - y_front) / 100.0e3))
    return _fill2(cfg, front[None] * np.exp(zc / 1000.0)[:, None, None],
                  dtype, device)


def gm_gyre_setup(cfg: Config, dtype: torch.dtype = torch.float32,
                  device="cuda", grid: Grid = None):
    """(grid, state, forcing, op, kpp) of the gm-gyre or the gm-bolus-gyre:
    the kpp-gyre's (kpp_gyre_setup) with front_theta added to theta on the
    wet cells, so that the isopycnals slope from the first step (salt stays
    at sRef): gentler than GM_maxSlope in the thermocline, far steeper in
    the mixed layer, so every branch of the taper is live."""
    grid, state, forcing, op, kpp = kpp_gyre_setup(cfg, dtype=dtype,
                                                   device=device, grid=grid)
    state.theta = (state.theta + front_theta(cfg, dtype, device)) \
        * grid.maskC
    return grid, state, forcing, op, kpp


def nh_convection_config(nx=1024, ny=1024, nr=50, dx=20.0, dz=20.0,
                         deltaT=60.0, n_steps=10, **extra) -> Config:
    """The nh-convection box: a rotating, surface-cooled, non-hydrostatic
    convection box of the tutorial_deep_convection kind (20 m cells), at
    any size; full size is 1024x1024x50, a 20 km box 1000 m deep. Periodic
    in x and y with a flat bottom; a LINEAR EOS (tAlpha 2e-4, sBeta 0) with
    theta alone stepped by scheme 2; flux-form momentum with free-slip
    sides and a no-slip bottom, AB-2; f0 = fPrime = 1e-4 (the rotation
    vector near 45 N, so that the 3-D Coriolis terms are not zero), beta
    = 0; isotropic explicit harmonic mixing viscAh = viscAr = diffKhT =
    diffKrT = 0.1 m2/s; cg3d to 1e-9 in at most 100 iterations, cg2d as
    the gyre's. `extra` sets further Config fields before finalize()."""
    kwargs = dict(
        viscAh=0.1, viscAr=0.1, diffKhT=0.1, diffKrT=0.1,
        f0=1.0e-4, beta=0.0, fPrime=1.0e-4,
        eosType="LINEAR", tAlpha=2.0e-4, sBeta=0.0, saltStepping=False,
        no_slip_sides=False, no_slip_bottom=True,
        nonHydrostatic=True, cg3dMaxIters=100, cg3dTargetResidual=1.0e-9,
        delR=tuple([dz] * nr), tRef=tuple([20.0] * nr),
        xgOrigin=0.0, ygOrigin=0.0,
    )
    return gyre_config(nx=nx, ny=ny, nr=nr, dx=dx, deltaT=deltaT,
                       n_steps=n_steps, **{**kwargs, **extra})


def nh_convection_setup(cfg: Config, dtype: torch.dtype = torch.float32,
                        device="cuda", seed: int = 0, grid: Grid = None):
    """(grid, state, forcing, op, op3) of the nh-convection box: Qnet =
    +800 W/m2 (cooling) inside a centred disc whose radius is a quarter of
    the domain's width, 0 outside, no wind; theta = 20 degC plus noise of
    amplitude 0.01 K, u and v noise of amplitude 0.01 m/s on wet faces
    (uniform, from numpy.random.default_rng(seed)), and w from continuity
    (initialise_varia.F)."""
    if grid is None:
        grid = build_grid(cfg, dtype=dtype, device=device)
    state = init_state(cfg, grid)
    rng = np.random.default_rng(seed)
    shape = (cfg.nr, cfg.ny, cfg.nx)

    def noise(amp):
        return _fill2(cfg, amp * rng.uniform(-1.0, 1.0, shape), dtype,
                      device)

    state.theta = (state.theta + noise(0.01)) * grid.maskC
    state.uVel = noise(0.01) * grid.maskW
    state.vVel = noise(0.01) * grid.maskS
    w, _ = integr_continuity(cfg, grid, state.uVel, state.vVel,
                             torch.zeros_like(state.etaN))
    state.wVel = cyclic_fill_halo(w, cfg.oly, cfg.olx)
    forcing = zero_forcing(cfg, dtype, device)
    x = (np.arange(cfg.nx) + 0.5) * cfg.delX[0]
    y = (np.arange(cfg.ny) + 0.5) * cfg.delY[0]
    L = cfg.nx * cfg.delX[0]
    r2 = (x[None, :] - 0.5 * L) ** 2 + (y[:, None] - 0.5 * cfg.ny
                                        * cfg.delY[0]) ** 2
    forcing.Qnet = _fill2(cfg, np.where(r2 <= (0.25 * L) ** 2, 800.0, 0.0),
                          dtype, device)
    return grid, state, forcing, build_cg2d(cfg, grid), build_cg3d(cfg, grid)


# the sea-ice settings of the ice-gyre beyond seaice_readparms.F's
# defaults, as lab_sea sets them (SEAICE_PARM01 keys)
ICE_GYRE_SEAICE = {"LSR_ERROR": 1.0e-4, "SEAICE_multDim": 7}


def ice_gyre_config(nx=64, ny=64, nr=12, depth=5000.0, **kw) -> Config:
    """The kpp-gyre made polar and covered by sea ice (the "ice-gyre"):
    tRef -1.8 degC in the 60 m mixed layer rising to +1.0 degC at the
    bottom, sRef 32.5 rising to 34.9 (stable under JMD95Z), and useSEAICE
    with the seaice_readparms.F defaults plus lab_sea's LSR_ERROR = 1e-4
    and SEAICE_multDim = 7 (ICE_GYRE_SEAICE; cfg.seaice holds the
    parameters). The LSR solves its lines per tile of tile x tile cells
    (SIZE.h sNx = sNy; 64 when nx is a multiple of 64 and at least 128,
    else half the width: 2 x 2 tiles), which is part of the answer: the
    zebra solve is tile-local."""
    tile = 64 if (nx % 64 == 0 and nx >= 128) else nx // 2
    ice = dict(useSEAICE=True, sNx=tile, sNy=tile, nSx=nx // tile,
               nSy=ny // tile, **_polar_profiles(nr, depth))
    cfg = kpp_gyre_config(nx=nx, ny=ny, nr=nr, depth=depth, **{**ice, **kw})
    cfg.seaice = params_from_namelists(cfg, ICE_GYRE_SEAICE)
    return cfg


def exact_gyre_config(nx=64, ny=64, nr=4, tile=None, **kw) -> Config:
    """The gyre (gyre_config) with cg2dExactSums: every dot product of the
    cg2d solve in MITgcm's order, each tile x tile tile of the interior
    summed serially and then the tiles' partials (SIZE.h sNx = sNy = tile:
    by default 64 when nx is a multiple of 64 and at least 128, else half
    the width), which makes the tile shape part of the answer (the
    "exact-gyre"). Synthetic: no deck of the repository sets the flag."""
    if tile is None:
        tile = 64 if (nx % 64 == 0 and nx >= 128) else nx // 2
    ex = dict(cg2dExactSums=True, sNx=tile, sNy=tile, nSx=nx // tile,
              nSy=ny // tile)
    return gyre_config(nx=nx, ny=ny, nr=nr, **{**ex, **kw})


# the sitr-ice-gyre's SEAICE_PARM03: lab_sea's two ice tracers, an age
# carried by HEFF and a 'one' carried by AREA (so that both of advdiff's
# and tracer_phys's branches run)
SITR_ICE_GYRE_SEAICE03 = {"sitrnuminuse": 2,
                          "sitrname(1)": "age", "sitrmate(1)": "HEFF",
                          "sitrname(2)": "one", "sitrmate(2)": "AREA"}
# the legacy-ice-gyre's sea-ice settings: lab_sea/input.hb87's legacy
# centred advection and its DIFF1 (tests/test_lab_sea_hb87.py:84) on the
# ice-gyre's LSR dynamics
LEGACY_ICE_GYRE_SEAICE = {**ICE_GYRE_SEAICE, "SEAICEadvScheme": 2,
                          "DIFF1": 4.0e-3}


def sitr_ice_gyre_config(nx=64, ny=64, nr=12, depth=5000.0, **kw) -> Config:
    """The ice-gyre (ice_gyre_config, LSR) carrying SITR_ICE_GYRE_SEAICE03's
    two ice tracers: 'age' with HEFF, 'one' with AREA (the
    "sitr-ice-gyre"). ice_gyre_setup starts 'one' at 1 and the age at 0
    (seaice_init_varia.F). Synthetic: lab_sea's deck is not in the
    repository."""
    cfg = ice_gyre_config(nx=nx, ny=ny, nr=nr, depth=depth, **kw)
    cfg.seaice = params_from_namelists(cfg, ICE_GYRE_SEAICE,
                                       SITR_ICE_GYRE_SEAICE03)
    return cfg


def legacy_ice_gyre_config(nx=64, ny=64, nr=12, depth=5000.0, **kw
                           ) -> Config:
    """The ice-gyre (ice_gyre_config, LSR) under LEGACY_ICE_GYRE_SEAICE:
    SEAICEadvScheme 2 (the legacy two-pass centred Heun advection of HEFF,
    AREA and HSNOW) with DIFF1 = 4e-3 harmonic and biharmonic diffusion,
    as lab_sea's input.hb87 sets them (the "legacy-ice-gyre").
    Synthetic: the deck is not in the repository."""
    cfg = ice_gyre_config(nx=nx, ny=ny, nr=nr, depth=depth, **kw)
    cfg.seaice = params_from_namelists(cfg, LEGACY_ICE_GYRE_SEAICE)
    return cfg


def _polar_profiles(nr: int, depth: float) -> dict:
    """The polar kpp-gyre's tRef and sRef: -1.8 degC and 32.5 in the 60 m
    mixed layer of the kpp-gyre's stretched levels, rising linearly to
    +1.0 degC and 34.9 at the bottom layer's centre."""
    w = 1.15 ** np.arange(nr)
    delR = depth * w / w.sum()
    zc = np.cumsum(delR) - 0.5 * delR
    frac = np.clip((zc - 60.0) / (zc[-1] - 60.0), 0.0, 1.0)
    return dict(tRef=tuple(-1.8 + 2.8 * frac), sRef=tuple(32.5 + 2.4 * frac))


def thsice_gyre_config(nx=64, ny=64, nr=12, depth=5000.0, **kw) -> Config:
    """The thsice-gyre: the ice-gyre's polar kpp-gyre (tRef -1.8 degC in
    the 60 m mixed layer rising to +1.0 degC at the bottom, sRef 32.5
    rising to 34.9) with useThSIce in place of useSEAICE. The thsice
    parameters are thsice_readparms.F's defaults, set up by
    thsice_gyre_setup (the Config holds no field for them)."""
    th = dict(useThSIce=True, **_polar_profiles(nr, depth))
    return kpp_gyre_config(nx=nx, ny=ny, nr=nr, depth=depth, **{**th, **kw})


# the evp-ice-gyre's sea-ice settings: lab_sea/input.hb87's dynamics
# (tests/test_lab_sea_hb87.py:82-83), adaptive EVP with 500 subcycles, EVP*
# and revised EVP (the defaults) and Hibler-Bryan stress coupling, on top of
# the ice-gyre's (its scheme-77 advection and 7 categories stay)
EVP_ICE_GYRE_SEAICE = {**ICE_GYRE_SEAICE, "SEAICEaEVPcoeff": 0.5,
                       "SEAICEnEVPstarSteps": 500,
                       "useHB87stressCoupling": True}


def evp_ice_gyre_config(nx=64, ny=64, nr=12, depth=5000.0, **kw) -> Config:
    """The ice-gyre (ice_gyre_config) with the adaptive-EVP dynamics and
    Hibler-Bryan stress coupling of EVP_ICE_GYRE_SEAICE in place of the
    LSR (the "evp-ice-gyre")."""
    cfg = ice_gyre_config(nx=nx, ny=ny, nr=nr, depth=depth, **kw)
    cfg.seaice = params_from_namelists(cfg, EVP_ICE_GYRE_SEAICE)
    return cfg


def ice_gyre_setup(cfg: Config, dtype: torch.dtype = torch.float32,
                   device="cuda", grid: Grid = None):
    """(grid, state, forcing, op, kpp, seaice) of the ice-gyre, or of the
    evp-ice-gyre (whose SeaIce carries cfg.seaice's EVP dynamics, the EVP
    stresses starting at zero) on its config: the kpp-gyre's wind and KPP; over open water Qnet = +150 W/m2 (cooling) and
    Qsw = -50 W/m2 on wet points; an atmosphere of atemp 253 K in the north
    rising linearly to 271 K in the south, aqh 5e-4 kg/kg, lwdown 220 and
    swdown 50 W/m2, precip 3e-9 m/s, runoff and evap 0, wspeed 6 m/s; and
    ice of AREA 0.95, HEFF 2 m and HSNOW 0.2 m on the wet cells of the
    northern two thirds, open water to the south, at rest, TICES 273 K."""
    grid, state, forcing, op, kpp = kpp_gyre_setup(cfg, dtype=dtype,
                                                   device=device, grid=grid)
    north, rec = _polar_atmosphere(cfg, grid, forcing, dtype, device)
    seaice = SeaIce(cfg, grid, cfg.seaice)
    ice = seaice.init_state()
    state.uIce, state.vIce = ice.uIce, ice.vIce
    state.siAREA = rec(0.95 * north)[0]
    state.siHEFF = rec(2.0 * north)[0]
    state.siHSNOW = rec(0.2 * north)[0]
    state.siHSALT, state.siTICES = ice.HSALT, ice.TICES
    state.SItracer, state.siSigma = ice.SItracer, ice.sigma
    return grid, state, forcing, op, kpp, seaice


def _polar_atmosphere(cfg: Config, grid: Grid, forcing, dtype, device):
    """The ice-gyre's surface forcing, set on `forcing`: over open water
    Qnet = +150 W/m2 (cooling) and Qsw = -50 W/m2 on wet points; atemp
    253 K in the north rising linearly to 271 K in the south, aqh 5e-4
    kg/kg, lwdown 220 and swdown 50 W/m2, precip 3e-9 m/s, runoff and
    evap 0, wspeed 6 m/s. Returns (the wet cells of the northern two
    thirds [ny, nx], rec: an interior field as a filled record)."""
    ol_y, ol_x = cfg.oly, cfg.olx
    wet = grid.maskC[0, ol_y:ol_y + cfg.ny, ol_x:ol_x + cfg.nx].cpu().numpy()
    j = np.arange(cfg.ny)[:, None]
    ones = np.ones((cfg.ny, cfg.nx))

    def rec(a):
        return _fill2(cfg, a * ones, dtype, device)

    forcing.Qnet = rec(150.0 * wet)
    forcing.Qsw = rec(-50.0 * wet)
    forcing.atemp = rec(271.0 + (253.0 - 271.0) * (j + 0.5) / cfg.ny)
    forcing.aqh = rec(5.0e-4)
    forcing.lwdown = rec(220.0)
    forcing.swdown = rec(50.0)
    forcing.precip = rec(3.0e-9)
    forcing.runoff = rec(0.0)
    forcing.evap = rec(0.0)
    forcing.wspeed = rec(6.0)
    return (j >= cfg.ny // 3) * wet, rec


def thsice_gyre_setup(cfg: Config, dtype: torch.dtype = torch.float32,
                      device="cuda", grid: Grid = None):
    """(grid, state, forcing, op, kpp, thsice) of the thsice-gyre: the
    ice-gyre's wind, KPP and atmosphere (_polar_atmosphere), a ThSIce at
    thsice_readparms.F's defaults (thSIce_deltaT the model's deltaT), and
    thsice ice on the wet cells of the northern two thirds: iceMask 0.95,
    hIce 2 m, hSnow 0.2 m, snow age 0, tSrf -10 degC, the layer
    temperatures 0 and the enthalpies of new ice at -1.70 degC
    (init_state); the southern third is open water below its freezing
    point, where new ice forms."""
    grid, state, forcing, op, kpp = kpp_gyre_setup(cfg, dtype=dtype,
                                                   device=device, grid=grid)
    north, rec = _polar_atmosphere(cfg, grid, forcing, dtype, device)
    thsice = thsice_mod.ThSIce(
        cfg, grid, thsice_mod.params_from_namelists(cfg, {}, {}))
    th = thsice.init_state(iceMask=rec(0.95 * north)[0],
                           iceH=rec(2.0 * north)[0],
                           snowH=rec(0.2 * north)[0],
                           tsrf=rec(-10.0 * north)[0])
    state = dataclasses.replace(state, **th)
    return grid, state, forcing, op, kpp, thsice



# ThsiceParams settings beside thsice_readparms.F's defaults under which
# thsice_inputs takes the rest of the step's branches: a daily step
# (sublimation that thins ice below hIceMin), and two surface iterations
# (cells that run every iteration of the Terrmax loop)
THSICE_VARIANTS = {"": {},
                   "daily": {"thSIce_deltaT": 86400.0,
                             "thSIce_dtTemp": 86400.0,
                             "ocean_deltaT": 86400.0},
                   "nitMaxTsf=2": {"nitMaxTsf": 2}}


def thsice_inputs(cfg: Config, grid: Grid, seed: int = 0):
    """Seeded inputs of one thsice step (model/thsice.py:ThSIce.step's
    arguments: th, forc, theta, salt, u and v at the surface level, hFacC
    there, Qnet, Qsw, EmPmR, saltFlux) on the grid's dtype and device,
    halo-filled, drawn from numpy.random.default_rng(seed) wide enough
    that the step takes every branch of solve4temp, calc_thickn and
    extend somewhere: a tenth of the cells open water (about half of it
    below its freezing point), ice of fraction 0.05 to 1 (a quarter of it
    0.1 to 0.12) from 1 mm to 11 m under 0 to 3 m of snow, air from 240 to
    290 K, dry to moist, calm to windy, and an ocean from 2 degC below to
    3 degC above its freezing point, moving at up to 1 m/s. Rows of the
    interior sweep the thickness of snow-free ice of fraction 0.105
    through the two rarest branches, by factors of 1.08 over 64 columns
    (again every 64), each row a fraction of a factor further on: under
    warm, moist, sunny air from 1 mm (rows 1 mod 4: top melt through both
    layers), under warm, dry, windy, sunny air over an ocean at its
    freezing point from 1 cm (rows 2 mod 4: thinned below hIceMin by
    sublimation alone). Some branches need a longer step or fewer surface
    iterations than the defaults give (THSICE_VARIANTS)."""
    dtype, device = grid.rA.dtype, grid.rA.device
    rng = np.random.default_rng(seed)
    shape = (cfg.ny, cfg.nx)

    def u(lo, hi):
        return rng.uniform(lo, hi, shape)

    ice = u(0.0, 1.0) > 0.1
    # a quarter of the ice near iceMaskMin, where lateral melt takes a
    # part of the energy only
    f = {"thIceMask": np.where(ice, np.where(u(0.0, 1.0) < 0.25,
                                             u(0.1, 0.12), u(0.05, 1.0)),
                               0.0),
         "thIceH": np.where(ice, np.exp(u(np.log(1.0e-3), np.log(11.0))),
                            0.0)}
    f["thSnowH"] = np.where(ice & (u(0.0, 1.0) > 0.25), u(0.0, 3.0), 0.0)
    f["thSnowAge"] = np.where(ice, u(0.0, 3.0e6), 0.0)
    f["thTsrf"] = np.where(ice, u(-30.0, 0.0), u(-2.0, 3.0))
    t1, t2 = u(-20.0, -0.1), u(-20.0, -0.1)
    forc = {"atemp": u(240.0, 290.0), "aqh": u(0.0, 4.0e-3),
            "lwdown": u(150.0, 350.0), "swdown": u(0.0, 400.0),
            "precip": u(0.0, 1.0e-7), "runoff": u(0.0, 1.0e-8),
            "wspeed": u(0.0, 15.0)}
    p = thsice_mod.params_from_namelists(cfg, {}, {})
    salt = u(30.0, 35.0)
    ocean = {"theta": -p.mu_Tf * salt + u(-2.0, 3.0), "salt": salt,
             "uVel": u(-1.0, 1.0), "vVel": u(-1.0, 1.0),
             "hFacC": u(0.2, 1.0), "Qnet": u(-200.0, 400.0),
             "Qsw": u(-300.0, 0.0), "EmPmR": u(-1.0e-7, 1.0e-7),
             "saltFlux": u(-1.0e-6, 1.0e-6)}
    i = np.arange(cfg.nx)
    for row, (h0, ratio), air in (
            (1, (1.0e-3, 1.08), {"atemp": 285.0, "aqh": 4.0e-3,
                                 "lwdown": 350.0, "swdown": 400.0,
                                 "wspeed": 15.0}),
            (2, (1.0e-2, 1.08), {"atemp": 285.0, "aqh": 0.0,
                                 "lwdown": 350.0, "swdown": 400.0,
                                 "wspeed": 15.0})):
        rows = np.arange(row, cfg.ny, 4)[:, None]
        f["thIceMask"][rows, i] = 0.105
        # each row of a sweep a fraction of a factor further on, the sweep
        # again every 64 columns
        f["thIceH"][rows, i] = h0 * ratio ** (i % 64 + rows / cfg.ny)
        f["thSnowH"][rows, i] = 0.0
        f["thTsrf"][rows, i] = -1.0
        t1[rows, i], t2[rows, i] = -1.0, -1.5
        for k, v in air.items():
            forc[k][rows, i] = v
        ocean["theta"][rows, i] = -p.mu_Tf * salt[rows, i]
    on = f["thIceMask"] > 0.0
    # layer enthalpies of ice at -20 to -0.1 degC (thsice_ini_vars.F)
    f["thTice1"], f["thTice2"] = np.where(on, t1, 0.0), np.where(on, t2, 0.0)
    f["thQice1"] = np.where(on, -p.cpWater * p.Tmlt1
                            + p.cpIce * (p.Tmlt1 - t1)
                            + p.Lfresh * (1.0 - p.Tmlt1 / t1), 0.0)
    f["thQice2"] = np.where(on, -p.cpIce * t2 + p.Lfresh, 0.0)

    def rec(a):
        return _fill2(cfg, a, dtype, device)[0]

    th = {k: rec(f[k]) for k in thsice_mod.TH_FIELDS}
    forcing = dataclasses.replace(zero_forcing(cfg, dtype, device),
                                  **{k: rec(v) for k, v in forc.items()})
    return (th, forcing, *(rec(ocean[k]) for k in (
        "theta", "salt", "uVel", "vVel", "hFacC", "Qnet", "Qsw", "EmPmR",
        "saltFlux")))

def evp_setup(seaice: SeaIce, AREA, massU, massV) -> dict:
    """SeaIce.evp's set-up for masses of the caller's own (a run of EVP
    apart from a step; the step takes it from kernel S1): sumNorm at Z
    points, areaW/areaS (seaice.py:1094-1112 of the JAX package) and the
    masks of the cells that carry ice mass, as S1's twin forms them."""
    if seaice.p.scaleSurfStress:
        areaW = 0.5 * (AREA + sh(AREA, di=-1))
        areaS = 0.5 * (AREA + sh(AREA, dj=-1))
    else:
        areaW, areaS = torch.ones_like(AREA), torch.ones_like(AREA)
    return {"sumNorm": seaice.sumNorm, "areaW": areaW, "areaS": areaS,
            "locMaskU": (massU != 0.0).to(massU.dtype),
            "locMaskV": (massV != 0.0).to(massV.dtype)}
