"""Synthetic wind-driven gyre (mitgcm_tpu/utils/synthetic.py): file-free
configurations for the entry point, the card smoke run and the tests: the
gyre, the vi-gyre, the kpp-gyre, the ggl90-gyre and its variants, the
os7mp-gyre and the pqm-gyre (high-order advection), the idemix-gyre (IDEMIX
and Langmuir in GGL90), the som-gyre (second-order-moment tracers), the
ice-gyre (the kpp-gyre under a sea-ice cover) and the gm- and
gm-bolus-gyre (the kpp-gyre with GM-Redi and a temperature front); and
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
from mitgcm_tpu_torch.model.seaice import SeaIce, params_from_namelists
from mitgcm_tpu_torch.model.step import integr_continuity
from mitgcm_tpu_torch.ops.stencil import cyclic_fill_halo
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
    w = 1.15 ** np.arange(nr)
    delR = depth * w / w.sum()
    zc = np.cumsum(delR) - 0.5 * delR
    frac = np.clip((zc - 60.0) / (zc[-1] - 60.0), 0.0, 1.0)
    ice = dict(useSEAICE=True, sNx=tile, sNy=tile, nSx=nx // tile,
               nSy=ny // tile, tRef=tuple(-1.8 + 2.8 * frac),
               sRef=tuple(32.5 + 2.4 * frac))
    cfg = kpp_gyre_config(nx=nx, ny=ny, nr=nr, depth=depth, **{**ice, **kw})
    cfg.seaice = params_from_namelists(cfg, ICE_GYRE_SEAICE)
    return cfg


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
    seaice = SeaIce(cfg, grid, cfg.seaice)
    ice = seaice.init_state()
    north = (j >= cfg.ny // 3) * wet
    state.uIce, state.vIce = ice.uIce, ice.vIce
    state.siAREA = rec(0.95 * north)[0]
    state.siHEFF = rec(2.0 * north)[0]
    state.siHSNOW = rec(0.2 * north)[0]
    state.siHSALT, state.siTICES = ice.HSALT, ice.TICES
    state.SItracer, state.siSigma = ice.SItracer, ice.sigma
    return grid, state, forcing, op, kpp, seaice

