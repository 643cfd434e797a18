"""Vertical-momentum tendency of the non-hydrostatic path
(mitgcm_tpu/model/calc_gw.py; reference model/src/calc_gw.F and
timestep_wvel.F).

`calc_gw` runs kernel W (kernels/csrc/calc_gw.cu) for CUDA tensors and its
plain PyTorch twin `_calc_gw_plain` for CPU tensors or when impl="plain" is
asked for; both compute every padded cell, the halo cells with the JAX
code's zero-filled shifts, so they agree on whole arrays. The port runs the
z-coordinate, Boussinesq, shallow-atmosphere case only: there the JAX
code's factors rhoFac*, deepFac* and rVel2wUnit are exactly 1, and its
products with them are left out (a product with 1.0 is exact).
`check_nh` refuses the non-hydrostatic options off that path by name.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.ops.stencil import shift as sh

# the vertical axis points down the levels: r increases upward (calc_gw.F)
RK_SIGN = -1.0

# calls of calc_gw that ran the plain twin (a run on the card reads it to
# show that its kernel path never did)
plain_calls = 0


def check_nh(cfg: Config) -> None:
    """Raise NotImplementedError, naming each, for the non-hydrostatic
    options this path does not run: flux-form momentum only (the JAX
    package's mom_vecinv has no 3-D Coriolis term, and kernel V refuses
    free-slip sides), free-slip sides (JAX raises on the no-slip side drag
    of w), a fully implicit NH pressure, no NH free surface or metric
    terms, no biharmonic viscosity of w and no implicit internal gravity
    waves, in z-coordinates without the deep-atmosphere factors (the JAX
    grid holds no anelastic ones: its rhoFac* are 1)."""
    off = {
        "nonHydrostatic under vectorInvariantMomentum":
            cfg.vectorInvariantMomentum,
        "no_slip_sides under nonHydrostatic": cfg.no_slip_sides,
        f"selectNHfreeSurf={cfg.selectNHfreeSurf}": cfg.selectNHfreeSurf >= 1,
        "useNHMTerms": cfg.useNHMTerms,
        "viscA4W": cfg.viscA4W != 0.0,
        f"implicitNHPress={cfg.implicitNHPress}": cfg.implicitNHPress != 1.0,
        "implicitIntGravWave": cfg.implicitIntGravWave,
        "deepAtmosphere": cfg.deepAtmosphere,
        "nonHydrostatic in p-coordinates": (cfg.usingPCoords
                                            or not cfg.usingZCoords),
        "momAdvection=F": not cfg.momAdvection,
        "momViscosity=F": not cfg.momViscosity,
    }
    bad = [name for name, is_off in off.items() if is_off]
    if bad:
        raise NotImplementedError(
            f"non-hydrostatic options not ported: {', '.join(bad)}")


def _km1(a):
    """a[max(k-1, 0)] along the level axis."""
    return torch.cat([a[:1], a[:-1]])


def _kp1(a):
    """a[min(k+1, nr-1)] along the level axis."""
    return torch.cat([a[1:], a[-1:]])


# grid fields kernel W reads, in the order of kernels/csrc/calc_gw.cu:GwArgs
_GRID3 = ("maskC", "hFacW", "hFacS")
_GRID2 = ("dxG", "dyG", "recip_dxC", "recip_dyC", "rA", "recip_rA",
          "Ro_surf", "R_low", "rSurfW", "rLowW", "rSurfS", "rLowS",
          "fCoriCos", "angleCosC", "angleSinC")
_GRID1 = ("rC", "drF", "recip_drF")


def calc_gw(cfg: Config, grid: Grid, u, v, w, kappaRU, kappaRV,
            impl: str = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gW, gwDiss): the advective tendency of w with the 3-D Coriolis term
    (select3dCoriScheme >= 1), and its harmonic and vertical viscous
    dissipation, both 0 at k = 0 (calc_gw.py:29-166); kappaRU/RV:
    [nr+1, nyp, nxp] interface viscosities. No input may require grad:
    kernel W has no backward kernel."""
    check_nh(cfg)
    ins = dict(u=u, v=v, w=w, **{n: getattr(grid, n) for n in _GRID3},
               kappaRU=kappaRU, kappaRV=kappaRV,
               **{n: getattr(grid, n) for n in _GRID2 + _GRID1})
    grads = [n for n, t in ins.items() if t.requires_grad]
    if grads:
        raise ValueError(f"calc_gw (kernel W) has no backward kernel: "
                         f"{grads} require grad")
    if not kernels.use_kernel(w, impl):
        return _calc_gw_plain(cfg, grid, u, v, w, kappaRU, kappaRV)
    nr, nyp, nxp = w.shape
    gW, gwDiss = torch.empty_like(w), torch.empty_like(w)
    kernels.check_tensors(w.dtype, **ins, gW=gW, gwDiss=gwDiss)
    for name in ("u", "v", "w") + _GRID3 + ("gW", "gwDiss"):
        kernels.check_shape(name, {**ins, "gW": gW, "gwDiss": gwDiss}[name],
                            w.shape)
    for name in ("kappaRU", "kappaRV"):
        kernels.check_shape(name, ins[name], (nr + 1, nyp, nxp))
    for name in _GRID2:
        kernels.check_shape(name, ins[name], (nyp, nxp))
    for name in _GRID1:
        kernels.check_shape(name, ins[name], (nr,))
    table = [*ins.values(), gW, gwDiss]
    kernels.launch("calc_gw", w.dtype, kernels.pointer_table(table),
                   len(table), nr, nyp, nxp, int(cfg.select3dCoriScheme >= 1),
                   cfg.viscAhW, RK_SIGN, cfg.gravitySign)
    return gW, gwDiss


def _calc_gw_plain(cfg: Config, grid: Grid, u, v, w, kappaRU, kappaRV):
    """calc_gw.py:29-166 in its operation order, on whole padded arrays,
    without the products with the factors that are 1 here and without the
    biharmonic terms, which add exact zeros (viscA4W = 0)."""
    global plain_calls
    plain_calls += 1
    nr = cfg.nr
    dt, dev = w.dtype, w.device
    rkSign = RK_SIGN
    rC = grid.rC[:, None, None]
    rC_km1 = _km1(rC)
    maskC_km1 = _km1(grid.maskC)
    k3 = torch.arange(nr, device=dev)[:, None, None]
    mskM1 = (k3 != 0).to(dt)
    mskP1 = (k3 != nr - 1).to(dt)
    kGT1 = k3 >= 1
    zero = torch.zeros((), dtype=dt, device=dev)

    # interface-centred cell thicknesses (calc_gw.F:157-196)
    thickC = (torch.minimum(grid.Ro_surf[None], rC_km1)
              - torch.maximum(grid.R_low[None], rC))
    recip_rThickC = torch.where(
        (maskC_km1 == 0.0) | (grid.maskC == 0.0) | ~kGT1, zero,
        1.0 / torch.where(thickC == 0.0, torch.ones_like(thickC), thickC))
    rThickC_W = torch.clamp_min(
        torch.minimum(grid.rSurfW[None], rC_km1)
        - torch.maximum(grid.rLowW[None], rC), 0.0)
    rThickC_S = torch.clamp_min(
        torch.minimum(grid.rSurfS[None], rC_km1)
        - torch.maximum(grid.rLowS[None], rC), 0.0)
    xA = grid.dyG[None] * rThickC_W
    yA = grid.dxG[None] * rThickC_S
    recip_drF = grid.recip_drF[:, None, None]

    # horizontal harmonic fluxes (calc_gw.F:300-345)
    viscAh_W = torch.full_like(w, cfg.viscAhW)
    flx_EW = (-(viscAh_W + sh(viscAh_W, di=-1)) * 0.5
              * (w - sh(w, di=-1)) * grid.recip_dxC[None] * xA)
    flx_NS = (-(viscAh_W + sh(viscAh_W, dj=-1)) * 0.5
              * (w - sh(w, dj=-1)) * grid.recip_dyC[None] * yA)
    # vertical flux between k and k+1 (calc_gw.F:350-362)
    kU0, kU1 = kappaRU[:nr], kappaRU[1:nr + 1]
    kV0, kV1 = kappaRV[:nr], kappaRV[1:nr + 1]
    viscLoc = (kU0 + sh(kU0, di=1) + kU1 + sh(kU1, di=1)
               + kV0 + sh(kV0, dj=1) + kV1 + sh(kV1, dj=1)) * 0.125
    flx_Dn = (-viscLoc * (_kp1(w) * mskP1 - w) * rkSign * recip_drF
              * grid.rA[None])
    # the upper flux at k = 2 (1-based) (calc_gw.F:364-377)
    visc2 = (kU0 + sh(kU0, di=1) + kV0 + sh(kV0, dj=1)) * 0.25
    flxTop = (-visc2 * (w - _km1(w)) * rkSign * _km1(recip_drF)
              * grid.rA[None])
    flxDisUp = torch.where(k3 == 1, flxTop, _km1(flx_Dn))
    gwDiss = -((sh(flx_EW, di=1) - flx_EW)
               + (sh(flx_NS, dj=1) - flx_NS)
               + (flx_Dn - flxDisUp) * rkSign) \
        * grid.recip_rA[None] * recip_rThickC
    gwDiss = torch.where(kGT1, gwDiss, zero)

    # advection (calc_gw.F:400-470)
    drF = grid.drF[:, None, None]
    dhW = drF * grid.hFacW
    dhS = drF * grid.hFacS
    uTrans = ((_km1(dhW) * _km1(u) * mskM1 + dhW * u) * 0.5
              * grid.dyG[None])
    vTrans = ((_km1(dhS) * _km1(v) * mskM1 + dhS * v) * 0.5
              * grid.dxG[None])
    flx_EW = uTrans * (w + sh(w, di=-1)) * 0.5
    flx_NS = vTrans * (w + sh(w, dj=-1)) * 0.5
    WbarZ = 0.5 * (w + _kp1(w) * mskP1)
    rTrans = 0.5 * (w + _kp1(w) * mskP1) * grid.rA[None]
    flx_Dn = rTrans * WbarZ
    flxAdvUp = _km1(flx_Dn) * mskM1
    gW = -((sh(flx_EW, di=1) - flx_EW)
           + (sh(flx_NS, dj=1) - flx_NS)
           + (flx_Dn - flxAdvUp) * rkSign) \
        * grid.recip_rA[None] * recip_rThickC
    gW = torch.where(kGT1, gW, zero)

    if cfg.select3dCoriScheme >= 1:
        # mom_w_coriolis_nh.F: -gravitySign fCoriCos (cos ubar - sin vbar)
        u1, v1 = _km1(u), _km1(v)
        ubar = 0.25 * ((u1 + sh(u1, di=1)) * mskM1 + (u + sh(u, di=1)))
        vbar = 0.25 * ((v1 + sh(v1, dj=1)) * mskM1 + (v + sh(v, dj=1)))
        wCori = (-cfg.gravitySign * grid.fCoriCos[None]
                 * (grid.angleCosC[None] * ubar
                    - grid.angleSinC[None] * vbar))
        gW = gW + torch.where(kGT1, wCori, zero)
    return gW, gwDiss


def timestep_wvel(cfg: Config, grid: Grid, w, gw_ab):
    """timestep_wvel.F: w* = w + deltaTMom gW_AB / nh_Am2, the tendency
    masked by the cell and the cell above (calc_gw.py:169-176)."""
    nh_fac = 1.0 / cfg.nh_Am2 if cfg.nh_Am2 != 0.0 else 0.0
    msk = grid.maskC * _km1(grid.maskC)
    return w + cfg.deltaTMom * nh_fac * gw_ab * msk
