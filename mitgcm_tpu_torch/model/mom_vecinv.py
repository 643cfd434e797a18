"""Vector-invariant momentum tendencies (mitgcm_tpu/model/mom_vecinv.py:
mom_vecinv, :210-451; reference pkg/mom_vecinv/mom_vecinv.F) on Cartesian
grids with constant harmonic viscosity:

  gU = planetary Coriolis (selectCoriScheme 0-1) + vorticity advection
       (selectVortScheme 0-2, None meaning 1) - w du/dz - grad KE
  guDiss = divergence/vorticity-form harmonic dissipation + the explicit
       vertical viscous flux (left out under implicitViscosity) + no-slip
       side drag + no-slip and linear bottom drag

`mom_vecinv` runs kernel V (kernels/csrc/mom_vecinv.cu) for CUDA tensors
and the plain PyTorch twin `_mom_vecinv_plain` for CPU tensors or when
impl="plain" is asked for. Kernel V has no backward kernel yet: the
wrapper raises if an input requires grad. The kernel writes zero halo
cells; the twin's halo cells are the JAX code's garbage-by-design values.
Both agree on the interior.
"""

from __future__ import annotations

import torch

from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model.mom_fluxform import (MomTend, calc_hfacz, calc_ke,
                                                 variable_viscosity)
from mitgcm_tpu_torch.ops.stencil import shift as sh
from mitgcm_tpu_torch.ops.stencil import shift_k

_EPS = 1.0e-9   # wet-point average guard of schemes 1 (mom_vi_*coriolis.F)


def check_branches_vecinv(cfg: Config) -> None:
    """Raise unless cfg selects exactly the branches ported here."""
    off = {
        "momAdvection=F": not cfg.momAdvection,
        "momViscosity=F": not cfg.momViscosity,
        "no_slip_sides=F": not cfg.no_slip_sides,
        "selectVortScheme": cfg.selectVortScheme not in (None, 0, 1, 2),
        "selectCoriScheme": cfg.selectCoriScheme not in (0, 1),
        "select3dCoriScheme": cfg.select3dCoriScheme != 0,
        "selectKEscheme": cfg.selectKEscheme != 0,
        "useAbsVorticity": cfg.useAbsVorticity,
        "upwindVorticity": cfg.upwindVorticity,
        "highOrderVorticity": cfg.highOrderVorticity,
        "useStrainTensionVisc": cfg.useStrainTensionVisc,
        "biharmonic viscosity (del2uv)": (cfg.viscA4 != 0.0
                                          or cfg.viscA4D != 0.0
                                          or cfg.viscA4Z != 0.0),
        "variable viscosity (mom_visc)": variable_viscosity(cfg),
        # the JAX constant-viscosity branch uses viscAh for both and
        # ignores these (a known fault of the reference): refuse them
        # rather than copy it silently
        "viscAhD!=viscAh": cfg.viscAhD != cfg.viscAh,
        "viscAhZ!=viscAh": cfg.viscAhZ != cfg.viscAh,
        "quadratic bottom drag": cfg.selectBotDragQuadr >= 0,
        "useCDscheme": cfg.useCDscheme,
        "rigidLid": cfg.rigidLid,
        "select_rStar": cfg.select_rStar != 0,
        "useNHMTerms": cfg.useNHMTerms,
        "non-Cartesian grid": (not cfg.usingCartesianGrid
                               or cfg.usingSphericalPolarGrid
                               or cfg.usingCurvilinearGrid
                               or cfg.nFaces != 1),
    }
    bad = [name for name, is_off in off.items() if is_off]
    if bad:
        raise NotImplementedError(
            f"mom_vecinv: branches not ported: {', '.join(bad)}")


def vort_scheme(cfg: Config) -> int:
    return 1 if cfg.selectVortScheme is None else cfg.selectVortScheme


def calc_relvort3(grid: Grid, u, v):
    """Relative vorticity at corner points (mom_calc_relvort3.F)."""
    vdyC = v * grid.dyC
    udxC = u * grid.dxC
    return grid.recip_rAz * (
        (vdyC - sh(vdyC, di=-1)) - (udxC - sh(udxC, dj=-1)))


def calc_hdiv(grid: Grid, u, v):
    """Horizontal divergence, hDivScheme 2 (mom_calc_hdiv.F)."""
    uT = u * grid.dyG * grid.hFacW
    vT = v * grid.dxG * grid.hFacS
    return ((sh(uT, di=1) - uT) + (sh(vT, dj=1) - vT)) \
        * grid.recip_rA * grid.recip_hFacC


def _vort_coriolis_u(grid: Grid, scheme: int, v, omega3, hFacZ, r_hFacZ):
    """mom_vi_u_coriolis.F: +<omega3 * vTrans>/dxC at U points."""
    vdxh = v * grid.dxG * grid.hFacS
    if scheme == 0:
        vBarXY = 0.25 * ((vdxh + sh(vdxh, di=-1))
                         + (sh(vdxh, dj=1) + sh(vdxh, di=-1, dj=1)))
        vort3u = 0.5 * (omega3 * r_hFacZ + sh(omega3 * r_hFacZ, dj=1))
        return vort3u * vBarXY * grid.recip_dxC * grid.maskW
    if scheme == 1:
        vdx = v * grid.dxG
        num = 0.5 * ((vdx * hFacZ + sh(vdx, di=-1) * hFacZ)
                     + (sh(vdx, dj=1) * sh(hFacZ, dj=1)
                        + sh(vdx, di=-1, dj=1) * sh(hFacZ, dj=1)))
        den = torch.clamp_min(hFacZ + sh(hFacZ, dj=1), _EPS)
        vort3u = 0.5 * (omega3 + sh(omega3, dj=1))
        return vort3u * (num / den) * grid.recip_dxC * grid.maskW
    vBarXm = 0.5 * (vdxh + sh(vdxh, di=-1))
    vBarXp = 0.5 * (sh(vdxh, dj=1) + sh(vdxh, di=-1, dj=1))
    vort3u = 0.5 * (vBarXm * r_hFacZ * omega3
                    + vBarXp * sh(r_hFacZ * omega3, dj=1))
    return vort3u * grid.recip_dxC * grid.maskW


def _vort_coriolis_v(grid: Grid, scheme: int, u, omega3, hFacZ, r_hFacZ):
    """mom_vi_v_coriolis.F: -<omega3 * uTrans>/dyC at V points."""
    udyh = u * grid.dyG * grid.hFacW
    if scheme == 0:
        uBarXY = 0.25 * ((udyh + sh(udyh, dj=-1))
                         + (sh(udyh, di=1) + sh(udyh, di=1, dj=-1)))
        vort3v = 0.5 * (omega3 * r_hFacZ + sh(omega3 * r_hFacZ, di=1))
        return -vort3v * uBarXY * grid.recip_dyC * grid.maskS
    if scheme == 1:
        udy = u * grid.dyG
        num = 0.5 * ((udy * hFacZ + sh(udy, dj=-1) * hFacZ)
                     + (sh(udy, di=1) * sh(hFacZ, di=1)
                        + sh(udy, di=1, dj=-1) * sh(hFacZ, di=1)))
        den = torch.clamp_min(hFacZ + sh(hFacZ, di=1), _EPS)
        vort3v = 0.5 * (omega3 + sh(omega3, di=1))
        return -vort3v * (num / den) * grid.recip_dyC * grid.maskS
    uBarYm = 0.5 * (udyh + sh(udyh, dj=-1))
    uBarYp = 0.5 * (sh(udyh, di=1) + sh(udyh, di=1, dj=-1))
    vort3v = 0.5 * (uBarYm * r_hFacZ * omega3
                    + uBarYp * sh(r_hFacZ * omega3, di=1))
    return -vort3v * grid.recip_dyC * grid.maskS


def _planetary_coriolis(cfg: Config, grid: Grid, u, v):
    """mom_vi_coriolis.F: f at vorticity points times the transports,
    selectCoriScheme 0 (plain average) or 1 (wet-point average)."""
    fG = grid.fCoriG
    vdx = v * grid.dxG
    udy = u * grid.dyG
    if cfg.selectCoriScheme == 0:
        vBarXY = 0.25 * ((vdx + sh(vdx, di=-1))
                         + (sh(vdx, dj=1) + sh(vdx, di=-1, dj=1)))
        uCf = (0.5 * (fG + sh(fG, dj=1)) * vBarXY
               * grid.recip_dxC * grid.maskW)
        uBarXY = 0.25 * ((udy + sh(udy, dj=-1))
                         + (sh(udy, di=1) + sh(udy, di=1, dj=-1)))
        vCf = (-0.5 * (fG + sh(fG, di=1)) * uBarXY
               * grid.recip_dyC * grid.maskS)
        return uCf, vCf
    vdxh = vdx * grid.hFacS
    udyh = udy * grid.hFacW
    hS, hW = grid.hFacS, grid.hFacW
    numU = ((vdxh + sh(vdxh, di=-1))
            + (sh(vdxh, dj=1) + sh(vdxh, di=-1, dj=1)))
    denU = torch.clamp_min((hS + sh(hS, di=-1))
                           + (sh(hS, dj=1) + sh(hS, di=-1, dj=1)), _EPS)
    uCf = (0.5 * (fG + sh(fG, dj=1)) * numU / denU
           * grid.recip_dxC * grid.maskW)
    numV = ((udyh + sh(udyh, dj=-1))
            + (sh(udyh, di=1) + sh(udyh, di=1, dj=-1)))
    denV = torch.clamp_min((hW + sh(hW, dj=-1))
                           + (sh(hW, di=1) + sh(hW, di=1, dj=-1)), _EPS)
    vCf = (-0.5 * (fG + sh(fG, di=1)) * numV / denV
           * grid.recip_dyC * grid.maskS)
    return uCf, vCf


def _mom_vecinv_plain(cfg: Config, grid: Grid, u, v, w, kappaRU,
                      kappaRV) -> MomTend:
    """mom_vecinv.py:210-451 on the ported branches, in its operation
    order. The side drag's biharmonic term, an exact `- 0 * 0` while
    biharmonic viscosity is refused, is left out."""
    nr = cfg.nr
    drF = grid.drF[:, None, None]
    recip_drF = grid.recip_drF[:, None, None]
    rkSign = cfg.rkSign
    hFacZ = calc_hfacz(grid)
    r_hFacZ = torch.where(hFacZ == 0.0, 0.0,
                          1.0 / torch.where(hFacZ == 0.0, 1.0, hFacZ))
    KE = calc_ke(u, v)
    vort3 = calc_relvort3(grid, u, v)
    vort3 = torch.where(hFacZ == 0.0, cfg.sideDragFactor * vort3, vort3)

    # harmonic dissipation in divergence/vorticity form (:293-308)
    hDiv = calc_hdiv(grid, u, v)
    AhD = AhZ = cfg.viscAh
    Z = hFacZ * vort3
    uD2 = (AhD * grid.cosFacU * (hDiv - sh(hDiv, di=-1)) * grid.recip_dxC
           - AhZ * grid.recip_hFacW * (sh(Z, dj=1) - Z) * grid.recip_dyG
           * grid.cosFacU)
    vD2 = (AhZ * grid.recip_hFacS * grid.cosFacV * (sh(Z, di=1) - Z)
           * grid.recip_dxG
           + AhD * (hDiv - sh(hDiv, dj=-1)) * grid.recip_dyC * grid.cosFacV)
    guDiss = uD2 * grid.maskW
    gvDiss = vD2 * grid.maskS

    # explicit vertical viscous flux (:323-340)
    if not cfg.implicitViscosity:
        recip_drC = grid.recip_drC[1:nr, None, None]
        rvU_mid = (-kappaRU[1:nr] * grid.rAw * (u[1:] - u[:-1]) * rkSign
                   * recip_drC * grid.maskW[1:] * grid.maskW[:-1])
        rvV_mid = (-kappaRV[1:nr] * grid.rAs * (v[1:] - v[:-1]) * rkSign
                   * recip_drC * grid.maskS[1:] * grid.maskS[:-1])
        z1 = torch.zeros_like(u[:1])
        rViscU = torch.cat([z1, rvU_mid, z1])
        rViscV = torch.cat([z1, rvV_mid, z1])
        guDiss = guDiss - (grid.recip_hFacW * recip_drF * grid.recip_rAw
                           * (rViscU[1:] - rViscU[:-1]) * rkSign)
        gvDiss = gvDiss - (grid.recip_hFacS * recip_drF * grid.recip_rAs
                           * (rViscV[1:] - rViscV[:-1]) * rkSign)

    # no-slip side drag (:342-371)
    Ahu = AhZ * u
    guDiss = guDiss - (
        grid.recip_hFacW * recip_drF * grid.recip_rAw
        * ((grid.hFacW - hFacZ) * grid.dxV * grid.recip_dyU * Ahu
           + (grid.hFacW - sh(hFacZ, dj=1)) * sh(grid.dxV, dj=1)
           * sh(grid.recip_dyU, dj=1) * Ahu)
        * drF * cfg.sideDragFactor) * grid.maskW
    Ahv = AhZ * v * grid.cosFacV
    gvDiss = gvDiss - (
        grid.recip_hFacS * recip_drF * grid.recip_rAs
        * ((grid.hFacS - hFacZ) * grid.dyU * grid.recip_dxV * Ahv
           + (grid.hFacS - sh(hFacZ, di=1)) * sh(grid.dyU, di=1)
           * sh(grid.recip_dxV, di=1) * Ahv)
        * drF * cfg.sideDragFactor) * grid.maskS

    # no-slip and linear bottom drag (:373-400)
    if cfg.no_slip_bottom or cfg.bottomDragLinear != 0.0:
        karr = torch.arange(nr, device=u.device)[:, None, None]
        cDragU = torch.full_like(u, cfg.bottomDragLinear)
        cDragV = torch.full_like(v, cfg.bottomDragLinear)
        if cfg.no_slip_bottom:
            recDr = torch.cat([grid.recip_drC[1:nr],
                               grid.recip_drF[nr - 1:nr]])[:, None, None]
            cDragU = cDragU + kappaRU[1:nr + 1] * recDr * 2.0
            cDragV = cDragV + kappaRV[1:nr + 1] * recDr * 2.0
        one = torch.ones_like(u[:1])
        bottomW = grid.maskW * torch.where(
            karr == nr - 1, 1.0, 1.0 - torch.cat([grid.maskW[1:], one]))
        bottomS = grid.maskS * torch.where(
            karr == nr - 1, 1.0, 1.0 - torch.cat([grid.maskS[1:], one]))
        guDiss = guDiss - cDragU * bottomW * u * grid.recip_hFacW * recip_drF
        gvDiss = gvDiss - cDragV * bottomS * v * grid.recip_hFacS * recip_drF

    # Coriolis + vorticity advection (:402-413)
    gU, gV = _planetary_coriolis(cfg, grid, u, v)
    vs = vort_scheme(cfg)
    gU = gU + _vort_coriolis_u(grid, vs, v, vort3, hFacZ, r_hFacZ)
    gV = gV + _vort_coriolis_v(grid, vs, u, vort3, hFacZ, r_hFacZ)

    # vertical shear -w du/dz (:415-441)
    karr = torch.arange(nr, device=u.device)[:, None, None]
    mask_km1 = torch.where(karr == 0, 0.0, 1.0).to(u.dtype)
    mask_kp1 = torch.where(karr == nr - 1, 0.0, 1.0).to(u.dtype)
    mC_km1 = shift_k(grid.maskC, -1)
    wrA = w * grid.rA
    wrA_kp1 = torch.cat([wrA[1:], torch.zeros_like(wrA[:1])])
    wBarXm = (0.5 * (wrA * mC_km1 + sh(wrA * mC_km1, di=-1))
              * mask_km1 * grid.recip_rAw)
    wBarXp = (0.5 * (wrA_kp1 + sh(wrA_kp1, di=-1))
              * mask_kp1 * grid.recip_rAw)
    u_kp1 = torch.cat([u[1:], torch.zeros_like(u[:1])])
    uZm = (u - mask_km1 * shift_k(u, -1)) * rkSign
    uZp = (mask_kp1 * u_kp1 - u) * rkSign
    gU = gU - 0.5 * (wBarXp * uZp + wBarXm * uZm) \
        * grid.recip_hFacW * recip_drF
    wBarYm = (0.5 * (wrA * mC_km1 + sh(wrA * mC_km1, dj=-1))
              * mask_km1 * grid.recip_rAs)
    wBarYp = (0.5 * (wrA_kp1 + sh(wrA_kp1, dj=-1))
              * mask_kp1 * grid.recip_rAs)
    v_kp1 = torch.cat([v[1:], torch.zeros_like(v[:1])])
    vZm = (v - mask_km1 * shift_k(v, -1)) * rkSign
    vZp = (mask_kp1 * v_kp1 - v) * rkSign
    gV = gV - 0.5 * (wBarYp * vZp + wBarYm * vZm) \
        * grid.recip_hFacS * recip_drF

    # -grad KE (:443-445)
    gU = gU - grid.recip_dxC * (KE - sh(KE, di=-1)) * grid.maskW
    gV = gV - grid.recip_dyC * (KE - sh(KE, dj=-1)) * grid.maskS
    return MomTend(gU=gU * grid.maskW, gV=gV * grid.maskS,
                   guDiss=guDiss * grid.maskW, gvDiss=gvDiss * grid.maskS)


# grid fields kernel V reads, in the order of
# kernels/csrc/mom_vecinv.cu:VecinvArgs
_GRID3 = ("hFacW", "hFacS", "maskC", "maskW", "maskS", "recip_hFacC",
          "recip_hFacW", "recip_hFacS")
_GRID2 = ("dxC", "dyC", "dxG", "dyG", "dxV", "dyU", "rA", "rAw", "rAs",
          "recip_dxC", "recip_dyC", "recip_dxG", "recip_dyG", "recip_rA",
          "recip_rAw", "recip_rAs", "recip_rAz", "recip_dxV", "recip_dyU",
          "cosFacU", "cosFacV", "fCoriG")
_GRID1 = ("drF", "recip_drF", "recip_drC")


def _kernel_inputs(grid: Grid, u, v, w, kappaRU, kappaRV) -> dict:
    return dict(u=u, v=v, w=w, **{n: getattr(grid, n) for n in _GRID3},
                kappaRU=kappaRU, kappaRV=kappaRV,
                **{n: getattr(grid, n) for n in _GRID2 + _GRID1})


def mom_vecinv(cfg: Config, grid: Grid, u, v, w, kappaRU, kappaRV,
               impl: str = None) -> MomTend:
    """gU/gV (Coriolis, vorticity, shear and KE terms) and guDiss/gvDiss
    (viscosity and drag), masked; kappaRU/kappaRV: [nr+1, nyp, nxp]
    interface viscosities."""
    check_branches_vecinv(cfg)
    ins = _kernel_inputs(grid, u, v, w, kappaRU, kappaRV)
    grads = [n for n, t in ins.items() if t.requires_grad]
    if grads:
        raise ValueError(f"mom_vecinv: {grads} require grad; kernel V has "
                         "no backward kernel yet")
    if not kernels.use_kernel(u, impl):
        return _mom_vecinv_plain(cfg, grid, u, v, w, kappaRU, kappaRV)
    nr, nyp, nxp = u.shape
    out = MomTend(*(torch.empty_like(u) for _ in range(4)))
    kernels.check_tensors(u.dtype, **ins, **out._asdict())
    for name in ("u", "v", "w") + _GRID3:
        kernels.check_shape(name, ins[name], u.shape)
    for name in ("kappaRU", "kappaRV"):
        kernels.check_shape(name, ins[name], (nr + 1, nyp, nxp))
    for name in _GRID2:
        kernels.check_shape(name, ins[name], (nyp, nxp))
    for name, n in (("drF", nr), ("recip_drF", nr), ("recip_drC", nr + 1)):
        kernels.check_shape(name, ins[name], (n,))
    table = [*ins.values(), *out]
    kernels.launch("mom_vecinv", u.dtype, kernels.pointer_table(table),
                   len(table), nr, nyp - 2 * cfg.oly, nxp - 2 * cfg.olx,
                   cfg.oly, cfg.olx, vort_scheme(cfg), cfg.selectCoriScheme,
                   int(cfg.implicitViscosity), int(cfg.no_slip_bottom),
                   cfg.viscAh, cfg.sideDragFactor, cfg.bottomDragLinear,
                   cfg.rkSign)
    return out
