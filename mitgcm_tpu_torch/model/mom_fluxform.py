"""Flux-form momentum tendencies (mitgcm_tpu/model/mom_fluxform.py;
reference pkg/mom_fluxform/mom_fluxform.F): centred advection, harmonic
viscosity with the explicit vertical viscous flux, and Coriolis scheme 0
(none under the CD scheme, model/cd_code.py);
with no-slip or free-slip sides (the side drag only under no-slip), and
with or without the 3-D Coriolis term -fPrime w of the non-hydrostatic
path (select3dCoriScheme >= 1). The gyre's constant harmonic viscosity
with no-slip bottom drag runs kernel B's first variants; grid-,
Smagorinsky- or Leith-scaled viscosity (model/mom_visc.py, kernel X),
biharmonic viscosity (`_del2uv`, kernel Y) and linear and quadratic bottom
drag, or none, run its dissipation variant (`uses_visc_variant`), which
reads X's and Y's fields. Its backward B' takes the gyre's variant only,
so the adjoint stays on the gyre's branches.

`mom_fluxform` runs kernel B (kernels/csrc/mom_fluxform.cu) for CUDA
tensors, with kernel B' (mom_fluxform_adj.cu) as its backward, and the
plain PyTorch twin `_mom_fluxform_plain`, differentiated by autograd, for
CPU tensors or when impl="plain" is asked for. The kernel writes zero
halo cells; the twin's halo cells are the JAX code's garbage-by-design
values. Both agree on the interior.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import mom_visc
from mitgcm_tpu_torch.ops.stencil import shift as sh
from mitgcm_tpu_torch.ops.stencil import shift_k


class MomTend(NamedTuple):
    gU: torch.Tensor
    gV: torch.Tensor
    guDiss: torch.Tensor
    gvDiss: torch.Tensor


def calc_hfacz(grid: Grid) -> torch.Tensor:
    """Vorticity-point open fraction (mom_calc_hfacz.F)."""
    hW, hS = grid.hFacW, grid.hFacS
    mW, mS = grid.maskW, grid.maskS
    openJ = torch.minimum(hW, sh(hW, dj=-1)) * mW * sh(mW, dj=-1)
    openI = torch.minimum(hS, sh(hS, di=-1)) * mS * sh(mS, di=-1)
    return torch.minimum(openI, openJ) * mW * sh(mW, dj=-1)


def calc_ke(u, v) -> torch.Tensor:
    """Kinetic energy at cell centers, selectKEscheme 0 (mom_calc_ke.F)."""
    u2, v2 = u * u, v * v
    return 0.25 * ((u2 + sh(u2, di=1)) + (v2 + sh(v2, dj=1)))


def uses_visc_variant(cfg: Config) -> bool:
    """Whether cfg runs kernel B's dissipation variant: variable or
    biharmonic viscosity, or a bottom drag other than the gyre's no-slip
    one (linear, quadratic, selectBotDragQuadr set, or none)."""
    return (mom_visc.use_variable_visc(cfg)
            or mom_visc.use_biharmonic_visc(cfg)
            or not cfg.no_slip_bottom or cfg.bottomDragLinear != 0.0
            or cfg.selectBotDragQuadr >= 0)


def check_branches(cfg: Config) -> None:
    """Raise unless cfg selects exactly the branches ported here; refuse
    by name what the JAX code drops silently (quadratic drag other than
    selectBotDragQuadr 0, mom_fluxform.py:360; useStrainTensionVisc, for
    which its flux form has no branch) or computes as a no-op
    (viscC2LeithQG)."""
    off = {
        "momAdvection": not cfg.momAdvection,
        "momViscosity": not cfg.momViscosity,
        "selectCoriScheme": cfg.selectCoriScheme != 0,
        "implicitViscosity": cfg.implicitViscosity,
        f"selectBotDragQuadr={cfg.selectBotDragQuadr}":
            cfg.selectBotDragQuadr not in (-1, 0),
        "useStrainTensionVisc under flux form": cfg.useStrainTensionVisc,
        **mom_visc.refusals(cfg),
        "rigidLid": cfg.rigidLid,
        "select_rStar": cfg.select_rStar != 0,
        "useNHMTerms": cfg.useNHMTerms,
        "spherical metric terms": cfg.usingSphericalPolarGrid,
    }
    bad = [name for name, is_off in off.items() if is_off]
    if bad:
        raise NotImplementedError(
            f"mom_fluxform: branches not ported: {', '.join(bad)}")


# grid fields kernels B and B' read, in the order of MomArgs
_GRID3 = ("hFacC", "hFacW", "hFacS", "maskC", "maskW", "maskS",
          "recip_hFacW", "recip_hFacS")
_GRID2 = ("dxF", "dyF", "dxG", "dyG", "dxV", "dyU", "rA", "rAw", "rAs",
          "recip_dxF", "recip_dyF", "recip_dxV", "recip_dyU", "recip_rAw",
          "recip_rAs", "cosFacU", "cosFacV", "fCori", "fCoriCos",
          "angleCosC")
_GRID1 = ("drF", "recip_drF", "recip_drC")


def _kernel_inputs(grid: Grid, u, v, w, kappaRU, kappaRV) -> dict:
    """Kernel B's inputs by name, in the order of
    kernels/csrc/mom_fluxform.cuh:MomArgs."""
    return dict(u=u, v=v, w=w, **{n: getattr(grid, n) for n in _GRID3},
                kappaRU=kappaRU, kappaRV=kappaRV,
                **{n: getattr(grid, n) for n in _GRID2 + _GRID1})


def flags(cfg: Config) -> tuple:
    """Kernel B's template flags: (no-slip sides, the 3-D Coriolis
    term)."""
    return bool(cfg.no_slip_sides), cfg.select3dCoriScheme >= 1


def coriolis_flags(cfg: Config) -> int:
    """Kernel B's Coriolis argument (mom_fluxform_tile.cuh): bit 0 the 3-D
    term, bit 1 the CD scheme's variant without the 2-D term."""
    return int(flags(cfg)[1]) | 2 * int(cfg.useCDscheme)


def _launch(kernel: str, cfg: Config, ins: dict, outs: dict,
            extra: tuple = ()) -> None:
    """Check and launch kernel B (outs = the four tendencies; its
    dissipation variant mom_fluxform_visc with `extra`, the arguments that
    follow B's) or B' (outs = the four cotangents, in the tendencies'
    slots, then u_bar, v_bar and w_bar; the gyre's flags only)."""
    u = ins["u"]
    nr, nyp, nxp = u.shape
    kernels.check_tensors(u.dtype, **ins, **outs)
    for name in ("u", "v", "w") + _GRID3 + tuple(outs):
        kernels.check_shape(name, {**ins, **outs}[name], u.shape)
    for name in ("kappaRU", "kappaRV"):
        kernels.check_shape(name, ins[name], (nr + 1, nyp, nxp))
    for name in _GRID2:
        kernels.check_shape(name, ins[name], (nyp, nxp))
    kernels.check_shape("drF", ins["drF"], (nr,))
    kernels.check_shape("recip_drF", ins["recip_drF"], (nr,))
    kernels.check_shape("recip_drC", ins["recip_drC"], (nr + 1,))
    table = [*ins.values(), *outs.values()]
    args = (nr, nyp - 2 * cfg.oly, nxp - 2 * cfg.olx, cfg.oly, cfg.olx)
    params = (cfg.viscAhD, cfg.viscAhZ, cfg.sideDragFactor, cfg.rkSign)
    if kernel in ("mom_fluxform", "mom_fluxform_visc"):
        args += (int(cfg.no_slip_sides), coriolis_flags(cfg))
        params += (cfg.gravitySign,)
    elif flags(cfg) != (True, False) or cfg.useCDscheme:
        raise NotImplementedError(
            "mom_fluxform_adj (kernel B'): free-slip sides, the 3-D "
            "Coriolis term and the CD scheme have no backward kernel")
    kernels.launch(kernel, u.dtype, kernels.pointer_table(table), len(table),
                   *args, *params, *extra)


class MomFluxformFn(torch.autograd.Function):
    """Kernel B forward, kernel B' (kernels/csrc/mom_fluxform_adj.cu)
    backward: u_bar, v_bar, w_bar from the cotangents of the four
    tendencies. The advection terms are quadratic, so u, v and w are saved;
    B' recomputes every intermediate from them."""

    @staticmethod
    def forward(ctx, u, v, w, kappaRU, kappaRV, cfg: Config, grid: Grid):
        out = MomTend(*(torch.empty_like(u) for _ in range(4)))
        _launch("mom_fluxform", cfg,
                _kernel_inputs(grid, u, v, w, kappaRU, kappaRV),
                dict(zip(MomTend._fields, out)))
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(u, v, w, kappaRU, kappaRV)
            ctx.cfg, ctx.grid = cfg, grid
        return tuple(out)

    @staticmethod
    def backward(ctx, *tend_bar):
        ins = _kernel_inputs(ctx.grid, *ctx.saved_tensors)
        bars = {n + "_bar": t.contiguous()
                for n, t in zip(MomTend._fields, tend_bar)}
        outs = {n: torch.empty_like(ins["u"])
                for n in ("u_bar", "v_bar", "w_bar")}
        _launch("mom_fluxform_adj", ctx.cfg, ins, {**bars, **outs})
        return (*outs.values(), None, None, None, None)


def mom_fluxform(cfg: Config, grid: Grid, u, v, w, kappaRU, kappaRV,
                 impl: str = None) -> MomTend:
    """gU/gV (advection + Coriolis) and guDiss/gvDiss (viscosity + drag),
    masked; kappaRU/kappaRV: [nr+1, nyp, nxp] interface viscosities.
    Differentiable in u, v and w; raises if a constant (the kappas, the
    grid) requires grad, since the kernel gives it none."""
    check_branches(cfg)
    const = [n for n, t in _kernel_inputs(grid, u, v, w, kappaRU,
                                          kappaRV).items()
             if t.requires_grad and n not in ("u", "v", "w")]
    if const:
        raise ValueError(f"mom_fluxform: constants {const} require grad")
    if not kernels.use_kernel(u, impl):
        return _mom_fluxform_plain(cfg, grid, u, v, w, kappaRU, kappaRV)
    if uses_visc_variant(cfg):
        return mom_fluxform_visc(cfg, grid, u, v, w, kappaRU, kappaRV,
                                 *mom_visc.fields(cfg, grid, u, v))
    return MomTend(*MomFluxformFn.apply(u, v, w, kappaRU, kappaRV, cfg,
                                        grid))


def drag_params(cfg: Config) -> tuple:
    """(drag, Cd): whether the bottom drag block of mom_fluxform.py:343
    (and mom_vecinv.py:373) runs, and the quadratic coefficient it applies
    (0 unless selectBotDragQuadr is 0)."""
    drag = (cfg.no_slip_bottom or cfg.selectBotDragQuadr >= 0
            or cfg.bottomDragLinear != 0.0)
    cd = cfg.bottomDragQuadratic if cfg.selectBotDragQuadr == 0 else 0.0
    return bool(drag), cd


def mom_fluxform_visc(cfg: Config, grid: Grid, u, v, w, kappaRU, kappaRV,
                      visc, del2, impl: str = None) -> MomTend:
    """Kernel B's dissipation variant (kernel entry mom_fluxform_visc) on
    X's viscosities `visc` (viscAh_Z, viscAh_D, viscA4_Z, viscA4_D; None:
    cfg's constants) and Y's Laplacian `del2` (del2u, del2v; None: no
    biharmonic viscosity), or its twin on CPU tensors or with
    impl="plain". No backward kernel: raises if an input requires grad."""
    ins = _kernel_inputs(grid, u, v, w, kappaRU, kappaRV)
    vt = mom_visc.field_table(visc, del2)
    grads = [n for n, t in {**ins, **vt}.items()
             if t is not None and t.requires_grad]
    if grads:
        raise ValueError(f"mom_fluxform: {grads} require grad; kernel B's "
                         "dissipation variant has no backward kernel")
    if not kernels.use_kernel(u, impl):
        return _mom_fluxform_plain(cfg, grid, u, v, w, kappaRU, kappaRV,
                                   visc=visc, del2=del2)
    out = MomTend(*(torch.empty_like(u) for _ in range(4)))
    given = {n: t for n, t in vt.items() if t is not None}
    kernels.check_fields(u.dtype, u.shape, **given)
    drag, cd = drag_params(cfg)
    vtab = list(vt.values())
    params = [cfg.viscA4D, cfg.viscA4Z, cfg.bottomDragLinear, cd]
    _launch("mom_fluxform_visc", cfg, ins, dict(zip(MomTend._fields, out)),
            extra=(kernels.pointer_table(vtab), len(vtab),
                   kernels.doubles(params), len(params),
                   int(cfg.no_slip_bottom), int(drag)))
    return out


def mom_fluxform_vjp_plain(cfg: Config, grid: Grid, u, v, w, kappaRU,
                           kappaRV, tend_bar):
    """Kernel B''s plain twin: (u_bar, v_bar, w_bar) by autograd through
    `_mom_fluxform_plain`, given the cotangents of (gU, gV, guDiss,
    gvDiss)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (u, v, w)]
        out = _mom_fluxform_plain(cfg, grid, *ins, kappaRU, kappaRV)
        return torch.autograd.grad(out, ins, tuple(tend_bar))


def _mom_fluxform_plain(cfg: Config, grid: Grid, u, v, w, kappaRU,
                        kappaRV, visc=None, del2=None) -> MomTend:
    """mom_fluxform.py:122-469 on the ported branches, in its operation
    order. On the gyre's branches its biharmonic terms, exact zeros, are
    left out, as are its products with rVel2wUnit, exactly 1 in
    z-coordinates. Under kernel B's dissipation variant the viscosities
    are X's twin's (or `visc`, as mom_fluxform_visc takes them; cfg's
    constants without variable viscosity) and the Laplacian Y's twin's,
    `_del2uv` (or `del2`)."""
    nr = cfg.nr
    drF = grid.drF[:, None, None]
    recip_drF = grid.recip_drF[:, None, None]
    rkSign = cfg.rkSign
    xA = grid.dyG * drF * grid.hFacW
    yA = grid.dxG * drF * grid.hFacS
    uTrans = u * xA
    vTrans = v * yA
    hFacZ = calc_hfacz(grid)
    ext = uses_visc_variant(cfg)
    if ext and visc is None and del2 is None:
        visc, del2 = mom_visc.fields(cfg, grid, u, v, impl="plain")

    # ---------------- advection (:155-230) ----------------
    wrA = w * grid.rA
    rTransU = 0.5 * (wrA + sh(wrA, di=-1))
    rTransV = 0.5 * (wrA + sh(wrA, dj=-1))
    fZonU = 0.25 * (uTrans + sh(uTrans, di=1)) * (u + sh(u, di=1))
    fMerU = 0.25 * (vTrans + sh(vTrans, di=-1)) * (u + sh(u, dj=-1))
    fZonV = 0.25 * (uTrans + sh(uTrans, dj=-1)) * (v + sh(v, di=-1))
    fMerV = 0.25 * (vTrans + sh(vTrans, dj=1)) * (v + sh(v, dj=1))
    # vertical fluxes at interfaces [nr+1]: rTrans*u(1) at the surface,
    # the centred average plus the free-surface dmask correction inside,
    # zero below the bottom
    fVerU_mid = rTransU * 0.5 * (u + shift_k(u, -1))
    fVerV_mid = rTransV * 0.5 * (v + shift_k(v, -1))
    mC = grid.maskC
    dmask = mC - shift_k(mC, -1)
    fVerU_mid = fVerU_mid + 0.25 * (wrA * dmask + sh(wrA * dmask, di=-1)) * u
    fVerV_mid = fVerV_mid + 0.25 * (wrA * dmask + sh(wrA * dmask, dj=-1)) * v
    z1 = torch.zeros_like(u[:1])
    fVerU = torch.cat([rTransU[:1] * u[:1], fVerU_mid[1:], z1])
    fVerV = torch.cat([rTransV[:1] * v[:1], fVerV_mid[1:], z1])
    gU = -(grid.recip_hFacW * recip_drF * grid.recip_rAw
           * ((fZonU - sh(fZonU, di=-1))
              + (sh(fMerU, dj=1) - fMerU)
              + (fVerU[1:] - fVerU[:-1]) * rkSign))
    gV = -(grid.recip_hFacS * recip_drF * grid.recip_rAs
           * ((sh(fZonV, di=1) - fZonV)
              + (fMerV - sh(fMerV, dj=-1))
              + (fVerV[1:] - fVerV[:-1]) * rkSign))

    # ---- harmonic + biharmonic + explicit vertical viscosity (:233-307)
    if visc is not None:
        AhZ, AhD, A4Z, A4D = visc
    else:
        AhZ, AhD, A4Z, A4D = (cfg.viscAhZ, cfg.viscAhD, cfg.viscA4Z,
                              cfg.viscA4D)
    hZonU = -AhD * (sh(u, di=1) - u) * grid.cosFacU
    hMerU = -AhZ * (u - sh(u, dj=-1))
    hZonV = -AhZ * (v - sh(v, di=-1)) * grid.cosFacV
    hMerV = -AhD * (sh(v, dj=1) - v)
    if del2 is not None:
        d2u, d2v = del2
        hZonU = hZonU + A4D * (sh(d2u, di=1) - d2u) * grid.cosFacU
        hMerU = hMerU + A4Z * (d2u - sh(d2u, dj=-1))
        hZonV = hZonV + A4Z * (d2v - sh(d2v, di=-1)) * grid.cosFacV
        hMerV = hMerV + A4D * (sh(d2v, dj=1) - d2v)
    fZonU = grid.dyF * drF * grid.hFacC * grid.recip_dxF * hZonU
    fMerU = grid.dxV * drF * hFacZ * grid.recip_dyU * hMerU
    fZonV = grid.dyU * drF * hFacZ * grid.recip_dxV * hZonV
    fMerV = grid.dxF * drF * grid.hFacC * grid.recip_dyF * hMerV
    recip_drC = grid.recip_drC[1:nr, None, None]
    rvU_mid = (-kappaRU[1:nr] * grid.rAw * (u[1:] - u[:-1]) * rkSign
               * recip_drC * grid.maskW[1:] * grid.maskW[:-1])
    rvV_mid = (-kappaRV[1:nr] * grid.rAs * (v[1:] - v[:-1]) * rkSign
               * recip_drC * grid.maskS[1:] * grid.maskS[:-1])
    rViscU = torch.cat([z1, rvU_mid, z1])
    rViscV = torch.cat([z1, rvV_mid, z1])
    dVrU = (rViscU[1:] - rViscU[:-1]) * rkSign
    dVrV = (rViscV[1:] - rViscV[:-1]) * rkSign
    guDiss = -(grid.recip_hFacW * recip_drF * grid.recip_rAw
               * ((fZonU - sh(fZonU, di=-1)) + (sh(fMerU, dj=1) - fMerU)
                  + dVrU))
    gvDiss = -(grid.recip_hFacS * recip_drF * grid.recip_rAs
               * ((sh(fZonV, di=1) - fZonV) + (fMerV - sh(fMerV, dj=-1))
                  + dVrV))

    # ---------------- no-slip side drag (:312-340) ----------------
    if cfg.no_slip_sides:
        guDiss, gvDiss = _side_drag(cfg, grid, u, v, hFacZ, guDiss, gvDiss,
                                    AhZ, A4Z, del2)

    # ---- bottom drag (:343-381): where the cell below is dry ----
    recDr = torch.cat([grid.recip_drC[1:nr],
                       grid.recip_drF[nr - 1:nr]])[:, None, None]
    bottomW = grid.maskW * (1.0 - torch.cat([grid.maskW[1:], z1]))
    bottomS = grid.maskS * (1.0 - torch.cat([grid.maskS[1:], z1]))
    drag, cd = drag_params(cfg)
    if not ext:
        cDragU = kappaRU[1:nr + 1] * recDr * 2.0
        cDragV = kappaRV[1:nr + 1] * recDr * 2.0
    elif drag:
        cDragU = torch.full_like(u, cfg.bottomDragLinear)
        cDragV = torch.full_like(v, cfg.bottomDragLinear)
        if cfg.no_slip_bottom:
            cDragU = cDragU + kappaRU[1:nr + 1] * recDr * 2.0
            cDragV = cDragV + kappaRV[1:nr + 1] * recDr * 2.0
        if cd != 0.0:
            cDragU, cDragV = quadratic_drag(cd, calc_ke(u, v), cDragU,
                                            cDragV)
    if drag:
        guDiss = guDiss - cDragU * bottomW * u * grid.recip_hFacW * recip_drF
        gvDiss = gvDiss - cDragV * bottomS * v * grid.recip_hFacS * recip_drF

    # ---------------- Coriolis, scheme 0 (:420-445) ----------------
    # none under the CD scheme, whose D-grid velocities give it (:410-419);
    # the 3-D term stays
    if not cfg.useCDscheme:
        fC = grid.fCori
        uCf = (0.5 * (fC + sh(fC, di=-1)) * 0.25
               * (v + sh(v, dj=1) + sh(v, di=-1) + sh(v, di=-1, dj=1)))
        vCf = (-0.5 * (fC + sh(fC, dj=-1)) * 0.25
               * (u + sh(u, di=1) + sh(u, dj=-1) + sh(u, di=1, dj=-1)))
        gU = gU + uCf
        gV = gV + vCf
    if cfg.select3dCoriScheme >= 1:
        gU = gU + coriolis_3d_u(cfg, grid, w)
    return MomTend(gU=gU * grid.maskW, gV=gV * grid.maskS,
                   guDiss=guDiss * grid.maskW, gvDiss=gvDiss * grid.maskS)


def coriolis_3d_u(cfg: Config, grid: Grid, w):
    """The 3-D Coriolis term of the u equation, fPrime times the vertical
    velocity averaged to U points (mom_fluxform.py:454-469,
    mom_u_coriolis_nh.F); the v equation has none on a Cartesian grid."""
    wbar = 0.5 * (w + shift_k(w, 1))    # zero below the bottom level
    fcw = grid.fCoriCos * grid.angleCosC * wbar
    return 0.5 * (fcw + sh(fcw, di=-1)) * cfg.gravitySign


def quadratic_drag(cd: float, KE, cDragU, cDragV):
    """The quadratic bottom drag, selectBotDragQuadr 0
    (mom_u_botdrag_coeff.F; mom_fluxform.py:360-370), added to the drag
    coefficients at u and v points from KE at the two cell centres."""
    keS = KE + sh(KE, di=-1)
    cDragU = cDragU + torch.where(
        keS > 0.0, cd * torch.sqrt(torch.clamp_min(keS, 0.0)), 0.0)
    keSv = KE + sh(KE, dj=-1)
    cDragV = cDragV + torch.where(
        keSv > 0.0, cd * torch.sqrt(torch.clamp_min(keSv, 0.0)), 0.0)
    return cDragU, cDragV


def _north(f):
    return sh(f, dj=1) if torch.is_tensor(f) else f


def _east(f):
    return sh(f, di=1) if torch.is_tensor(f) else f


def _side_drag(cfg: Config, grid: Grid, u, v, hFacZ, guDiss, gvDiss,
               AhZ=None, A4Z=None, del2=None):
    """No-slip side drag (mom_fluxform.py:312-340, mom_u_sidedrag.F) added
    to guDiss and gvDiss: viscAh_Z (cfg.viscAhZ, or a field) at each
    closed wall's vorticity point, with the biharmonic term of viscA4_Z
    and the Laplacian `del2` when given."""
    recip_drF = grid.recip_drF[:, None, None]
    drF = grid.drF[:, None, None]
    AhZ = cfg.viscAhZ if AhZ is None else AhZ
    Ahu, AhuN = AhZ * u, _north(AhZ) * u
    Ahv, AhvE = AhZ * v * grid.cosFacV, _east(AhZ) * v * grid.cosFacV
    if del2 is not None:
        d2u, d2v = del2
        Ahu = Ahu - A4Z * d2u
        AhuN = AhuN - _north(A4Z) * d2u
        Ahv = Ahv - A4Z * d2v * grid.cosFacV
        AhvE = AhvE - _east(A4Z) * d2v * grid.cosFacV
    uDrag = -(grid.recip_hFacW * recip_drF * grid.recip_rAw
              * ((grid.hFacW - hFacZ) * grid.dxV * grid.recip_dyU * Ahu
                 + (grid.hFacW - sh(hFacZ, dj=1)) * sh(grid.dxV, dj=1)
                 * sh(grid.recip_dyU, dj=1) * AhuN)
              * drF * cfg.sideDragFactor)
    vDrag = -(grid.recip_hFacS * recip_drF * grid.recip_rAs
              * ((grid.hFacS - hFacZ) * grid.dyU * grid.recip_dxV * Ahv
                 + (grid.hFacS - sh(hFacZ, di=1)) * sh(grid.dyU, di=1)
                 * sh(grid.recip_dxV, di=1) * AhvE)
              * drF * cfg.sideDragFactor)
    return guDiss + uDrag, gvDiss + vDrag


def _del2uv(cfg: Config, grid: Grid, u, v, hFacZ):
    """Kernel Y's flux-form twin: the Laplacian of u and v for biharmonic
    viscosity (mom_fluxform.py:67-119, mom_u_del2u.F/mom_v_del2v.F), with
    the closed-wall term under no-slip sides; the static open fractions
    (no nonlinear free surface) and no OBCS, whose masks are exact ones."""
    drF = grid.drF[:, None, None]
    recip_drF = grid.recip_drF[:, None, None]
    closed = 1.0 if cfg.no_slip_sides else 0.0
    fZon = (drF * grid.hFacC * grid.dyF * grid.recip_dxF
            * (sh(u, di=1) - u))
    fMer = drF * hFacZ * grid.dxV * grid.recip_dyU * (u - sh(u, dj=-1))
    del2u = (grid.recip_hFacW * recip_drF * grid.recip_rAw
             * ((fZon - sh(fZon, di=-1)) + (sh(fMer, dj=1) - fMer))
             * grid.maskW)
    del2u = del2u - (
        grid.recip_hFacW * recip_drF * grid.recip_rAw
        * ((grid.hFacW - hFacZ) * grid.dxV * grid.recip_dyU
           + (grid.hFacW - sh(hFacZ, dj=1)) * sh(grid.dxV, dj=1)
           * sh(grid.recip_dyU, dj=1))
        * drF * 2.0 * u * closed) * grid.maskW
    fZonV = drF * hFacZ * grid.dyU * grid.recip_dxV * (v - sh(v, di=-1))
    fMerV = (drF * grid.hFacC * grid.dxF * grid.recip_dyF
             * (sh(v, dj=1) - v))
    del2v = (grid.recip_hFacS * recip_drF * grid.recip_rAs
             * ((sh(fZonV, di=1) - fZonV) + (fMerV - sh(fMerV, dj=-1)))
             * grid.maskS)
    del2v = del2v - (
        grid.recip_hFacS * recip_drF * grid.recip_rAs
        * ((grid.hFacS - hFacZ) * grid.dyU * grid.recip_dxV
           + (grid.hFacS - sh(hFacZ, di=1)) * sh(grid.dyU, di=1)
           * sh(grid.recip_dxV, di=1))
        * drF * 2.0 * v * closed) * grid.maskS
    return del2u, del2v
