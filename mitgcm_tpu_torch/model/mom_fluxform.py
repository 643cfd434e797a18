"""Flux-form momentum tendencies (mitgcm_tpu/model/mom_fluxform.py;
reference pkg/mom_fluxform/mom_fluxform.F) on the branches of the gyre:
centred advection, constant harmonic viscosity with the explicit vertical
viscous flux, no-slip bottom drag, and Coriolis scheme 0; with no-slip or
free-slip sides (the side drag only under no-slip), and with or without
the 3-D Coriolis term -fPrime w of the non-hydrostatic path
(select3dCoriScheme >= 1). Kernel B takes the last two as template flags;
its backward B' refuses them, so the adjoint stays on the gyre's branches.

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


def variable_viscosity(cfg: Config) -> bool:
    """Whether cfg asks for mom_visc.py's grid-, Smagorinsky- or
    Leith-scaled viscosity (no form of momentum ports it yet)."""
    return (cfg.viscAhGrid != 0.0 or cfg.viscA4Grid != 0.0
            or cfg.viscC2smag != 0.0 or cfg.viscC4smag != 0.0
            or cfg.viscC2leith != 0.0 or cfg.viscC2leithD != 0.0
            or cfg.viscC2LeithQG != 0.0 or cfg.viscC4leith != 0.0
            or cfg.viscC4leithD != 0.0)


def check_branches(cfg: Config) -> None:
    """Raise unless cfg selects exactly the branches ported here."""
    off = {
        "momAdvection": not cfg.momAdvection,
        "momViscosity": not cfg.momViscosity,
        "no_slip_bottom": not cfg.no_slip_bottom,
        "selectCoriScheme": cfg.selectCoriScheme != 0,
        "biharmonic viscosity": (cfg.viscA4 != 0.0 or cfg.viscA4D != 0.0
                                 or cfg.viscA4Z != 0.0),
        "variable viscosity": variable_viscosity(cfg),
        "implicitViscosity": cfg.implicitViscosity,
        "bottom drag beyond no-slip": (cfg.bottomDragLinear != 0.0
                                       or cfg.selectBotDragQuadr >= 0),
        "rigidLid": cfg.rigidLid,
        "select_rStar": cfg.select_rStar != 0,
        "useCDscheme": cfg.useCDscheme,
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


def _launch(kernel: str, cfg: Config, ins: dict, outs: dict) -> None:
    """Check and launch kernel B (outs = the four tendencies) or B'
    (outs = the four cotangents, in the tendencies' slots, then u_bar,
    v_bar and w_bar; the gyre's flags only)."""
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
    if kernel == "mom_fluxform":
        no_slip, cori3d = flags(cfg)
        args += (int(no_slip), int(cori3d))
        params += (cfg.gravitySign,)
    elif flags(cfg) != (True, False):
        raise NotImplementedError(
            "mom_fluxform_adj (kernel B'): free-slip sides and the 3-D "
            "Coriolis term have no backward kernel")
    kernels.launch(kernel, u.dtype, kernels.pointer_table(table), len(table),
                   *args, *params)


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
    return MomTend(*MomFluxformFn.apply(u, v, w, kappaRU, kappaRV, cfg,
                                        grid))


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
                        kappaRV) -> MomTend:
    """mom_fluxform.py:122-469 on the ported branches, in its operation
    order. The biharmonic terms of the JAX code add exact zeros here and
    are left out, as are its products with rVel2wUnit, exactly 1 in
    z-coordinates."""
    nr = cfg.nr
    drF = grid.drF[:, None, None]
    recip_drF = grid.recip_drF[:, None, None]
    rkSign = cfg.rkSign
    xA = grid.dyG * drF * grid.hFacW
    yA = grid.dxG * drF * grid.hFacS
    uTrans = u * xA
    vTrans = v * yA
    hFacZ = calc_hfacz(grid)

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

    # ------- harmonic + explicit vertical viscosity (:233-307) -------
    AhD, AhZ = cfg.viscAhD, cfg.viscAhZ
    fZonU = (grid.dyF * drF * grid.hFacC * grid.recip_dxF
             * (-AhD * (sh(u, di=1) - u) * grid.cosFacU))
    fMerU = (grid.dxV * drF * hFacZ * grid.recip_dyU
             * (-AhZ * (u - sh(u, dj=-1))))
    fZonV = (grid.dyU * drF * hFacZ * grid.recip_dxV
             * (-AhZ * (v - sh(v, di=-1)) * grid.cosFacV))
    fMerV = (grid.dxF * drF * grid.hFacC * grid.recip_dyF
             * (-AhD * (sh(v, dj=1) - v)))
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
        guDiss, gvDiss = _side_drag(cfg, grid, u, v, hFacZ, guDiss, gvDiss)

    # ---- no-slip bottom drag (:343-381): where the cell below is dry ----
    recDr = torch.cat([grid.recip_drC[1:nr],
                       grid.recip_drF[nr - 1:nr]])[:, None, None]
    cDragU = kappaRU[1:nr + 1] * recDr * 2.0
    cDragV = kappaRV[1:nr + 1] * recDr * 2.0
    bottomW = grid.maskW * (1.0 - torch.cat([grid.maskW[1:], z1]))
    bottomS = grid.maskS * (1.0 - torch.cat([grid.maskS[1:], z1]))
    guDiss = guDiss - cDragU * bottomW * u * grid.recip_hFacW * recip_drF
    gvDiss = gvDiss - cDragV * bottomS * v * grid.recip_hFacS * recip_drF

    # ---------------- Coriolis, scheme 0 (:420-445) ----------------
    fC = grid.fCori
    uCf = (0.5 * (fC + sh(fC, di=-1))
           * 0.25 * (v + sh(v, dj=1) + sh(v, di=-1) + sh(v, di=-1, dj=1)))
    vCf = (-0.5 * (fC + sh(fC, dj=-1))
           * 0.25 * (u + sh(u, di=1) + sh(u, dj=-1) + sh(u, di=1, dj=-1)))
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


def _side_drag(cfg: Config, grid: Grid, u, v, hFacZ, guDiss, gvDiss):
    """No-slip side drag (mom_fluxform.py:312-340, mom_u_sidedrag.F)
    added to guDiss and gvDiss."""
    recip_drF = grid.recip_drF[:, None, None]
    drF = grid.drF[:, None, None]
    AhZ = cfg.viscAhZ
    Ahu = AhZ * u
    uDrag = -(grid.recip_hFacW * recip_drF * grid.recip_rAw
              * ((grid.hFacW - hFacZ) * grid.dxV * grid.recip_dyU * Ahu
                 + (grid.hFacW - sh(hFacZ, dj=1)) * sh(grid.dxV, dj=1)
                 * sh(grid.recip_dyU, dj=1) * Ahu)
              * drF * cfg.sideDragFactor)
    Ahv = AhZ * v * grid.cosFacV
    vDrag = -(grid.recip_hFacS * recip_drF * grid.recip_rAs
              * ((grid.hFacS - hFacZ) * grid.dyU * grid.recip_dxV * Ahv
                 + (grid.hFacS - sh(hFacZ, di=1)) * sh(grid.dyU, di=1)
                 * sh(grid.recip_dxV, di=1) * Ahv)
              * drF * cfg.sideDragFactor)
    return guDiss + uDrag, gvDiss + vDrag
