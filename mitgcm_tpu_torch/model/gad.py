"""Generic advection-diffusion (mitgcm_tpu/model/gad.py): centred
2nd-order advection (scheme 2) with Laplacian horizontal and explicit
vertical diffusion, and the direction-split multi-dimensional advection of
every scheme the JAX package runs under it: upwind (1), DST-2 (20), DST-3
(30), DST-3 flux-limited (33), Superbee (77), OS7MP (7) and PPM/PQM
(40-42, 50-52, in model/gad_ho.py), with the vertical schemes 1, 2, 3, 4,
7, 20, 30, 33, 77, 40-42 and 50-52.

`calc_adv_flow` runs kernel L (kernels/csrc/adv_flow.cu) for CUDA
tensors, under kernels.TwinVJP, and its twin `_calc_adv_flow_plain` for
CPU tensors or with impl="plain".

`calc_rhs` runs kernel C (kernels/csrc/gad_calc_rhs.cu) for CUDA tensors,
with kernel C' (gad_calc_rhs_adj.cu) as its backward, and the plain
PyTorch twin `_calc_rhs_plain`, differentiated by autograd, for CPU
tensors or when impl="plain" is asked for. The kernel writes zero halo
cells; both agree on the interior. With implicit_diffusion the explicit
vertical diffusive flux is left out (the implicit solve,
thermodynamics.impldiff, takes its place). An extra vertical flux `df`
(KPP's nonlocal flux) is added to fVer before the divergence. Without
calc_advection the advective fluxes and the tracer * divergence term are
left out (the multi-dimensional advection has advected the tracer). With a
GM-Redi tensor `gm` (model/gmredi.py) GM's fluxes join after the
diffusive ones (xy_flux, r_flux), as the launch gad_calc_rhs_c2_gm on the
card. Kernel C' has none of these branches, so those variants refuse
gradients.

`multidim_advection` runs the X, Y and R sweeps, one launch each, on the
kernel that owns each sweep's scheme: M (kernels/csrc/gad_multidim.cu:
schemes 1, 20, 30, 33, 77 and the vertical 1, 2, 3, 4), O (gad_os7mp.cu:
scheme 7) or P (gad_ppm.cu: 40-42 and 50-52), for CUDA tensors; the plain
twin `_multidim_plain`, built from `adv_flux_x`/`adv_flux_y`/`adv_flux_r`,
runs for CPU tensors or with impl="plain". Both compute every cell of the
padded arrays with the JAX code's zero-filled shifts, so the Y sweep reads
what the X sweep wrote in the halo rows, as in the JAX code. No gradient:
the adjoint refuses every scheme but 2. JAX's adv_flux_r runs centred
2nd order for a vertical scheme it does not know; the port refuses one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import gad_ho, gmredi
from mitgcm_tpu_torch.ops.stencil import shift as sh
from mitgcm_tpu_torch.ops.stencil import shift_k

ENUM_UPWIND_1RST = 1
ENUM_CENTERED_2ND = 2
ENUM_UPWIND_3RD = 3
ENUM_CENTERED_4TH = 4
ENUM_DST2 = 20
ENUM_DST3 = 30
ENUM_DST3_FLUX_LIMIT = 33
ENUM_FLUX_LIMIT = 77
ENUM_OS7MP = gad_ho.ENUM_OS7MP
PPM_PQM_SCHEMES = gad_ho.PPM_SCHEMES + gad_ho.PQM_SCHEMES
# the schemes that run under the multi-dimensional advection (gad.py:49-51)
MULTIDIM_SCHEMES = (ENUM_FLUX_LIMIT, ENUM_DST3_FLUX_LIMIT, ENUM_DST2,
                    ENUM_DST3, ENUM_UPWIND_1RST, ENUM_OS7MP) + PPM_PQM_SCHEMES
# the vertical schemes that adv_flux_r computes (gad.py:932-1017)
VERT_SCHEMES = (ENUM_UPWIND_1RST, ENUM_CENTERED_2ND, ENUM_UPWIND_3RD,
                ENUM_CENTERED_4TH, ENUM_OS7MP, ENUM_DST2, ENUM_DST3,
                ENUM_DST3_FLUX_LIMIT, ENUM_FLUX_LIMIT) + PPM_PQM_SCHEMES

# calls of multidim_advection that ran the plain twin, and of
# calc_adv_flow's (a run on the card reads them to show that its kernel
# path never did)
plain_calls = 0
flow_plain_calls = 0

_CR_MAX = 1.0e6       # gad_fluxlimit_adv_x.F:63
_THETA_MAX = 1.0e20   # gad_dst3fl_adv_x.F:36


class AdvFlow(NamedTuple):
    uTrans: torch.Tensor    # [nr, nyp, nxp]
    vTrans: torch.Tensor
    rTrans: torch.Tensor    # at interface k (surface index 0 = 0)
    rTransKp: torch.Tensor  # at interface k+1 (bottom = 0)
    maskUp: torch.Tensor
    xA: torch.Tensor
    yA: torch.Tensor


def _calc_adv_flow_plain(grid: Grid, u, v, w):
    """Kernel L's twin: calc_adv_flow (gad.py:64-78 of the JAX package), the
    seven fields of AdvFlow in its order and operation order."""
    drF = grid.drF[:, None, None]
    xA = grid.dyG * drF * grid.hFacW
    yA = grid.dxG * drF * grid.hFacS
    mC = grid.maskC
    maskUp = torch.cat([torch.zeros_like(mC[:1]), mC[1:] * mC[:-1]])
    rTrans = w * grid.rA * maskUp
    rTransKp = torch.cat([rTrans[1:], torch.zeros_like(rTrans[:1])])
    return u * xA, v * yA, rTrans, rTransKp, maskUp, xA, yA


def _calc_adv_flow_kernel(grid: Grid, u, v, w):
    """Kernel L on the card (adv_flow.cu): the seven fields, fresh."""
    outs = [torch.empty_like(u) for _ in AdvFlow._fields]
    kernels.check_fields(u.dtype, u.shape, u=u, v=v, w=w, hFacW=grid.hFacW,
                         hFacS=grid.hFacS, maskC=grid.maskC,
                         **dict(zip(AdvFlow._fields, outs)))
    kernels.check_fields(u.dtype, u.shape[1:], dyG=grid.dyG, dxG=grid.dxG,
                         rA=grid.rA)
    kernels.check_fields(u.dtype, u.shape[:1], drF=grid.drF)
    table = [u, v, w, grid.hFacW, grid.hFacS, grid.maskC, grid.dyG,
             grid.dxG, grid.rA, grid.drF, *outs]
    kernels.launch("adv_flow", u.dtype, kernels.pointer_table(table),
                   len(table), *u.shape)
    return tuple(outs)


def adv_flow_vjp_plain(grid: Grid, uTrans_bar, vTrans_bar, rTrans_bar,
                       rTransKp_bar):
    """Kernel L''s plain version, in its operation order: (u_bar, v_bar,
    w_bar) from the cotangents of the four transports, rTransKp's level
    shift transposed."""
    drF = grid.drF[:, None, None]
    xA = grid.dyG * drF * grid.hFacW
    yA = grid.dxG * drF * grid.hFacS
    mC = grid.maskC
    maskUp = torch.cat([torch.zeros_like(mC[:1]), mC[1:] * mC[:-1]])
    r = torch.cat([rTrans_bar[:1], rTrans_bar[1:] + rTransKp_bar[:-1]])
    return uTrans_bar * xA, vTrans_bar * yA, (r * maskUp) * grid.rA


def _adv_flow_adj_kernel(grid: Grid, need, *bars):
    """Kernel L' on the card (adv_flow.cu): the cotangents of (u, v, w)
    that `need` asks for, fresh, from those of the seven fields (the last
    three, constants, unread)."""
    bars = bars[:4]
    outs = [torch.empty_like(bars[0]) if n else None for n in need]
    u = bars[0]
    kernels.check_fields(u.dtype, u.shape, hFacW=grid.hFacW,
                         hFacS=grid.hFacS, maskC=grid.maskC, **{
                             f"{n}_bar": t for n, t in zip(
                                 AdvFlow._fields[:4] + ("u", "v", "w"),
                                 (*bars, *outs)) if t is not None})
    kernels.check_fields(u.dtype, u.shape[1:], dyG=grid.dyG, dxG=grid.dxG,
                         rA=grid.rA)
    kernels.check_fields(u.dtype, u.shape[:1], drF=grid.drF)
    table = [*bars, grid.hFacW, grid.hFacS, grid.maskC, grid.dyG, grid.dxG,
             grid.rA, grid.drF, *outs]
    kernels.launch("adv_flow_adj", u.dtype, kernels.pointer_table(table),
                   len(table), *u.shape)
    return outs


def calc_adv_flow(grid: Grid, u, v, w, impl: str = None) -> AdvFlow:
    """model/src/calc_adv_flow.F, all levels at once. Kernel L on CUDA
    tensors, differentiable in u, v and w through kernel L' (maskUp, xA
    and yA, which depend on the grid alone, leave autograd's graph), its
    twin on CPU tensors or with impl="plain"."""
    if not kernels.use_kernel(u, impl):
        global flow_plain_calls
        flow_plain_calls += 1
        return AdvFlow(*_calc_adv_flow_plain(grid, u, v, w))
    kernels.refuse_grad("calc_adv_flow", hFacW=grid.hFacW, hFacS=grid.hFacS,
                        maskC=grid.maskC, dyG=grid.dyG, dxG=grid.dxG,
                        rA=grid.rA, drF=grid.drF)
    outs = kernels.KernelVJP.apply(
        lambda *ts: _calc_adv_flow_kernel(grid, *ts),
        lambda need, *bars: _adv_flow_adj_kernel(grid, need, *bars),
        u, v, w)
    return AdvFlow(*outs[:4], *(t.detach() for t in outs[4:]))


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c as one IEEE division on every device (PyTorch's CUDA kernels
    multiply by the reciprocal of a Python-number divisor; kernel M and the
    JAX package divide)."""
    return a / a.new_tensor(c)


def _limiter(cr):
    """Superbee limiter (gad_fluxlimit_adv_x.F Limiter)."""
    return torch.clamp(torch.maximum(torch.clamp(2.0 * cr, max=1.0),
                                     torch.clamp(cr, max=2.0)), min=0.0)


def _flux_limit_cr(Rj, cr_raw):
    """The Superbee slope ratio with its overflow guard: +-_CR_MAX with the
    signs of cr_raw and Rj where |Rj| * _CR_MAX <= |cr_raw|."""
    big = torch.where(cr_raw >= 0.0, Rj.new_tensor(_CR_MAX),
                      Rj.new_tensor(-_CR_MAX))
    sign_rj = torch.where(Rj >= 0.0, Rj.new_tensor(1.0), Rj.new_tensor(-1.0))
    return torch.where(Rj.abs() * _CR_MAX <= cr_raw.abs(), big * sign_rj,
                       cr_raw / torch.where(Rj == 0.0, 1.0, Rj))


def _dst3fl_psi(Rj, Rother, cfl, d0, d1):
    """DST-3 flux-limited weight (gad_dst3fl_adv_x.F): theta = Rother/Rj
    with its overflow guard, psi = d0 + d1 theta clipped to [0, min(1,
    theta (1-cfl)/cfl)]."""
    theta = torch.where(
        Rj.abs() * _THETA_MAX <= Rother.abs(),
        torch.where(Rother * Rj >= 0.0, Rj.new_tensor(_THETA_MAX),
                    Rj.new_tensor(-_THETA_MAX)),
        Rother / torch.where(Rj == 0.0, 1.0, Rj))
    psi = d0 + d1 * theta
    return torch.clamp(torch.minimum(torch.clamp(psi, max=1.0),
                                     theta * (1.0 - cfl) / (cfl + 1.0e-20)),
                       min=0.0)


def _adv_flux_highorder(scheme: int, trans, cfl, t, tm1, Rjp, Rj, Rjm):
    """gad.py:_adv_flux_highorder (:783-836) for schemes 77, 30 and 33: the
    horizontal flux at a face, direction-agnostic."""
    absT = trans.abs()
    if scheme == ENUM_FLUX_LIMIT:
        lim = _limiter(_flux_limit_cr(Rj, torch.where(trans > 0.0, Rjm,
                                                      Rjp)))
        return (trans * (t + tm1) * 0.5
                - absT * ((1.0 - lim) + cfl * lim) * Rj * 0.5)
    d0 = (2.0 - cfl) * (1.0 - cfl) * (1.0 / 6.0)
    d1 = (1.0 - cfl * cfl) * (1.0 / 6.0)
    if scheme == ENUM_DST3:
        return (0.5 * (trans + absT) * (tm1 + (d0 * Rj + d1 * Rjm))
                + 0.5 * (trans - absT) * (t - (d0 * Rj + d1 * Rjp)))
    if scheme == ENUM_DST3_FLUX_LIMIT:
        psiP = _dst3fl_psi(Rj, Rjm, cfl, d0, d1)
        psiM = _dst3fl_psi(Rj, Rjp, cfl, d0, d1)
        return (0.5 * (trans + absT) * (tm1 + psiP * Rj)
                + 0.5 * (trans - absT) * (t - psiM * Rj))
    raise NotImplementedError(f"advection scheme {scheme}")


def _adv_flux_h(grid: Grid, scheme: int, axis: str, trans, vel, tracer,
                deltaT, mask):
    """gad.py:adv_flux_x / adv_flux_y (:839-908) along `axis`: the flux at
    the west (x) or south (y) face; mask is the scheme's face mask (maskW *
    maskInW or maskS * maskInS under the multi-dimensional advection)."""
    if axis == "x":
        s = lambda a, d: sh(a, di=d)                       # noqa: E731
        recip_dC = grid.recip_dxC
    else:
        s = lambda a, d: sh(a, dj=d)                       # noqa: E731
        recip_dC = grid.recip_dyC
    t = tracer
    tm1 = s(t, -1)
    if scheme == ENUM_CENTERED_2ND:
        return trans * 0.5 * (t + tm1)
    if scheme == ENUM_OS7MP:
        flux = gad_ho.os7mp_flux_x if axis == "x" else gad_ho.os7mp_flux_y
        return flux(trans, vel, mask, t, deltaT, recip_dC)
    if scheme in PPM_PQM_SCHEMES:
        return gad_ho._ppm_pqm_flux_h(grid, scheme, axis, trans, vel, t,
                                      deltaT)
    if scheme in (ENUM_UPWIND_1RST, ENUM_DST2):
        # gad_dst2u1_adv_x.F: Lax-Wendroff, or upwind with a limit of 1
        limit = 1.0 if scheme == ENUM_UPWIND_1RST else vel * deltaT * recip_dC
        return 0.5 * (trans * (t + tm1) - trans.abs() * limit * (t - tm1))
    Rjp = (s(t, 1) - t) * s(mask, 1)
    Rj = (t - tm1) * mask
    Rjm = (tm1 - s(t, -2)) * s(mask, -1)
    return _adv_flux_highorder(scheme, trans, (vel * deltaT * recip_dC).abs(),
                               t, tm1, Rjp, Rj, Rjm)


def adv_flux_x(grid: Grid, scheme: int, uTrans, uFld, tracer, deltaT,
               maskW):
    """Zonal advective flux at the west face (gad.py:adv_flux_x, :839-874):
    scheme 2 (gad_c2_adv_x.F) or any scheme of MULTIDIM_SCHEMES; maskW is
    the scheme's face mask (maskW * maskInW under the multi-dimensional
    advection)."""
    return _adv_flux_h(grid, scheme, "x", uTrans, uFld, tracer, deltaT,
                       maskW)


def adv_flux_y(grid: Grid, scheme: int, vTrans, vFld, tracer, deltaT,
               maskS):
    """Meridional advective flux at the south face (gad.py:adv_flux_y)."""
    return _adv_flux_h(grid, scheme, "y", vTrans, vFld, tracer, deltaT,
                       maskS)


def adv_flux_r(grid: Grid, scheme: int, rTrans, wFld, tracer, deltaT):
    """Vertical advective flux at interface k, zero at the surface
    (gad.py:adv_flux_r, :911-1022) of every scheme in VERT_SCHEMES: 2
    (gad_c2_adv_r.F), 4 (gad_c4_adv_r.F), 1 and 20 (gad_dst2u1_adv_r.F), 77
    (gad_fluxlimit_adv_r.F), 3 (gad_u3_adv_r.F), 30 (gad_dst3_adv_r.F), 33
    (gad_dst3fl_adv_r.F), 7 (gad_os7mp_adv_r.F) and PPM/PQM (gad_ppm_adv_r.F,
    gad_pqm_adv_r.F). The vertical neighbours are clamped at the column ends
    (km1 = max(1, k-1) and so on)."""
    t = tracer
    mC = grid.maskC
    nr = t.shape[0]
    if scheme == ENUM_OS7MP:
        flx = gad_ho._os7mp_flux_r(mC, grid.recip_drC, rTrans, wFld, t,
                                   deltaT)
        flx[0] = 0.0
        return flx
    if scheme in PPM_PQM_SCHEMES:
        return gad_ho._ppm_pqm_flux_r(grid, scheme, rTrans, wFld, t, deltaT)
    tkm1 = torch.cat([t[:1], t[:-1]])
    tkm2 = torch.cat([tkm1[:1], tkm1[:-1]])
    tkp1 = torch.cat([t[1:], t[-1:]])
    mkm1 = torch.cat([mC[:1], mC[:-1]])
    mkm2 = torch.cat([mkm1[:1], mkm1[:-1]])
    mkp1 = torch.cat([mC[1:], mC[-1:]])
    absT = rTrans.abs()
    wCFL = (wFld * deltaT * grid.recip_drC[:nr, None, None]).abs() \
        if wFld is not None else None
    if scheme == ENUM_CENTERED_2ND:
        flx = mkm1 * rTrans * 0.5 * (t + tkm1)
    elif scheme == ENUM_CENTERED_4TH:
        # 4th-order centred; the upwind correction only next to the top and
        # the bottom (the maskBound wall factor)
        k1 = torch.arange(1, nr + 1, dtype=t.dtype,
                          device=t.device)[:, None, None]
        maskPM = 1.0 - ((k1 <= 2.0) | (k1 >= float(nr))).to(t.dtype)
        maskBound = maskPM * mkm2 * mkp1
        Rjp = (tkp1 - t) * mkp1
        Rj = t - tkm1
        Rjm = (tkm1 - tkm2) * mkm1
        Rjjp = Rjp - Rj
        Rjjm = Rj - Rjm
        flx = mkm1 * (
            rTrans * ((t + tkm1) * 0.5 - (Rjjm + Rjjp) * (1.0 / 12.0))
            + absT * (1.0 / 6.0) * (Rjjm - Rjjp) * 0.5 * (1.0 - maskBound))
    elif scheme in (ENUM_UPWIND_1RST, ENUM_DST2):
        limit = 1.0 if scheme == ENUM_UPWIND_1RST else wCFL
        flx = mkm1 * 0.5 * (rTrans * (t + tkm1) + absT * limit * (t - tkm1))
    elif scheme == ENUM_FLUX_LIMIT:
        Rjp = (tkp1 - t) * mkp1
        Rj = t - tkm1
        Rjm = (tkm1 - tkm2) * mkm2
        lim = _limiter(_flux_limit_cr(Rj, torch.where(rTrans < 0.0, Rjm,
                                                      Rjp)))
        flx = mkm1 * (rTrans * (t + tkm1) * 0.5
                      + absT * ((1.0 - lim) + wCFL * lim) * Rj * 0.5)
    elif scheme == ENUM_UPWIND_3RD:
        # gad_u3_adv_r.F:36-46: its R's run top-down, Rj unmasked and Rjm
        # masked with m(k-2)
        Rjjp = (tkp1 - t) * mkp1 - (t - tkm1)
        Rjjm = (t - tkm1) - (tkm1 - tkm2) * mkm2
        flx = mkm1 * (
            rTrans * ((t + tkm1) * 0.5 - (1.0 / 6.0) * (Rjjm + Rjjp) * 0.5)
            + absT * (1.0 / 6.0) * (Rjjm - Rjjp) * 0.5)
    elif scheme in (ENUM_DST3, ENUM_DST3_FLUX_LIMIT):
        Rjp = (t - tkp1) * mkp1
        Rj = (tkm1 - t) * mC * mkm1
        Rjm = (tkm2 - tkm1) * mkm1
        d0 = (2.0 - wCFL) * (1.0 - wCFL) * (1.0 / 6.0)
        d1 = (1.0 - wCFL * wCFL) * (1.0 / 6.0)
        if scheme == ENUM_DST3:
            flx = (0.5 * (rTrans + absT) * (t + (d0 * Rj + d1 * Rjp))
                   + 0.5 * (rTrans - absT) * (tkm1 - (d0 * Rj + d1 * Rjm)))
        else:
            psiP = _dst3fl_psi(Rj, Rjm, wCFL, d0, d1)
            psiM = _dst3fl_psi(Rj, Rjp, wCFL, d0, d1)
            flx = (0.5 * (rTrans + absT) * (t + psiM * Rj)
                   + 0.5 * (rTrans - absT) * (tkm1 - psiP * Rj))
    else:
        raise NotImplementedError(f"vertical advection scheme {scheme}")
    flx[0] = 0.0
    return flx


def diff_flux_r(cfg: Config, grid: Grid, kappaR, maskUp, tracer):
    """gad_diff_r.F: interface diffusive flux [nr,...]; zero at surface."""
    flx = (-kappaR[:cfg.nr] * maskUp * grid.rA
           * grid.recip_drC[:cfg.nr, None, None]
           * (tracer - shift_k(tracer, -1)) * cfg.rkSign)
    flx[0] = 0.0
    return flx


# grid fields kernels C and C' read, in the order of GadArgs
_GRID3 = ("maskC", "recip_hFacC")
_GRID2 = ("rA", "recip_dxC", "recip_dyC", "cosFacU", "recip_rA", "maskInC")
_GRID1 = ("recip_drF", "recip_drC")
# the inputs that get a gradient; the others are constants
_DIFFERENTIABLE = ("tracer", "uTrans", "vTrans", "rTrans")


def _kernel_inputs(grid: Grid, tracer, uTrans, vTrans, rTrans, xA, yA,
                   maskUp, kappaR) -> dict:
    """Kernel C's inputs by name, in the order of
    kernels/csrc/gad_calc_rhs.cuh:GadArgs."""
    return dict(uTrans=uTrans, vTrans=vTrans, rTrans=rTrans, xA=xA, yA=yA,
                maskUp=maskUp, tracer=tracer, kappaR=kappaR,
                **{n: getattr(grid, n) for n in _GRID3 + _GRID2 + _GRID1})


def _launch(kernel: str, cfg: Config, ins: dict, last, outs: dict,
            diffKh: float, *flags) -> None:
    """Check and launch kernel C (last = gTr, flags = (implicit_diffusion,
    calc_advection, the pointer of df or 0), and for gad_calc_rhs_c2_gm the
    GM table, its length and the scalar Kux and Kvy) or C' (last = the
    cotangent of gTr, outs = the four input cotangents)."""
    tracer = ins["tracer"]
    nr, nyp, nxp = tracer.shape
    kernels.check_tensors(tracer.dtype, **ins, last=last, **outs)
    for name, t in {**ins, "last": last, **outs}.items():
        if name not in _GRID2 + _GRID1:
            kernels.check_shape(name, t, tracer.shape)
    for name in _GRID2:
        kernels.check_shape(name, ins[name], (nyp, nxp))
    kernels.check_shape("recip_drF", ins["recip_drF"], (nr,))
    kernels.check_shape("recip_drC", ins["recip_drC"], (nr + 1,))
    table = [*ins.values(), last, *outs.values()]
    kernels.launch(kernel, tracer.dtype, kernels.pointer_table(table),
                   len(table), nr, nyp - 2 * cfg.oly, nxp - 2 * cfg.olx,
                   cfg.oly, cfg.olx, diffKh, cfg.rkSign, *flags)


class CalcRhsFn(torch.autograd.Function):
    """Kernel C forward, kernel C' (kernels/csrc/gad_calc_rhs_adj.cu)
    backward: the cotangents of tracer, uTrans, vTrans and rTrans (which
    also carries rTransKp's, as the kernel derives rTransKp from it)."""

    @staticmethod
    def forward(ctx, tracer, uTrans, vTrans, rTrans, xA, yA, maskUp, kappaR,
                cfg: Config, grid: Grid, diffKh: float,
                implicit_diffusion: bool, calc_advection: bool, df=None,
                gm=None):
        args = (tracer, uTrans, vTrans, rTrans, xA, yA, maskUp, kappaR)
        gTr = torch.empty_like(tracer)
        if df is not None:
            kernels.check_tensors(tracer.dtype, df=df)
            kernels.check_shape("df", df, tracer.shape)
        flags = [int(implicit_diffusion), int(calc_advection),
                 df.data_ptr() if df is not None else 0]
        kernel = "gad_calc_rhs_c2"
        if gm is not None:
            kernel = "gad_calc_rhs_c2_gm"
            flags += _gm_table(grid, gm, tracer)
        _launch(kernel, cfg, _kernel_inputs(grid, *args), gTr, {}, diffKh,
                *flags)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(*args)
            ctx.cfg, ctx.grid, ctx.diffKh = cfg, grid, diffKh
        return gTr

    @staticmethod
    def backward(ctx, gTr_bar):
        ins = _kernel_inputs(ctx.grid, *ctx.saved_tensors)
        outs = {n + "_bar": torch.empty_like(ins[n]) for n in _DIFFERENTIABLE}
        _launch("gad_calc_rhs_c2_adj", ctx.cfg, ins, gTr_bar.contiguous(),
                outs, ctx.diffKh)
        return (*outs.values(),) + (None,) * 11


def _gm_table(grid: Grid, gm, tracer) -> list:
    """The GM launch's arguments: the table of gad_calc_rhs.cuh:GmArgs (Kux
    and Kvy null when they are 0-d, Kuz and Kvz null without
    GM_ExtraDiag), its length, and the scalar Kux and Kvy."""
    scalar = gm.Kux.dim() == 0
    fields = dict(Kwx=gm.Kwx, Kwy=gm.Kwy, maskW=grid.maskW, maskS=grid.maskS)
    if not scalar:
        fields.update(Kux=gm.Kux, Kvy=gm.Kvy)
    if gm.Kuz is not None:
        fields.update(Kuz=gm.Kuz, Kvz=gm.Kvz)
    kernels.check_fields(tracer.dtype, tracer.shape, **fields)
    table = kernels.pointer_table([fields.get(n) for n in (
        "Kux", "Kvy", "Kwx", "Kwy", "Kuz", "Kvz", "maskW", "maskS")])
    return [table, len(table), float(gm.Kux) if scalar else 0.0,
            float(gm.Kvy) if scalar else 0.0]


def calc_rhs(cfg: Config, grid: Grid, flow: AdvFlow, tracer, kappaR,
             diffKh: float, implicit_diffusion: bool = False,
             impl: str = None, df=None, calc_advection: bool = True,
             gm=None) -> torch.Tensor:
    """gad_calc_rhs.F: explicit tendency of one tracer at all levels.
    kappaR: [nr, nyp, nxp] interface diffusivities; df: an extra vertical
    flux [nr, nyp, nxp] at the interfaces (KPP's nonlocal flux) or None;
    calc_advection=False leaves the advective part out (the
    multi-dimensional advection's tracers); gm: a gmredi.GMTensor whose
    fluxes join the tracer's, or None. Differentiable in the tracer and in
    flow's transports; raises if a constant (xA, yA, maskUp, kappaR, df,
    the grid) requires grad, since the kernel gives it none, and with
    implicit_diffusion, df, gm or without calc_advection if anything
    does."""
    args = (tracer, flow.uTrans, flow.vTrans, flow.rTrans, flow.xA, flow.yA,
            flow.maskUp, kappaR)
    ins = _kernel_inputs(grid, *args)
    if df is not None:
        ins["df"] = df
    if gm is not None:
        ins.update((f"gm.{n}", t) for n, t in gm._asdict().items()
                   if t is not None)
    grads = [n for n, t in ins.items() if t.requires_grad]
    const = [n for n in grads if n not in _DIFFERENTIABLE]
    if const:
        raise ValueError(f"calc_rhs: constants {const} require grad")
    if grads and (implicit_diffusion or df is not None or gm is not None
                  or not calc_advection):
        raise ValueError(f"calc_rhs: {grads} require grad; kernel C' has no "
                         "implicit_diffusion, df, GM or no-advection branch")
    if not kernels.use_kernel(tracer, impl):
        if gm is not None:
            gmredi.plain_calls += 1
        return _calc_rhs_plain(cfg, grid, flow, tracer, kappaR, diffKh,
                               implicit_diffusion, df, calc_advection, gm)
    return CalcRhsFn.apply(*args, cfg, grid, diffKh, implicit_diffusion,
                           calc_advection, df, gm)


def calc_rhs_vjp_plain(cfg: Config, grid: Grid, flow: AdvFlow, tracer,
                       kappaR, diffKh: float, gTr_bar):
    """Kernel C''s plain twin: (tracer_bar, uTrans_bar, vTrans_bar,
    rTrans_bar) by autograd through `_calc_rhs_plain`, with rTransKp
    rebuilt from rTrans as the kernel derives it."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (tracer, flow.uTrans, flow.vTrans, flow.rTrans)]
        t, uT, vT, rT = ins
        f = flow._replace(uTrans=uT, vTrans=vT, rTrans=rT, rTransKp=torch.cat(
            [rT[1:], torch.zeros_like(rT[:1])]))
        out = _calc_rhs_plain(cfg, grid, f, t, kappaR, diffKh)
        return torch.autograd.grad(out, ins, gTr_bar)


def _calc_rhs_plain(cfg: Config, grid: Grid, flow: AdvFlow, tracer, kappaR,
                    diffKh: float, implicit_diffusion: bool = False,
                    df=None, calc_advection: bool = True,
                    gm=None) -> torch.Tensor:
    """gad.py:calc_rhs (:1038-1117) for scheme 2 without biharmonic terms,
    in its operation order: the fluxes sum as advection, diffusion, GM
    (gmredi.xy_flux, r_flux), then df."""
    fZon = torch.zeros_like(tracer)
    fMer = torch.zeros_like(tracer)
    fVer = torch.zeros_like(tracer)
    if calc_advection:
        fZon = adv_flux_x(grid, ENUM_CENTERED_2ND, flow.uTrans, None, tracer,
                          None, None)
        fMer = adv_flux_y(grid, ENUM_CENTERED_2ND, flow.vTrans, None, tracer,
                          None, None)
        fVer = adv_flux_r(grid, ENUM_CENTERED_2ND, flow.rTrans, None, tracer,
                          None) * grid.maskInC
    fZon = fZon - (diffKh * flow.xA * grid.recip_dxC
                   * (tracer - sh(tracer, di=-1)) * grid.cosFacU)
    fMer = fMer - (diffKh * flow.yA * grid.recip_dyC
                   * (tracer - sh(tracer, dj=-1)))
    if gm is not None:
        gx, gy = gmredi.xy_flux(cfg, grid, gm, flow.xA, flow.yA, tracer)
        fZon = fZon + gx
        fMer = fMer + gy
    if not implicit_diffusion:
        fVer = fVer + diff_flux_r(cfg, grid, kappaR, flow.maskUp, tracer)
    if gm is not None:
        fVer = fVer + gmredi.r_flux(cfg, grid, gm, flow.maskUp, tracer)
    if df is not None:
        fVer = fVer + df
    fVerKp = torch.cat([fVer[1:], torch.zeros_like(fVer[:1])])
    advFac = 1.0 if calc_advection else 0.0
    divTrans = ((sh(flow.uTrans, di=1) - flow.uTrans) * advFac
                + (sh(flow.vTrans, dj=1) - flow.vTrans) * advFac
                + (flow.rTransKp - flow.rTrans) * (cfg.rkSign * advFac))
    return -(grid.recip_hFacC * grid.recip_drF[:, None, None] * grid.recip_rA
             * (((sh(fZon, di=1) - fZon) + (sh(fMer, dj=1) - fMer))
                * grid.maskInC
                + (fVerKp - fVer) * cfg.rkSign
                - tracer * divTrans * grid.maskInC))


# ----------------------------------------------------------------------
# multi-dimensional advection: kernels M, O and P and their plain twins
# ----------------------------------------------------------------------

def is_multidim(cfg: Config, scheme: int) -> bool:
    """set_parms.F logic (gad.py:is_multidim): non-linear schemes use the
    multi-dimensional advection when multiDimAdvection is on."""
    return bool(cfg.multiDimAdvection) and scheme in MULTIDIM_SCHEMES


def _md_plain_x(cfg: Config, grid: Grid, flow: AdvFlow, u, v, w, tracer,
                src, scheme: int, vert_scheme: int, deltaT: float):
    """The X pass of gad.py:multidim_advection (:1138-1142)."""
    uT = flow.uTrans
    af = adv_flux_x(grid, scheme, uT, u, src, deltaT,
                    grid.maskW * grid.maskInW)
    return src - deltaT * grid.recip_hFacC * grid.recip_drF[:, None, None] \
        * grid.recip_rA * ((sh(af, di=1) - af)
                           - tracer * (sh(uT, di=1) - uT)) * grid.maskInC


def _md_plain_y(cfg: Config, grid: Grid, flow: AdvFlow, u, v, w, tracer,
                src, scheme: int, vert_scheme: int, deltaT: float):
    """The Y pass (:1143-1147), on the X pass's field; the compensation
    keeps the old tracer."""
    vT = flow.vTrans
    af = adv_flux_y(grid, scheme, vT, v, src, deltaT,
                    grid.maskS * grid.maskInS)
    return src - deltaT * grid.recip_hFacC * grid.recip_drF[:, None, None] \
        * grid.recip_rA * ((sh(af, dj=1) - af)
                           - tracer * (sh(vT, dj=1) - vT)) * grid.maskInC


def _md_plain_r(cfg: Config, grid: Grid, flow: AdvFlow, u, v, w, tracer,
                src, scheme: int, vert_scheme: int, deltaT: float):
    """The R pass on the post-horizontal field (:1148-1154), and gTracer =
    (T_advected - T) / deltaT."""
    fVer = adv_flux_r(grid, vert_scheme, flow.rTrans, w, src, deltaT)
    fVerKp = torch.cat([fVer[1:], torch.zeros_like(fVer[:1])])
    localT = src - deltaT * grid.recip_hFacC * grid.recip_drF[:, None, None] \
        * grid.recip_rA * ((fVerKp - fVer)
                           - tracer * (flow.rTransKp - flow.rTrans)) \
        * cfg.rkSign * grid.maskInC
    return _div(localT - tracer, deltaT)


# the kernels of the sweeps: M (gad_multidim.cu), O (gad_os7mp.cu) and P
# (gad_ppm.cu), each as its X, Y and R launches, with the schemes each owns
# per direction
_OWNERS = {
    "M": ("gad_multidim", (ENUM_UPWIND_1RST, ENUM_DST2, ENUM_DST3,
                           ENUM_DST3_FLUX_LIMIT, ENUM_FLUX_LIMIT),
          (ENUM_UPWIND_1RST, ENUM_CENTERED_2ND, ENUM_UPWIND_3RD,
           ENUM_CENTERED_4TH, ENUM_DST2, ENUM_DST3, ENUM_DST3_FLUX_LIMIT,
           ENUM_FLUX_LIMIT)),
    "O": ("gad_os7mp", (ENUM_OS7MP,), (ENUM_OS7MP,)),
    "P": ("gad_ppm", PPM_PQM_SCHEMES, PPM_PQM_SCHEMES),
}
DIRECTIONS = ("x", "y", "r")
SWEEPS = tuple(f"{stem}_{d}" for stem, _, _ in _OWNERS.values()
               for d in DIRECTIONS)
# each sweep's plain twin
MD_PLAIN = {name: (_md_plain_x, _md_plain_y, _md_plain_r)[n % 3]
            for n, name in enumerate(SWEEPS)}


def sweep_owner(scheme: int, direction: str) -> str:
    """The letter of the kernel that runs the X, Y or R sweep of a scheme
    ("M", "O" or "P")."""
    for letter, (_, horizontal, vertical) in _OWNERS.items():
        if scheme in (vertical if direction == "r" else horizontal):
            return letter
    raise NotImplementedError(
        f"{'vertical ' if direction == 'r' else ''}multidim advection "
        f"scheme {scheme}")


def sweep_name(scheme: int, direction: str) -> str:
    """The kernel name of the X, Y or R sweep of a scheme."""
    return f"{_OWNERS[sweep_owner(scheme, direction)][0]}_{direction}"


# the grid fields of gad_advect.cuh:AdvArgs, in its order
_MD_GRID3 = ("maskW", "maskS", "maskC", "recip_hFacC")
_MD_GRID2 = ("recip_dxC", "recip_dyC", "recip_rA", "maskInC", "maskInW",
             "maskInS", "dxF", "dyF", "recip_dxF", "recip_dyF")
_MD_GRID1 = ("recip_drF", "recip_drC", "drF")
def _multidim_plain(cfg: Config, grid: Grid, flow: AdvFlow, u, v, w, tracer,
                    scheme: int, vert_scheme: int, deltaT: float):
    """The kernels' twin: gad.py:multidim_advection (:1120-1154), Cartesian
    branch, in its operation order, one function per sweep."""
    global plain_calls
    plain_calls += 1
    field = tracer
    for twin in (_md_plain_x, _md_plain_y, _md_plain_r):
        field = twin(cfg, grid, flow, u, v, w, tracer, field, scheme,
                     vert_scheme, deltaT)
    return field


def multidim_sweeps(cfg: Config, grid: Grid, flow: AdvFlow, u, v, w, tracer,
                    scheme: int, vert_scheme: int, deltaT: float, add=None):
    """The three sweeps on the card, each a launch of the kernel that owns
    its scheme: a list of (sweep name, launch, input, output), in the order
    they must run; each launch reads the previous one's output and the
    last output is gTr, or gTr + add with add (the R sweep adds it)."""
    nr, nyp, nxp = tracer.shape
    schemes = (scheme, scheme, vert_scheme)
    names = [sweep_name(s, d) for s, d in zip(schemes, DIRECTIONS)]
    ins3 = dict(uTrans=flow.uTrans, vTrans=flow.vTrans, rTrans=flow.rTrans,
                uVel=u, vVel=v, wVel=w, tracer=tracer,
                **{n: getattr(grid, n) for n in _MD_GRID3})
    ins2 = {n: getattr(grid, n) for n in _MD_GRID2}
    ins1 = {n: getattr(grid, n) for n in _MD_GRID1}
    fields = [tracer] + [torch.empty_like(tracer) for _ in DIRECTIONS]
    kernels.check_tensors(tracer.dtype, **ins3, **ins2, **ins1,
                          localX=fields[1], localY=fields[2], gTr=fields[3],
                          **({} if add is None else {"add": add}))
    for name, t in ins3.items():
        kernels.check_shape(name, t, (nr, nyp, nxp))
    if add is not None:
        kernels.check_shape("add", add, (nr, nyp, nxp))
    for name, t in ins2.items():
        kernels.check_shape(name, t, (nyp, nxp))
    kernels.check_shape("recip_drF", ins1["recip_drF"], (nr,))
    kernels.check_shape("recip_drC", ins1["recip_drC"], (nr + 1,))
    kernels.check_shape("drF", ins1["drF"], (nr,))
    named = {**ins3, **ins2, **ins1}
    table = kernels.pointer_table(list(named.values()))

    def sweep(name, direction, src, dst, sch):
        addend = add if direction == "r" and add is not None else None

        def run():
            kernels.launch(name, tracer.dtype, table, len(table),
                           src.data_ptr(), dst.data_ptr(),
                           None if addend is None else addend.data_ptr(), nr,
                           nyp, nxp, sch, float(deltaT), float(cfg.rkSign))
        return name, run, src, dst

    return [sweep(name, d, fields[n], fields[n + 1], sch)
            for n, (name, d, sch) in enumerate(zip(names, DIRECTIONS,
                                                   schemes))]


def multidim_advection(cfg: Config, grid: Grid, flow: AdvFlow, u, v, w,
                       tracer, scheme: int, vert_scheme: int, deltaT: float,
                       impl: str = None, add=None) -> torch.Tensor:
    """Direction-split multi-dimensional advection (gad_advection.F, the
    default non-compressible form, Cartesian pass order X, Y, R) of a
    scheme of MULTIDIM_SCHEMES with a vertical scheme of VERT_SCHEMES:
    returns gTracer = (T_advected - T) / deltaT at every cell of the padded
    array, or gTracer + add with add (the tracer's other tendency: the
    last sweep's kernel adds it as it writes, the twin after)."""
    owners = sorted({sweep_owner(s, d) for s, d in zip(
        (scheme, scheme, vert_scheme), DIRECTIONS)})
    ins = (u, v, w, tracer, flow.uTrans, flow.vTrans, flow.rTrans, add)
    if any(t is not None and t.requires_grad for t in ins):
        raise ValueError(
            "multidim_advection: an input requires grad; "
            f"{' and '.join(f'kernel {k}' for k in owners)} "
            f"{'has' if len(owners) == 1 else 'have'} no backward kernel")
    if not kernels.use_kernel(tracer, impl):
        gTr = _multidim_plain(cfg, grid, flow, u, v, w, tracer, scheme,
                              vert_scheme, deltaT)
        return gTr if add is None else gTr + add
    sweeps = multidim_sweeps(cfg, grid, flow, u, v, w, tracer, scheme,
                             vert_scheme, deltaT, add)
    for _, run, _, _ in sweeps:
        run()
    return sweeps[-1][3]
