"""Generic advection-diffusion (mitgcm_tpu/model/gad.py) for centred
2nd-order advection (scheme 2) with Laplacian horizontal and explicit
vertical diffusion.

`calc_rhs` runs kernel C (kernels/csrc/gad_calc_rhs.cu) for CUDA tensors,
with kernel C' (gad_calc_rhs_adj.cu) as its backward, and the plain
PyTorch twin `_calc_rhs_plain`, differentiated by autograd, for CPU
tensors or when impl="plain" is asked for. The kernel writes zero halo
cells; both agree on the interior. With implicit_diffusion the explicit
vertical diffusive flux is left out (the implicit solve,
thermodynamics.impldiff, takes its place). An extra vertical flux `df`
(KPP's nonlocal flux) is added to fVer before the divergence. Kernel C' has
neither branch, so those variants refuse gradients.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.ops.stencil import shift as sh
from mitgcm_tpu_torch.ops.stencil import shift_k


class AdvFlow(NamedTuple):
    uTrans: torch.Tensor    # [nr, nyp, nxp]
    vTrans: torch.Tensor
    rTrans: torch.Tensor    # at interface k (surface index 0 = 0)
    rTransKp: torch.Tensor  # at interface k+1 (bottom = 0)
    maskUp: torch.Tensor
    xA: torch.Tensor
    yA: torch.Tensor


def calc_adv_flow(grid: Grid, u, v, w) -> AdvFlow:
    """model/src/calc_adv_flow.F, all levels at once."""
    drF = grid.drF[:, None, None]
    xA = grid.dyG * drF * grid.hFacW
    yA = grid.dxG * drF * grid.hFacS
    mC = grid.maskC
    maskUp = torch.cat([torch.zeros_like(mC[:1]), mC[1:] * mC[:-1]])
    rTrans = w * grid.rA * maskUp
    rTransKp = torch.cat([rTrans[1:], torch.zeros_like(rTrans[:1])])
    return AdvFlow(uTrans=u * xA, vTrans=v * yA, rTrans=rTrans,
                   rTransKp=rTransKp, maskUp=maskUp, xA=xA, yA=yA)


def adv_flux_x(uTrans, tracer):
    """Scheme-2 zonal advective flux at the west face (gad_c2_adv_x.F)."""
    return uTrans * 0.5 * (tracer + sh(tracer, di=-1))


def adv_flux_y(vTrans, tracer):
    return vTrans * 0.5 * (tracer + sh(tracer, dj=-1))


def adv_flux_r(grid: Grid, rTrans, tracer):
    """Scheme-2 vertical advective flux at interface k, zero at the surface
    (gad_c2_adv_r.F); the k-1 neighbours are clamped at the top."""
    tkm1 = torch.cat([tracer[:1], tracer[:-1]])
    mkm1 = torch.cat([grid.maskC[:1], grid.maskC[:-1]])
    flx = mkm1 * rTrans * 0.5 * (tracer + tkm1)
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
            diffKh: float, *flags: int) -> None:
    """Check and launch kernel C (last = gTr, flags = (implicit_diffusion,
    the pointer of df or 0)) or C' (last = the cotangent of gTr, outs = the
    four input cotangents)."""
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
                implicit_diffusion: bool, df=None):
        args = (tracer, uTrans, vTrans, rTrans, xA, yA, maskUp, kappaR)
        gTr = torch.empty_like(tracer)
        if df is not None:
            kernels.check_tensors(tracer.dtype, df=df)
            kernels.check_shape("df", df, tracer.shape)
        _launch("gad_calc_rhs_c2", cfg, _kernel_inputs(grid, *args), gTr,
                {}, diffKh, int(implicit_diffusion),
                df.data_ptr() if df is not None else 0)
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
        return (*outs.values(),) + (None,) * 9


def calc_rhs(cfg: Config, grid: Grid, flow: AdvFlow, tracer, kappaR,
             diffKh: float, implicit_diffusion: bool = False,
             impl: str = None, df=None) -> torch.Tensor:
    """gad_calc_rhs.F: explicit tendency of one tracer at all levels.
    kappaR: [nr, nyp, nxp] interface diffusivities; df: an extra vertical
    flux [nr, nyp, nxp] at the interfaces (KPP's nonlocal flux) or None.
    Differentiable in the tracer and in flow's transports; raises if a
    constant (xA, yA, maskUp, kappaR, df, the grid) requires grad, since
    the kernel gives it none, and with implicit_diffusion or df if anything
    does."""
    args = (tracer, flow.uTrans, flow.vTrans, flow.rTrans, flow.xA, flow.yA,
            flow.maskUp, kappaR)
    ins = _kernel_inputs(grid, *args)
    if df is not None:
        ins["df"] = df
    grads = [n for n, t in ins.items() if t.requires_grad]
    const = [n for n in grads if n not in _DIFFERENTIABLE]
    if const:
        raise ValueError(f"calc_rhs: constants {const} require grad")
    if grads and (implicit_diffusion or df is not None):
        raise ValueError(f"calc_rhs: {grads} require grad; kernel C' has no "
                         "implicit_diffusion or df branch")
    if not kernels.use_kernel(tracer, impl):
        return _calc_rhs_plain(cfg, grid, flow, tracer, kappaR, diffKh,
                               implicit_diffusion, df)
    return CalcRhsFn.apply(*args, cfg, grid, diffKh, implicit_diffusion, df)


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
                    df=None) -> torch.Tensor:
    """gad.py:calc_rhs (:1038-1117) without GM or biharmonic terms, in its
    operation order."""
    fZon = adv_flux_x(flow.uTrans, tracer)
    fMer = adv_flux_y(flow.vTrans, tracer)
    fZon = fZon - (diffKh * flow.xA * grid.recip_dxC
                   * (tracer - sh(tracer, di=-1)) * grid.cosFacU)
    fMer = fMer - (diffKh * flow.yA * grid.recip_dyC
                   * (tracer - sh(tracer, dj=-1)))
    fVer = adv_flux_r(grid, flow.rTrans, tracer) * grid.maskInC
    if not implicit_diffusion:
        fVer = fVer + diff_flux_r(cfg, grid, kappaR, flow.maskUp, tracer)
    if df is not None:
        fVer = fVer + df
    fVerKp = torch.cat([fVer[1:], torch.zeros_like(fVer[:1])])
    divTrans = ((sh(flow.uTrans, di=1) - flow.uTrans)
                + (sh(flow.vTrans, dj=1) - flow.vTrans)
                + (flow.rTransKp - flow.rTrans) * cfg.rkSign)
    return -(grid.recip_hFacC * grid.recip_drF[:, None, None] * grid.recip_rA
             * (((sh(fZon, di=1) - fZon) + (sh(fMer, dj=1) - fMer))
                * grid.maskInC
                + (fVerKp - fVer) * cfg.rkSign
                - tracer * divTrans * grid.maskInC))
