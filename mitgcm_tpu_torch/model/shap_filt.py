"""The Shapiro filter (mitgcm_tpu/model/shap_filt.py; reference
pkg/shap_filt) on a Cartesian grid: the S2 filter function (Shap_funct 2
or 20), nShapUV passes of -1/8 L^2 times the Laplacian on the velocity
pair after the momentum correction (shap_filt_uvStar=F), and nShapT passes
on theta and salt after the tracers are stepped.

Each pass writes the cells [1, nyp - 1) x [1, nxp - 1) of its field; the
outermost ring keeps the value the pass read (the JAX code's `wr` mask,
shap_filt.py:172-178). The velocity filter fills the pair's halos on odd
passes (and on every pass with Shap_alwaysExchUV), the tracer filter on
odd passes from the third on (its input's halos are current, exchInOut=2).
Index-space passes difference the field cell by cell; physical passes
take the metrics: the velocity's Laplacian from its divergence and
vorticity (`_del2uv`, the JAX code's mom_vecinv.del2uv, which is not
kernel Y's vector-invariant function: no sideMaskFac at closed corners),
scaled by rA and rAz when Shap_uvLength < 0, by rAw and rAs when it is 0,
by its square otherwise; the tracer's with its open fractions, scaled by
Shap_TrLength^2 / rA when that is set.

`apply_uv` and `apply_ts` run kernels SH-uv and SH-ts
(kernels/csrc/shap_filt.cu), one launch a pass of each field pair or
tracer, on CUDA tensors: a pass that fills reads its input through the
cyclic wrap of its halo (the fill's gather folded into the pass), the
first velocity pass masks u and v as it reads them, and the last forms
fld - tmp * fac. The plain twins (`apply_uv_plain`, `apply_ts_plain`) run
on CPU tensors or with impl="plain". Neither has a backward kernel; the
adjoint refuses useSHAP_FILT.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model.gad import _div
from mitgcm_tpu_torch.model.mom_fluxform import calc_hfacz
from mitgcm_tpu_torch.model.mom_vecinv import calc_hdiv, calc_relvort3
from mitgcm_tpu_torch.ops.stencil import cyclic_fill_halo
from mitgcm_tpu_torch.ops.stencil import shift as sh

# calls of the twins (a run on the card reads it to show that its kernel
# path never did)
plain_calls = 0


@dataclass
class ShapParams:
    """SHAP_PARM01 namelist (shap_filt_readparms.F)."""
    Shap_funct: int = 2
    nShapT: int = 0
    nShapS: int = -1
    nShapUV: int = 0
    nShapTrPhys: int = 0
    nShapUVPhys: int = 0
    Shap_Trtau: float = 0.0      # defaults to deltaTTracer
    Shap_TrLength: float = 0.0
    Shap_uvtau: float = 0.0      # defaults to deltaTMom
    Shap_uvLength: float = 0.0
    shap_filt_uvStar: bool = True
    shap_filt_TrStagg: bool = True
    Shap_alwaysExchUV: bool = False


def from_namelist(group: dict, cfg: Config) -> ShapParams:
    """ShapParams from a SHAP_PARM01 group, with shap_filt_readparms.F's
    defaults: nShapS = nShapT, the taus the model's time steps, and the
    exchange on every pass for Shap_funct 1, 4 and 21."""
    p = ShapParams()
    for k, v in (group or {}).items():
        kl = k.lower()
        for f in p.__dataclass_fields__:
            if f.lower() == kl:
                setattr(p, f, type(getattr(p, f))(v))
    if p.nShapS < 0:
        p.nShapS = p.nShapT
    if p.Shap_Trtau == 0.0:
        p.Shap_Trtau = cfg.deltaTTracer
    if p.Shap_uvtau == 0.0:
        p.Shap_uvtau = cfg.deltaTMom
    if p.Shap_funct in (1, 4, 21):
        p.Shap_alwaysExchUV = True
    return p


def refusals(cfg: Config) -> dict:
    """The Shapiro settings the port refuses, by name: Shap_funct other than
    2 or 20 and a mix of physical and index-space velocity passes (the JAX
    code raises on both), and two that the JAX step drops silently: the
    filter of u* and v* inside the dynamics (shap_filt_uvStar=T, which it
    never applies) and a salt filter of its own (nShapS, which it never
    reads: it filters salt nShapT times)."""
    p = cfg.shap
    if not cfg.useSHAP_FILT:
        return {}
    if not isinstance(p, ShapParams):
        return {"useSHAP_FILT without ShapParams (cfg.shap)": True}
    uv = p.nShapUV > 0 and p.Shap_uvtau > 0.0
    ts = p.nShapT > 0 and p.Shap_Trtau > 0.0
    return {
        f"Shap_funct={p.Shap_funct}": (uv or ts)
        and p.Shap_funct not in (2, 20),
        f"nShapUVPhys={p.nShapUVPhys} with nShapUV={p.nShapUV}":
            uv and p.nShapUVPhys not in (0, p.nShapUV),
        "shap_filt_uvStar=T with nShapUV>0": uv and p.shap_filt_uvStar,
        f"nShapS={p.nShapS} != nShapT={p.nShapT}": p.nShapS != p.nShapT,
    }


def _ring(shape, dtype, device) -> torch.Tensor:
    """The cells a pass writes: 1 on [1, nyp - 1) x [1, nxp - 1), 0 on the
    outermost ring."""
    wr = torch.zeros(tuple(shape[-2:]), dtype=dtype, device=device)
    wr[1:-1, 1:-1] = 1.0
    return wr


def _del2uv(grid: Grid, hDiv, vort3, hFacZ):
    """The Laplacian of (u, v) from divergence and vorticity on a Cartesian
    grid (the JAX code's mom_vecinv.del2uv, mom_vi_del2uv.F)."""
    hv = hFacZ * vort3
    d2u = ((hDiv - sh(hDiv, di=-1)) * grid.recip_dxC
           - grid.recip_hFacW * (sh(hv, dj=1) - hv) * grid.recip_dyG
           ) * grid.maskW
    d2v = ((hDiv - sh(hDiv, dj=-1)) * grid.recip_dyC
           + grid.recip_hFacS * (sh(hv, di=1) - hv) * grid.recip_dxG
           ) * grid.maskS
    return d2u, d2v


def _uv_pass_plain(cfg: Config, grid: Grid, shp: ShapParams, tmpU, tmpV):
    """One S2 pass on the velocity pair (shap_filt.py:179-219 of the JAX
    package): the new values at every cell, before the ring is kept."""
    if shp.nShapUVPhys == 0:
        hDiv = (sh(tmpU, di=1) - tmpU) + (sh(tmpV, dj=1) - tmpV)
        vort3 = ((tmpV - sh(tmpV, di=-1)) - (tmpU - sh(tmpU, dj=-1)))
        maskZ = ((grid.maskW + sh(grid.maskW, dj=-1))
                 * (grid.maskS + sh(grid.maskS, di=-1)))
        vort3 = torch.where(maskZ < 1.0, 0.0, vort3)
        newU = -0.125 * ((hDiv - sh(hDiv, di=-1))
                         - (sh(vort3, dj=1) - vort3)) * grid.maskW
        newV = -0.125 * ((hDiv - sh(hDiv, dj=-1))
                         + (sh(vort3, di=1) - vort3)) * grid.maskS
        return newU, newV
    hDiv = calc_hdiv(grid, tmpU, tmpV)
    vort3 = calc_relvort3(grid, tmpU, tmpV)
    if shp.Shap_uvLength < 0.0:
        hDiv = hDiv * grid.rA
        vort3 = vort3 * grid.rAz
    d2u, d2v = _del2uv(grid, hDiv, vort3, calc_hfacz(grid))
    if shp.Shap_uvLength < 0.0:
        return -0.125 * d2u * grid.maskW, -0.125 * d2v * grid.maskS
    if shp.Shap_uvLength == 0.0:
        return (-0.125 * d2u * grid.rAw * grid.maskW,
                -0.125 * d2v * grid.rAs * grid.maskS)
    L2 = shp.Shap_uvLength ** 2
    return -0.125 * d2u * L2 * grid.maskW, -0.125 * d2v * L2 * grid.maskS


def apply_uv_plain(cfg: Config, grid: Grid, shp: ShapParams, u, v):
    """SH-uv's twin: SHAP_FILT_APPLY_UV -> SHAP_FILT_UV_S2 (JAX
    shap_filt.py:150-221), nShapUV passes and u - tmpU * fac."""
    def fill(a):
        return cyclic_fill_halo(a, cfg.oly, cfg.olx, impl="plain")

    tmpU = u * grid.maskW
    tmpV = v * grid.maskS
    wr = _ring(u.shape, u.dtype, u.device)
    for n in range(1, shp.nShapUV + 1):
        if n % 2 == 1 or shp.Shap_alwaysExchUV:
            tmpU, tmpV = fill(tmpU), fill(tmpV)
        newU, newV = _uv_pass_plain(cfg, grid, shp, tmpU, tmpV)
        tmpU = torch.where(wr > 0, newU, tmpU)
        tmpV = torch.where(wr > 0, newV, tmpV)
    fac = cfg.deltaTMom / shp.Shap_uvtau
    return u - tmpU * fac, v - tmpV * fac


def _ts_pass_plain(grid: Grid, shp: ShapParams, tmp, physical: bool):
    """One S2 pass on a tracer (shap_filt.py:246-262 of the JAX package):
    the new values at every cell, before the ring is kept."""
    if not physical:
        fdx = (tmp - sh(tmp, di=-1)) * grid.maskW
        fdy = (tmp - sh(tmp, dj=-1)) * grid.maskS
        grd = (sh(fdx, di=1) - fdx) + (sh(fdy, dj=1) - fdy)
        return -0.125 * grd
    fdx = (tmp - sh(tmp, di=-1)) * grid.hFacW * grid.dyG * grid.recip_dxC
    fdy = (tmp - sh(tmp, dj=-1)) * grid.hFacS * grid.dxG * grid.recip_dyC
    grd = (sh(fdx, di=1) - fdx) + (sh(fdy, dj=1) - fdy)
    new = -0.125 * grd * grid.recip_hFacC
    if shp.Shap_TrLength > 0.0:
        new = new * grid.recip_rA * shp.Shap_TrLength ** 2
    return new


def apply_ts_plain(cfg: Config, grid: Grid, shp: ShapParams, fld):
    """SH-ts's twin on one tracer: SHAP_FILT_TRACER_S2 (JAX
    shap_filt.py:224-264), nShapT passes, the first nShapT - nShapTrPhys
    in index space, and fld - tmp * deltaTTracer / Shap_Trtau (divided as
    a tensor: one IEEE division on every device, as the kernel divides)."""
    nComput = shp.nShapT - shp.nShapTrPhys
    wr = _ring(fld.shape, fld.dtype, fld.device)
    tmp = fld
    for n in range(1, shp.nShapT + 1):
        if n % 2 == 1 and n >= 2:
            tmp = cyclic_fill_halo(tmp, cfg.oly, cfg.olx, impl="plain")
        new = _ts_pass_plain(grid, shp, tmp, n > nComput)
        tmp = torch.where(wr > 0, new, tmp)
    return fld - _div(tmp * cfg.deltaTTracer, shp.Shap_Trtau)


# grid fields that SH-uv and SH-ts read, in the order of
# kernels/csrc/shap_filt.cuh:ShapArgs (3-D, then 2-D)
_GRID3 = ("maskW", "maskS", "hFacW", "hFacS", "recip_hFacW", "recip_hFacS",
          "recip_hFacC")
_GRID2 = ("dxG", "dyG", "dxC", "dyC", "rA", "rAz", "rAw", "rAs", "recip_rA",
          "recip_rAz", "recip_dxC", "recip_dyC", "recip_dxG", "recip_dyG")


def _launch(kernel: str, cfg: Config, grid: Grid, ins, outs, flags,
            params) -> None:
    """Check and launch SH-uv or SH-ts: `ins` the pass's input fields
    (kernels/csrc/shap_filt.cuh:ShapArgs' first four), `outs` its two
    outputs (SH-ts: the second None)."""
    like = ins[0]
    nr, nyp, nxp = like.shape
    g3 = [getattr(grid, n) for n in _GRID3]
    g2 = [getattr(grid, n) for n in _GRID2]
    kernels.check_fields(like.dtype, like.shape, **{
        f"in{k}": t for k, t in enumerate(ins) if t is not None},
        **dict(zip(_GRID3, g3)), **{
            f"out{k}": t for k, t in enumerate(outs) if t is not None})
    kernels.check_fields(like.dtype, (nyp, nxp), **dict(zip(_GRID2, g2)))
    table = [*ins, *g3, *g2, *outs]
    kernels.launch(kernel, like.dtype, kernels.pointer_table(table),
                   len(table), kernels.doubles(params), len(params), nr,
                   nyp, nxp, cfg.oly, cfg.olx, *flags)


def _uv_kernel(cfg: Config, grid: Grid, shp: ShapParams, u, v):
    """Kernel SH-uv's passes on the card (shap_filt.cu)."""
    length = (-1 if shp.Shap_uvLength < 0.0 else
              0 if shp.Shap_uvLength == 0.0 else 1)
    params = [cfg.deltaTMom / shp.Shap_uvtau, shp.Shap_uvLength ** 2]
    tmpU, tmpV = u, v
    for n in range(1, shp.nShapUV + 1):
        fill = n % 2 == 1 or shp.Shap_alwaysExchUV
        last = n == shp.nShapUV
        outs = (torch.empty_like(u), torch.empty_like(v))
        _launch("shap_uv", cfg, grid, (tmpU, tmpV, u, v), outs,
                (int(fill), int(n == 1), int(last),
                 int(shp.nShapUVPhys > 0), length), params)
        tmpU, tmpV = outs
    return tmpU, tmpV


def _ts_kernel(cfg: Config, grid: Grid, shp: ShapParams, fld):
    """Kernel SH-ts's passes on one tracer on the card (shap_filt.cu)."""
    nComput = shp.nShapT - shp.nShapTrPhys
    params = [cfg.deltaTTracer, shp.Shap_Trtau, shp.Shap_TrLength ** 2]
    tmp = fld
    for n in range(1, shp.nShapT + 1):
        out = torch.empty_like(fld)
        _launch("shap_ts", cfg, grid, (tmp, None, fld, None), (out, None),
                (int(n % 2 == 1 and n >= 2), 0, int(n == shp.nShapT),
                 int(n > nComput), int(shp.Shap_TrLength > 0.0)), params)
        tmp = out
    return tmp


def _refuse_grad(fn: str, **tensors) -> None:
    grads = [n for n, t in tensors.items() if t.requires_grad]
    if grads:
        raise ValueError(f"{fn}: {grads} require grad; kernels SH-uv and "
                         "SH-ts have no backward kernel")


def apply_uv(cfg: Config, grid: Grid, shp: ShapParams, u, v,
             impl: str = None):
    """The filtered (u, v) (shap_filt_apply_uv.F; JAX shap_filt.py:150),
    or (u, v) themselves when nShapUV or Shap_uvtau is 0: kernel SH-uv on
    CUDA tensors, its twin on CPU tensors or with impl="plain"."""
    if shp.nShapUV <= 0 or shp.Shap_uvtau <= 0.0:
        return u, v
    _refuse_grad("shap_filt.apply_uv", u=u, v=v)
    if not kernels.use_kernel(u, impl):
        global plain_calls
        plain_calls += 1
        return apply_uv_plain(cfg, grid, shp, u, v)
    return _uv_kernel(cfg, grid, shp, u, v)


def apply_ts(cfg: Config, grid: Grid, shp: ShapParams, theta, salt,
             impl: str = None):
    """The filtered (theta, salt) (shap_filt_apply_ts.F; JAX
    shap_filt.py:224), both nShapT times, from fields with current halos;
    (theta, salt) themselves when nShapT or Shap_Trtau is 0: kernel SH-ts
    on CUDA tensors, its twin on CPU tensors or with impl="plain"."""
    if shp.nShapT <= 0 or shp.Shap_Trtau <= 0.0:
        return theta, salt
    _refuse_grad("shap_filt.apply_ts", theta=theta, salt=salt)
    if not kernels.use_kernel(theta, impl):
        global plain_calls
        plain_calls += 2
        return (apply_ts_plain(cfg, grid, shp, theta),
                apply_ts_plain(cfg, grid, shp, salt))
    return _ts_kernel(cfg, grid, shp, theta), _ts_kernel(cfg, grid, shp,
                                                         salt)
