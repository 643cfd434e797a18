"""GM-Redi mesoscale eddy parameterization (mitgcm_tpu/model/gmredi.py):
the skew-flux form (GM_AdvForm=F) and the advective (bolus) form
(GM_AdvForm=T, with the GM_ExtraDiag off-diagonal Redi terms when isopycK
is not 0), constant K, every taper scheme of the JAX package's
`_slope_limit` and `_slope_psi`, in z-coordinates.

The port's own copies of `GMParams` and `from_namelist`, and the plain
twins of the JAX functions under their names and signatures, each in the
JAX code's operation order: `calc_tensor` (with `_slope_limit`), `xy_flux`,
`r_flux`, `calc_psi_b` (with `_slope_psi`) and `residual_flow`. A twin
divides by a tensor where JAX divides by or into a Python number
(`_div`, `_rdiv`): PyTorch's CUDA kernels multiply by the reciprocal.

The wrappers that the step calls run a CUDA kernel on CUDA tensors
(kernels/csrc/gmredi.cu) and the twin on CPU tensors or with
impl="plain": `gm_tensor` (kernel gm_tensor: sigmaX and sigmaY from the
in-situ density, as step.py:927-930 of the JAX package, then the tensor),
`gm_psi_b` (kernel gm_psi_b) and `gm_residual_flow` (kernel
gm_residual_flow). xy_flux and r_flux run inside kernel C's GM branch
(model/gad.py:calc_rhs). No kernel has a backward kernel: the wrappers
refuse inputs that require grad, and the adjoint refuses useGMRedi.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.ops.stencil import shift as sh
from mitgcm_tpu_torch.ops.stencil import shift_k

# calls of the twins of gm_tensor, gm_psi_b, gm_residual_flow and of kernel
# C's GM branch (model/gad.py:calc_rhs), for the card's runs to show that
# the main path never ran them
plain_calls = 0

# the taper schemes of _slope_limit, by kernel enum (gmredi.cuh:GmTaper);
# "", "clipping" and "orig" all clip the slope
TAPERS = {"": 0, "clipping": 0, "orig": 0, "gkw91": 1, "linear": 2,
          "dm95": 3, "ldd97": 4, "ac02": 5}
# the schemes _slope_psi takes (the bolus form), by kernel enum: ac02 tapers
# as gkw91 there, and ldd97 is refused
PSI_TAPERS = {"": 0, "clipping": 0, "orig": 0, "gkw91": 1, "ac02": 1,
              "linear": 2, "dm95": 3}
# ldd97's first baroclinic Rossby radius (gmredi_calc_tensor.F:111-156)
_CSPD, _LRHO_INF, _LRHO_SUP = 2.0, 15.0e3, 100.0e3


@dataclass(frozen=True)
class GMParams:
    """The port's copy of the JAX package's GMParams (gmredi.py:32-57),
    field for field (tests/test_torch_config.py:jax_config converts it)."""
    background_K: float = 0.0
    isopycK: float = -999.0
    taper_scheme: str = ""
    maxSlope: float = 1.0e-2
    Kmin_horiz: float = 0.0
    Scrit: float = 0.004
    Sd: float = 0.001
    small_number: float = 1.0e-20
    slopeSqCutoff: float = 1.0e48
    bigSlope: float = 99999.0
    advForm: bool = False
    # GM_NON_UNITY_DIAGONAL: True, Kux/Kvy tapered per point with slopes
    # recomputed at U/V points; False, the constant isopycK (the lab_sea
    # setting), as 0-d tensors
    nonUnityDiagonal: bool = True

    def resolved_isopycK(self) -> float:
        return self.background_K if self.isopycK == -999.0 else self.isopycK

    def extra_diag(self) -> bool:
        """GM_ExtraDiag: the bolus form with isopycK != 0 carries Kuz/Kvz."""
        return self.advForm and self.resolved_isopycK() != 0.0


def from_namelist(nml_group: dict) -> GMParams:
    """GMParams from a GM_PARM01 namelist group (keys in any case); refuses
    GM_Visbeck_alpha != 0 (variable K)."""
    g = {k.lower(): v for k, v in nml_group.items()}
    if float(g.get("gm_visbeck_alpha", 0.0)) != 0.0:
        raise NotImplementedError("GM_Visbeck_alpha != 0 (variable K)")
    return GMParams(
        background_K=float(g.get("gm_background_k", 0.0)),
        isopycK=float(g.get("gm_isopyck", -999.0)),
        taper_scheme=str(g.get("gm_taper_scheme", "")),
        maxSlope=float(g.get("gm_maxslope", 1.0e-2)),
        Kmin_horiz=float(g.get("gm_kmin_horiz", 0.0)),
        Scrit=float(g.get("gm_scrit", 0.004)),
        Sd=float(g.get("gm_sd", 0.001)),
        advForm=bool(g.get("gm_advform", False)),
    )


def check_gmredi(cfg: Config) -> None:
    """Raise NotImplementedError, naming each, for the GM-Redi settings off
    the ported path: no GMParams, p-coordinates, variable K (a nonzero
    GM_Visbeck_alpha left among cfg.extra's namelist entries), a taper
    scheme _slope_limit does not know, and with the bolus form one that
    _slope_psi refuses (ldd97)."""
    gm = cfg.gmredi
    if not isinstance(gm, GMParams):
        raise NotImplementedError(
            "useGMRedi needs cfg.gmredi as a GMParams, not "
            f"{type(gm).__name__}")
    visbeck = [k for k, v in cfg.extra.items()
               if k.lower() == "gm_visbeck_alpha" and float(v) != 0.0]
    off = {
        "p-coordinates": cfg.usingPCoords or not cfg.usingZCoords,
        "GM_Visbeck_alpha != 0 (variable K)": bool(visbeck),
        f"GM_taper_scheme={gm.taper_scheme!r}": gm.taper_scheme not in TAPERS,
        f"GM_taper_scheme={gm.taper_scheme!r} with GM_AdvForm": (
            gm.advForm and gm.taper_scheme in TAPERS
            and gm.taper_scheme not in PSI_TAPERS),
    }
    bad = [name for name, is_off in off.items() if is_off]
    if bad:
        raise NotImplementedError(f"GM-Redi: not ported: {', '.join(bad)}")


class GMTensor(NamedTuple):
    Kux: torch.Tensor   # [nr, nyp, nxp] at U points, or 0-d (isopycK)
    Kvy: torch.Tensor   # at V points
    Kwx: torch.Tensor   # [nr, nyp, nxp] at upper interfaces (row 0 zero)
    Kwy: torch.Tensor
    Kwz: torch.Tensor
    # GM_ExtraDiag's off-diagonal horizontal-flux components, or None
    Kuz: Optional[torch.Tensor] = None
    Kvz: Optional[torch.Tensor] = None


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c as one IEEE division on every device (model/gad.py:_div)."""
    return a / a.new_tensor(c)


def _rdiv(c: float, a: torch.Tensor) -> torch.Tensor:
    """c / a as one IEEE division on every device (PyTorch computes a
    Python number over a tensor as a.reciprocal() * c)."""
    return a.new_tensor(c) / a


def _tanh_taper(gm: GMParams, smod):
    """0.5 (1 + tanh(clip((Scrit - smod) / Sd, -30, 30))): dm95's taper,
    with the clamp of the JAX code (known fault 4 of the reference)."""
    arg = torch.clamp(_div(gm.Scrit - smod, gm.Sd), -30.0, 30.0)
    return 0.5 * (1.0 + torch.tanh(arg))


def _slope_limit(gm: GMParams, dSigmaDx, dSigmaDy, dSigmaDr, Lrho=None,
                 rDepth=None):
    """gmredi.py:_slope_limit (:90-189) in z-coordinates, where its unit
    conversions are 1 and left out: returns (SlopeX, SlopeY, SlopeSqr,
    taperFct). slopeSqCutoff is clamped to the field dtype's largest value,
    as the JAX code does (3.4e38 in float32)."""
    small = gm.small_number
    sqCut = min(gm.slopeSqCutoff, float(torch.finfo(dSigmaDx.dtype).max))
    mss = gm.maxSlope * gm.maxSlope
    if gm.taper_scheme == "ac02":
        d2 = ((dSigmaDx * dSigmaDx + dSigmaDy * dSigmaDy)
              + dSigmaDr * dSigmaDr)
        rD = torch.where(d2 != 0.0,
                         _rdiv(1.0, torch.where(d2 == 0.0, 1.0, d2)), 0.0)
        ssq = (dSigmaDx * dSigmaDx + dSigmaDy * dSigmaDy) * rD
        sx = dSigmaDx * rD * dSigmaDr
        sy = dSigmaDy * rD * dSigmaDr
        flat = torch.where(ssq >= sqCut, ssq.new_tensor(0.0),
                           ssq.new_tensor(1.0))
        taper = torch.where((ssq > mss) & (ssq < sqCut),
                            _rdiv(mss, torch.where(ssq == 0.0, 1.0, ssq)),
                            flat)
        return sx, sy, ssq, taper
    dsr = torch.where((dSigmaDr != 0.0) & (dSigmaDr <= small), small,
                      dSigmaDr)
    big = gm.bigSlope
    safe = torch.where(dsr == 0.0, 1.0, dsr)

    def slope(d):
        sgn = torch.where(d >= 0.0, d.new_tensor(big), d.new_tensor(-big))
        sgn = torch.where(d != 0.0, sgn, d.new_tensor(0.0))
        return torch.where(dsr == 0.0, sgn, d / safe)

    sx, sy = slope(dSigmaDx), slope(dSigmaDy)
    ssq = sx * sx + sy * sy
    taper = torch.ones_like(ssq)
    cutoff = ssq >= sqCut
    ssq = torch.where(cutoff, sqCut, ssq)
    taper = torch.where(cutoff, 0.0, taper)
    live = (ssq != 0.0) & (ssq < sqCut)
    scheme = gm.taper_scheme
    if scheme == "gkw91":
        taper = torch.where(live & (ssq > mss), _rdiv(mss, ssq), taper)
    elif scheme == "linear":
        ratio = _rdiv(mss, torch.where(ssq == 0.0, 1.0, ssq))
        taper = torch.where(live & (ssq > mss), torch.sqrt(ratio), taper)
    elif scheme == "dm95":
        taper = torch.where(live, _tanh_taper(gm, torch.sqrt(ssq)), taper)
    elif scheme == "ldd97":
        smod_r = torch.sqrt(ssq)
        f1 = _tanh_taper(gm, smod_r)
        rnon = rDepth / (Lrho * torch.where(smod_r == 0.0, 1.0, smod_r))
        f2 = torch.where(rnon >= 1.0, 1.0,
                         0.5 * (1.0 + torch.sin(math.pi * (rnon - 0.5))))
        taper = torch.where(live, f1 * f2, taper)
    elif scheme in ("", "clipping", "orig"):
        mod = torch.sqrt(dSigmaDx * dSigmaDx + dSigmaDy * dSigmaDy)
        rmax = 1.0 / gm.maxSlope if gm.maxSlope != 0.0 else 0.0
        dsr_c = torch.where((mod != 0.0) & (dSigmaDr <= mod * rmax),
                            mod * rmax, dSigmaDr)
        safe_c = torch.where(dsr_c == 0.0, 1.0, dsr_c)
        sx = torch.where(mod == 0.0, 0.0, dSigmaDx / safe_c)
        sy = torch.where(mod == 0.0, 0.0, dSigmaDy / safe_c)
        ssq = sx * sx + sy * sy
        taper = torch.ones_like(ssq)
    else:
        raise NotImplementedError(f"GM_taper_scheme={scheme}")
    return sx, sy, ssq, taper


def _lrho(f):
    """ldd97's Rossby radius Cspd / |f|, clipped to [15, 100] km."""
    L = torch.where(f != 0.0,
                    _rdiv(_CSPD, torch.where(f != 0.0, f.abs(), 1.0)),
                    _LRHO_SUP)
    return torch.clamp(L, _LRHO_INF, _LRHO_SUP)


def sigma_xy(grid: Grid, rhoInSitu):
    """(sigmaX, sigmaY): the horizontal density gradients at U and V points
    (step.py:927-930 of the JAX package)."""
    sigmaX = grid.maskW * grid.recip_dxC * (rhoInSitu - sh(rhoInSitu, di=-1))
    sigmaY = grid.maskS * grid.recip_dyC * (rhoInSitu - sh(rhoInSitu, dj=-1))
    return sigmaX, sigmaY


def w_slopes(cfg: Config, grid: Grid, gm: GMParams, sigmaX, sigmaY, sigmaR):
    """The slopes at the W interfaces (gmredi.py:200-238): (sx, sy, ssq,
    taper, maskFk), sx, sy and ssq masked by maskFk = maskC(k) maskC(k-1),
    the taper not."""
    sigX_km1 = shift_k(sigmaX, -1)
    sigY_km1 = shift_k(sigmaY, -1)
    mC = grid.maskC
    maskFk = mC * shift_k(mC, -1)
    dSxW = 0.25 * (sh(sigmaX, di=1) + sigmaX
                   + sh(sigX_km1, di=1) + sigX_km1) * maskFk
    dSyW = 0.25 * (sh(sigmaY, dj=1) + sigmaY
                   + sh(sigY_km1, dj=1) + sigY_km1) * maskFk
    dSrW = cfg.gravitySign * sigmaR
    Lrho = rDepF = None
    if gm.taper_scheme == "ldd97":
        Lrho = _lrho(grid.fCori)
        rDepF = (grid.rF[0] - grid.rF[:cfg.nr])[:, None, None]
    sx, sy, ssq, taper = _slope_limit(gm, dSxW, dSyW, dSrW, Lrho, rDepF)
    return sx * maskFk, sy * maskFk, ssq * maskFk, taper, maskFk


def calc_tensor(cfg: Config, grid: Grid, gm: GMParams, sigmaX, sigmaY,
                sigmaR) -> GMTensor:
    """gmredi.py:calc_tensor (:192-285): the tensor's W-interface
    components and, with nonUnityDiagonal, Kux and Kvy from slopes
    recomputed at U and V points (else the constant isopycK as 0-d
    tensors), with Kuz and Kvz under GM_ExtraDiag."""
    gsign = cfg.gravitySign
    isoK = gm.resolved_isopycK()
    skew = 0.0 if gm.advForm else 1.0
    sx, sy, ssq, taper, _ = w_slopes(cfg, grid, gm, sigmaX, sigmaY, sigmaR)
    Kgm = isoK + skew * gm.background_K
    Kwx = Kgm * (-gsign * sx * taper)
    Kwy = Kgm * (-gsign * sy * taper)
    Kwz = isoK * (ssq * taper)
    for K in (Kwx, Kwy, Kwz):
        K[0] = 0.0
    if not gm.nonUnityDiagonal:
        iso = sigmaX.new_tensor(isoK)
        return GMTensor(Kux=iso, Kvy=iso.clone(), Kwx=Kwx, Kwy=Kwy, Kwz=Kwz)

    nr = cfg.nr
    LrhoW = LrhoS = rDepC = None
    if gm.taper_scheme == "ldd97":
        LrhoW = _lrho(0.5 * (grid.fCori + sh(grid.fCori, di=-1)))
        LrhoS = _lrho(0.5 * (grid.fCori + sh(grid.fCori, dj=-1)))
        rDepC = (grid.rF[0] - grid.rC)[:, None, None]
    maskp1 = torch.ones((nr, 1, 1), dtype=sigmaR.dtype, device=sigmaR.device)
    maskp1[-1] = 0.0
    sigR_kp1 = torch.cat([sigmaR[1:], sigmaR[-1:]])
    dSxU = sigmaX * grid.maskW
    dSyU = 0.25 * (sh(sigmaY, dj=1, di=-1) + sh(sigmaY, dj=1)
                   + sh(sigmaY, di=-1) + sigmaY) * grid.maskW
    dSrU = 0.25 * (sh(sigmaR, di=-1) + sigmaR
                   + (sh(sigR_kp1, di=-1) + sigR_kp1) * maskp1
                   ) * grid.maskW * gsign
    sxU, _, _, taperU = _slope_limit(gm, dSxU, dSyU, dSrU, LrhoW, rDepC)
    Kux = torch.clamp(isoK * taperU, min=gm.Kmin_horiz)

    dSxV = 0.25 * (sh(sigmaX, dj=-1, di=1) + sh(sigmaX, di=1)
                   + sh(sigmaX, dj=-1) + sigmaX) * grid.maskS
    dSyV = sigmaY * grid.maskS
    dSrV = 0.25 * (sh(sigmaR, dj=-1) + sigmaR
                   + (sh(sigR_kp1, dj=-1) + sigR_kp1) * maskp1
                   ) * grid.maskS * gsign
    _, syV, _, taperV = _slope_limit(gm, dSxV, dSyV, dSrV, LrhoS, rDepC)
    Kvy = torch.clamp(isoK * taperV, min=gm.Kmin_horiz)

    Kuz = Kvz = None
    if gm.extra_diag():
        Kuz = -gsign * isoK * sxU * taperU
        Kvz = -gsign * isoK * syV * taperV
    return GMTensor(Kux=Kux, Kvy=Kvy, Kwx=Kwx, Kwy=Kwy, Kwz=Kwz, Kuz=Kuz,
                    Kvz=Kvz)


def xy_flux(cfg: Config, grid: Grid, tensor: GMTensor, xA, yA, tracer):
    """gmredi.py:xy_flux (:288-316): the diagonal Kux/Kvy fluxes plus, under
    GM_ExtraDiag, the Kuz/Kvz d(tr)/dz terms."""
    dfx = -(xA * tensor.Kux * grid.recip_dxC * (tracer - sh(tracer, di=-1)))
    dfy = -(yA * tensor.Kvy * grid.recip_dyC * (tracer - sh(tracer, dj=-1)))
    if tensor.Kuz is not None:
        nr = cfg.nr
        mC = grid.maskC
        t_km1 = torch.cat([tracer[:1], tracer[:-1]])
        t_kp1 = torch.cat([tracer[1:], tracer[-1:]])
        m_km1 = torch.cat([mC[:1], mC[:-1]])
        m_kp1 = torch.cat([mC[1:], mC[-1:]])
        maskFk = mC * m_km1
        maskp1 = torch.ones((nr, 1, 1), dtype=tracer.dtype,
                            device=tracer.device)
        maskp1[-1] = 0.0
        rdrC_k = grid.recip_drC[:nr, None, None]
        rdrC_kp1 = grid.recip_drC[1:nr + 1, None, None]
        up = maskFk * (t_km1 - tracer)
        dn = mC * m_kp1 * maskp1 * (tracer - t_kp1)
        dTdzU = 0.5 * (0.5 * rdrC_k * (sh(up, di=-1) + up)
                       + 0.5 * rdrC_kp1 * (sh(dn, di=-1) + dn))
        dTdzV = 0.5 * (0.5 * rdrC_k * (sh(up, dj=-1) + up)
                       + 0.5 * rdrC_kp1 * (sh(dn, dj=-1) + dn))
        dfx = dfx - xA * tensor.Kuz * dTdzU
        dfy = dfy - yA * tensor.Kvz * dTdzV
    return dfx, dfy


def r_flux(cfg: Config, grid: Grid, tensor: GMTensor, maskUp, tracer):
    """gmredi.py:r_flux (:319-344): the off-diagonal vertical flux at
    interface k, zero at the surface."""
    t_km1 = shift_k(tracer, -1)
    mW, mS = grid.maskW, grid.maskS
    dTdx_k = 0.5 * (
        sh(mW, di=1) * sh(grid.recip_dxC, di=1) * (sh(tracer, di=1) - tracer)
        + mW * grid.recip_dxC * (tracer - sh(tracer, di=-1)))
    mW_km1 = shift_k(mW, -1)
    dTdx_km1 = 0.5 * (
        sh(mW_km1, di=1) * sh(grid.recip_dxC, di=1)
        * (sh(t_km1, di=1) - t_km1)
        + mW_km1 * grid.recip_dxC * (t_km1 - sh(t_km1, di=-1)))
    dTdx = 0.5 * (dTdx_k + dTdx_km1)
    dTdy_k = 0.5 * (
        sh(mS, dj=1) * sh(grid.recip_dyC, dj=1) * (sh(tracer, dj=1) - tracer)
        + mS * grid.recip_dyC * (tracer - sh(tracer, dj=-1)))
    mS_km1 = shift_k(mS, -1)
    dTdy_km1 = 0.5 * (
        sh(mS_km1, dj=1) * sh(grid.recip_dyC, dj=1)
        * (sh(t_km1, dj=1) - t_km1)
        + mS_km1 * grid.recip_dyC * (t_km1 - sh(t_km1, dj=-1)))
    dTdy = 0.5 * (dTdy_k + dTdy_km1)
    df = -(grid.rA * grid.maskInC
           * (tensor.Kwx * dTdx + tensor.Kwy * dTdy) * maskUp)
    df[0] = 0.0
    return df


def psi_cutoff(gm: GMParams) -> float:
    """_slope_psi's slope cutoff: sqrt of slopeSqCutoff clamped to the
    largest float64 (gmredi.py:368-369 takes the dtype of jnp.zeros(()),
    float64 under the tests' jax_enable_x64 whatever the field's dtype), so
    1e24 in float32 too; a quirk of the reference that the port copies."""
    return math.sqrt(min(gm.slopeSqCutoff, float(torch.finfo(
        torch.float64).max)))


def _slope_psi(gm: GMParams, slope, dSigmaDr):
    """gmredi.py:_slope_psi (:347-393) for one component in z-coordinates
    (unit 1, left out): (Slope, taper). dm95's taper has no cutoff guard
    (the reference's)."""
    small = gm.small_number
    scheme = gm.taper_scheme
    maxS = gm.maxSlope
    if scheme in ("", "clipping", "orig"):
        rMaxSlope = 1.0 / gm.maxSlope if gm.maxSlope != 0.0 else 0.0
        ltd = small + slope.abs() * rMaxSlope
        dsr = torch.maximum(dSigmaDr, ltd)
        return slope / dsr, torch.ones_like(slope)
    dsr = torch.clamp(dSigmaDr, min=small)
    s = slope / dsr
    taper = torch.ones_like(s)
    cutoff = psi_cutoff(gm)
    hit = s.abs() >= cutoff
    s = torch.where(hit, torch.sign(s) * cutoff, s)
    taper = torch.where(hit, 0.0, taper)
    smod = s.abs()
    live = (smod > maxS) & (smod < cutoff)
    if scheme in ("gkw91", "ac02"):
        taper = torch.where(live, _rdiv(maxS * maxS, s * s + small), taper)
    elif scheme == "linear":
        taper = torch.where(live, _rdiv(maxS, smod + small), taper)
    elif scheme == "dm95":
        taper = _tanh_taper(gm, smod)
    else:
        raise NotImplementedError(
            f"GM_taper_scheme={scheme} for GM_AdvForm (slope_psi)")
    return s, taper


def calc_psi_b(cfg: Config, grid: Grid, gm: GMParams, sigmaX, sigmaY,
               sigmaR):
    """gmredi.py:calc_psi_b (:396-421): the bolus streamfunction (PsiX at U
    points, PsiY at V points, at the interfaces; row 0 zero), K =
    GM_background_K."""
    halfSign = 0.5 * cfg.gravitySign
    mW, mS = grid.maskW, grid.maskS
    mWf = mW * shift_k(mW, -1)
    mSf = mS * shift_k(mS, -1)
    slopeX = 0.5 * (shift_k(sigmaX, -1) + sigmaX) * mWf
    dSrW = (sh(sigmaR, di=-1) + sigmaR) * halfSign * mWf
    slopeY = 0.5 * (shift_k(sigmaY, -1) + sigmaY) * mSf
    dSrS = (sh(sigmaR, dj=-1) + sigmaR) * halfSign * mSf
    sX, tX = _slope_psi(gm, slopeX, dSrW)
    sY, tY = _slope_psi(gm, slopeY, dSrS)
    K = gm.background_K
    psiX = sX * tX * K
    psiY = sY * tY * K
    psiX[0] = 0.0
    psiY[0] = 0.0
    return psiX, psiY


def residual_flow(cfg: Config, grid: Grid, psiX, psiY, u, v, w):
    """gmredi.py:residual_flow (:424-438): u, v and w plus the bolus
    velocity, the curl of Psi (deepFac 1)."""
    flip = -cfg.gravitySign
    rdrF = grid.recip_drF[:, None, None]
    dPsiX = torch.cat([psiX[1:], torch.zeros_like(psiX[:1])]) - psiX
    uF = u + dPsiX * rdrF * grid.recip_hFacW * flip
    dPsiY = torch.cat([psiY[1:], torch.zeros_like(psiY[:1])]) - psiY
    vF = v + dPsiY * rdrF * grid.recip_hFacS * flip
    dyPsiX = grid.dyG * psiX
    dxPsiY = grid.dxG * psiY
    curl = (sh(dyPsiX, di=1) - dyPsiX + sh(dxPsiY, dj=1) - dxPsiY)
    wF = w + curl * grid.recip_rA * flip
    return uF, vF, wF


# ----------------------------------------------------------------------
# the wrappers: the kernels of kernels/csrc/gmredi.cu, or the twins
# ----------------------------------------------------------------------

def _refuse_grad(kernel: str, **tensors) -> None:
    grads = [n for n, t in tensors.items() if t.requires_grad]
    if grads:
        raise ValueError(f"{kernel}: {grads} require grad; it has no "
                         "backward kernel")


def tensor_params(cfg: Config, gm: GMParams, dtype: torch.dtype) -> list:
    """gm_tensor's host numbers, in the order of gmredi.cuh:TensorParams
    (slopeSqCutoff clamped to the largest value of the field dtype)."""
    isoK = gm.resolved_isopycK()
    skew = 0.0 if gm.advForm else 1.0
    return [gm.small_number, gm.bigSlope,
            min(gm.slopeSqCutoff, float(torch.finfo(dtype).max)),
            gm.maxSlope * gm.maxSlope,
            1.0 / gm.maxSlope if gm.maxSlope != 0.0 else 0.0,
            gm.Scrit, gm.Sd, isoK, isoK + skew * gm.background_K,
            gm.Kmin_horiz, cfg.gravitySign, -cfg.gravitySign * isoK,
            _CSPD, _LRHO_INF, _LRHO_SUP]


def _gm_tensor_kernel(cfg: Config, grid: Grid, gm: GMParams, rhoInSitu,
                      sigmaR) -> GMTensor:
    """Kernel gm_tensor (kernels/csrc/gmredi.cu) on the card."""
    dtype, shape = rhoInSitu.dtype, tuple(rhoInSitu.shape)
    nr, nyp, nxp = shape
    outs = {n: torch.empty_like(rhoInSitu) for n in ("Kwx", "Kwy", "Kwz")}
    if gm.nonUnityDiagonal:
        outs.update(Kux=torch.empty_like(rhoInSitu),
                    Kvy=torch.empty_like(rhoInSitu))
        if gm.extra_diag():
            outs.update(Kuz=torch.empty_like(rhoInSitu),
                        Kvz=torch.empty_like(rhoInSitu))
    ins3 = dict(rhoInSitu=rhoInSitu, sigmaR=sigmaR, maskC=grid.maskC,
                maskW=grid.maskW, maskS=grid.maskS)
    ins2 = dict(recip_dxC=grid.recip_dxC, recip_dyC=grid.recip_dyC)
    ldd97 = gm.taper_scheme == "ldd97"
    if ldd97:
        ins2["fCori"] = grid.fCori
        kernels.check_fields(dtype, (nr + 1,), rF=grid.rF)
        kernels.check_fields(dtype, (nr,), rC=grid.rC)
    kernels.check_fields(dtype, shape, **ins3, **outs)
    kernels.check_fields(dtype, (nyp, nxp), **ins2)
    # the table of gmredi.cu:TensorArgs; the slots of absent outputs are
    # null (fCori, rF and rC are read by ldd97 only)
    table = kernels.pointer_table(
        [*ins3.values(), grid.recip_dxC, grid.recip_dyC, grid.fCori, grid.rF,
         grid.rC] + [outs.get(n) for n in ("Kwx", "Kwy", "Kwz", "Kux",
                                            "Kvy", "Kuz", "Kvz")])
    params = kernels.doubles(tensor_params(cfg, gm, dtype))
    kernels.launch("gm_tensor", dtype, table, len(table), params,
                   len(params), nr, nyp, nxp, TAPERS[gm.taper_scheme],
                   int(gm.nonUnityDiagonal))
    if not gm.nonUnityDiagonal:
        iso = rhoInSitu.new_tensor(gm.resolved_isopycK())
        outs.update(Kux=iso, Kvy=iso.clone())
    return GMTensor(**outs)


def gm_tensor(cfg: Config, grid: Grid, gm: GMParams, rhoInSitu, sigmaR,
              impl: str = None) -> GMTensor:
    """The GM-Redi tensor from the in-situ density (masked) and sigmaR
    (step.py:926-932 of the JAX package): kernel gm_tensor on CUDA tensors,
    sigma_xy and calc_tensor on CPU tensors or with impl="plain"."""
    _refuse_grad("gm_tensor", rhoInSitu=rhoInSitu, sigmaR=sigmaR)
    if kernels.use_kernel(rhoInSitu, impl):
        return _gm_tensor_kernel(cfg, grid, gm, rhoInSitu, sigmaR)
    global plain_calls
    plain_calls += 1
    return calc_tensor(cfg, grid, gm, *sigma_xy(grid, rhoInSitu), sigmaR)


def psi_params(cfg: Config, gm: GMParams) -> list:
    """gm_psi_b's host numbers, in the order of gmredi.cuh:PsiParams."""
    maxS = gm.maxSlope
    return [gm.small_number, psi_cutoff(gm), maxS, maxS * maxS,
            1.0 / gm.maxSlope if gm.maxSlope != 0.0 else 0.0,
            gm.Scrit, gm.Sd, 0.5 * cfg.gravitySign, gm.background_K]


def gm_psi_b(cfg: Config, grid: Grid, gm: GMParams, rhoInSitu, sigmaR,
             impl: str = None):
    """(psiX, psiY), the bolus streamfunction from the in-situ density and
    sigmaR: kernel gm_psi_b on CUDA tensors, sigma_xy and calc_psi_b on CPU
    tensors or with impl="plain". The caller fills their halos."""
    _refuse_grad("gm_psi_b", rhoInSitu=rhoInSitu, sigmaR=sigmaR)
    if not kernels.use_kernel(rhoInSitu, impl):
        global plain_calls
        plain_calls += 1
        return calc_psi_b(cfg, grid, gm, *sigma_xy(grid, rhoInSitu), sigmaR)
    dtype, shape = rhoInSitu.dtype, tuple(rhoInSitu.shape)
    psiX, psiY = torch.empty_like(rhoInSitu), torch.empty_like(rhoInSitu)
    ins3 = dict(rhoInSitu=rhoInSitu, sigmaR=sigmaR, maskW=grid.maskW,
                maskS=grid.maskS)
    ins2 = dict(recip_dxC=grid.recip_dxC, recip_dyC=grid.recip_dyC)
    kernels.check_fields(dtype, shape, **ins3, psiX=psiX, psiY=psiY)
    kernels.check_fields(dtype, shape[1:], **ins2)
    table = kernels.pointer_table([*ins3.values(), *ins2.values(), psiX,
                                   psiY])
    params = kernels.doubles(psi_params(cfg, gm))
    kernels.launch("gm_psi_b", dtype, table, len(table), params, len(params),
                   *shape, PSI_TAPERS[gm.taper_scheme])
    return psiX, psiY


def gm_residual_flow(cfg: Config, grid: Grid, psiX, psiY, u, v, w,
                     impl: str = None):
    """(uF, vF, wF), the residual flow that advects the tracers in the
    bolus form (thermodynamics.F GMREDI_RESIDUAL_FLOW), from the filled
    psi: kernel gm_residual_flow on CUDA tensors, residual_flow on CPU
    tensors or with impl="plain"."""
    _refuse_grad("gm_residual_flow", psiX=psiX, psiY=psiY, u=u, v=v, w=w)
    if not kernels.use_kernel(u, impl):
        global plain_calls
        plain_calls += 1
        return residual_flow(cfg, grid, psiX, psiY, u, v, w)
    dtype, shape = u.dtype, tuple(u.shape)
    outs = [torch.empty_like(u) for _ in range(3)]
    ins3 = dict(psiX=psiX, psiY=psiY, u=u, v=v, w=w,
                recip_hFacW=grid.recip_hFacW, recip_hFacS=grid.recip_hFacS)
    ins2 = dict(dyG=grid.dyG, dxG=grid.dxG, recip_rA=grid.recip_rA)
    kernels.check_fields(dtype, shape, **ins3, uF=outs[0], vF=outs[1],
                         wF=outs[2])
    kernels.check_fields(dtype, shape[1:], **ins2)
    kernels.check_fields(dtype, shape[:1], recip_drF=grid.recip_drF)
    table = kernels.pointer_table([*ins3.values(), *ins2.values(),
                                   grid.recip_drF, *outs])
    kernels.launch("gm_residual_flow", dtype, table, len(table), *shape,
                   -cfg.gravitySign)
    return tuple(outs)
