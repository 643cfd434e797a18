"""The high-order advection schemes of the multi-dimensional advection
(mitgcm_tpu/model/gad.py:97-780): OS7MP (scheme 7) and the PPM/PQM
reconstructions with their null, monotone and WENO limiters (schemes 40-42
and 50-52), as plain PyTorch on whole [nr, nyp, nxp] arrays.

Each function replays the JAX function of the same name in its operation
order, with the zero-filled shifts of ops/stencil.py, so that kernels O
(kernels/csrc/gad_os7mp.cu) and P (gad_ppm.cu) can be held to it bit for
bit on the card. PyTorch's CUDA kernels divide by a Python number by
multiplying with its reciprocal and compute `c / t` as `t.reciprocal() *
c`, so every division here is tensor by tensor (`_div`, `_rdiv`), and the
integer powers are the products of JAX's integer_pow (`_ipow`).
"""

from __future__ import annotations

import torch

from mitgcm_tpu_torch.ops.stencil import shift as sh

ENUM_OS7MP = 7
ENUM_PPM_NULL, ENUM_PPM_MONO, ENUM_PPM_WENO = 40, 41, 42
ENUM_PQM_NULL, ENUM_PQM_MONO, ENUM_PQM_WENO = 50, 51, 52
PPM_SCHEMES = (ENUM_PPM_NULL, ENUM_PPM_MONO, ENUM_PPM_WENO)
PQM_SCHEMES = (ENUM_PQM_NULL, ENUM_PQM_MONO, ENUM_PQM_WENO)


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c as one IEEE division on every device."""
    return a / a.new_tensor(c)


def _rdiv(c: float, a: torch.Tensor) -> torch.Tensor:
    """c / a as one IEEE division on every device."""
    return a.new_tensor(c) / a


def _ipow(x, n: int):
    """x ** n as JAX's integer_pow multiplies it out (binary powers)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _band(shape, axis: str, lo: int, hi_margin: int, dtype, device):
    """1 on x columns (axis "x") or y rows [lo, n - hi_margin), else 0:
    the write band of a flux kernel (a single face, nFaces == 1)."""
    nyp, nxp = shape[-2:]
    band = torch.zeros((nyp, nxp), dtype=dtype, device=device)
    if axis == "x":
        band[:, lo:nxp - hi_margin] = 1.0
    else:
        band[lo:nyp - hi_margin, :] = 1.0
    return band


# ----------------------------------------------------------------------
# OS7MP (gad_os7mp_adv_x/y/r.F)
# ----------------------------------------------------------------------

def os7mp_psi(trans, cfl, q_stack, m_stack, flags=None):
    """gad.py:os7mp_psi (:103-178): the one-directional OS7MP flux of
    upwind-ordered stencils q (Qippp .. Qimmm) and m (MskIpp .. MskImmm).
    flags, a dict, receives the branches taken (for the tests)."""
    Eps = 1.0e-20
    Qippp, Qipp, Qip, Qi, Qim, Qimm, Qimmm = q_stack
    MskIpp, MskIp, MskI, MskIm, MskImm, MskImmm = m_stack
    DelP = (Qip - Qi) * MskI
    Phi = DelP
    Fac = _div(cfl + 1.0, 3.0)
    DelM = (Qi - Qim) * MskIm
    Del2 = DelP - DelM
    Phi = Phi - Fac * Del2
    Fac = _div(Fac * (cfl - 2.0), 4.0)
    DelPP = (Qipp - Qip) * MskIp * MskI
    Del2P = DelPP - DelP
    Del3P = Del2P - Del2
    Phi = Phi + Fac * Del3P
    Fac = _div(Fac * (cfl - 3.0), 5.0)
    DelMM = (Qim - Qimm) * MskImm * MskIm
    Del2M = DelM - DelMM
    Del3M = Del2 - Del2M
    Del4 = Del3P - Del3M
    Phi = Phi + Fac * Del4
    Fac = _div(Fac * (cfl + 2.0), 6.0)
    DelPPP = (Qippp - Qipp) * MskIpp * MskIp * MskI
    Del2PP = DelPP - DelP
    Del3PP = Del2PP - Del2P
    Del4P = Del3PP - Del3P
    Del5P = Del4P - Del4
    Phi = Phi + Fac * Del5P
    Fac = _div(Fac * (cfl + 2.0), 7.0)
    DelMMM = (Qimm - Qimmm) * MskImmm * MskImm * MskIm
    Del2MM = DelMM - DelMMM
    Del3MM = Del2M - Del2MM
    Del4M = Del3M - Del3MM
    Del5M = Del4 - Del4M
    Del6 = Del5P - Del5M
    Phi = Phi - Fac * Del6

    def recip(d):
        # sign(d) / max(|d|, Eps), and 1 / Eps where d == 0
        r = torch.sign(d) / torch.clamp(d.abs(), min=Eps)
        return torch.where(d == 0.0, 1.0 / Eps, r)

    DelIp = (Qip - Qi) * MskI
    recip_DelIp = recip(DelIp)
    Phi = Phi * recip_DelIp
    DelI = (Qi - Qim) * MskIm
    recip_DelI = recip(DelI)
    rp1h = DelI * recip_DelIp
    rp1h_cfl = rp1h / (cfl + Eps)

    def curv(d2m, d2p):
        # the median-curvature bound of gad.py:154-167
        A = 4.0 * d2m - d2p
        B = 4.0 * d2p - d2m
        return (torch.clamp(torch.minimum(torch.minimum(A, B),
                                          torch.minimum(d2m, d2p)), min=0.0)
                + torch.clamp(torch.maximum(torch.maximum(A, B),
                                            torch.maximum(d2m, d2p)),
                              max=0.0))

    dp1h = curv(Del2, Del2P)
    dm1h = curv(Del2M, Del2)
    PhiMD = _rdiv(1.0, 1.0 - cfl) * (DelIp - dp1h) * recip_DelIp
    PhiLC = rp1h_cfl * (1.0 + dm1h * recip_DelI)
    PhiMin = torch.maximum(torch.clamp(PhiMD, max=0.0),
                           torch.minimum(torch.clamp(2.0 * rp1h_cfl, max=0.0),
                                         PhiLC))
    PhiMax = torch.minimum(torch.maximum(_rdiv(2.0, 1.0 - cfl), PhiMD),
                           torch.maximum(torch.clamp(2.0 * rp1h_cfl, min=0.0),
                                         PhiLC))
    if flags is not None:
        flags.update(PhiMin=Phi < PhiMin, PhiMax=Phi > PhiMax,
                     DelIp0=DelIp == 0.0)
    Phi = torch.maximum(PhiMin, torch.minimum(Phi, PhiMax))
    Psi = Phi * 0.5 * (1.0 - cfl)
    return trans * (Qi + Psi * DelIp)


def os7mp_band(shape, axis: str, dtype, device):
    """gad.py:os7mp_band (:207-218): x columns / y rows [4, n - 3)."""
    return _band(shape, axis, 4, 3, dtype, device)


def _os7mp_flux_h(trans, vel, mask, Q, dt, recip_dC, s, band, flags=None):
    """gad.py:os7mp_flux_x/y (:181-204) with the shift `s` of the axis;
    flags, a dict, receives the branches of the upwind side taken."""
    cfl = (vel * dt * recip_dC).abs()
    up = [s(Q, d) for d in (2, 1, 0, -1, -2, -3, -4)]
    um = [s(mask, d) for d in (2, 1, 0, -1, -2, -3)]
    dn = [s(Q, d) for d in (-3, -2, -1, 0, 1, 2, 3)]
    dm = [s(mask, d) for d in (-2, -1, 0, 1, 2, 3)]
    fp_flags, fn_flags = ({}, {}) if flags is not None else (None, None)
    fp = os7mp_psi(trans, cfl, up, um, fp_flags)
    fn = os7mp_psi(trans, cfl, dn, dm, fn_flags)
    if flags is not None:
        flags.update({k: torch.where(trans > 0.0, fp_flags[k],
                                     (trans < 0.0) & fn_flags[k])
                      for k in fp_flags})
    f = torch.where(trans > 0.0, fp,
                    torch.where(trans < 0.0, fn, torch.zeros_like(fn)))
    return f * band


def os7mp_flux_x(uTrans, uFld, maskW, Q, dt, recip_dxC):
    """gad_os7mp_adv_x.F: the zonal flux, zero off the write band."""
    band = os7mp_band(Q.shape, "x", Q.dtype, Q.device)
    return _os7mp_flux_h(uTrans, uFld, maskW, Q, dt, recip_dxC,
                         lambda a, d: sh(a, di=d), band)


def os7mp_flux_y(vTrans, vFld, maskS, Q, dt, recip_dyC):
    """gad_os7mp_adv_y.F: the meridional flux, zero off the write band."""
    band = os7mp_band(Q.shape, "y", Q.dtype, Q.device)
    return _os7mp_flux_h(vTrans, vFld, maskS, Q, dt, recip_dyC,
                         lambda a, d: sh(a, dj=d), band)


def _os7mp_flux_r(maskC, recip_drC, rTrans, wFld, Q, deltaT):
    """gad.py:_os7mp_flux_r (:221-266): the vertical OS7MP flux at
    interface k (array index k-1); the levels clamp at the column ends and
    the stencil masks carry the float(k_hi - k_lo) clamp indicators. The
    caller zeroes the surface flux."""
    nr = Q.shape[0]
    cflK = (wFld * deltaT * recip_drC[:nr, None, None]).abs()
    k = torch.arange(nr, device=Q.device)
    iK = {off: torch.clamp(k + off, 0, nr - 1)
          for off in (-4, -3, -2, -1, 0, 1, 2, 3)}

    def mfac(hi, lo):
        return (iK[hi] - iK[lo]).to(Q.dtype)[:, None, None]

    QL = {off: Q[iK[off]] for off in iK}
    ML = {off: maskC[iK[off]] for off in iK}
    # rTrans < 0: upwind from above, Qi = Q(k-1)
    q_dn = (QL[2], QL[1], QL[0], QL[-1], QL[-2], QL[-3], QL[-4])
    m_dn = (ML[2] * mfac(2, 1), ML[1] * mfac(1, 0), ML[0] * mfac(0, -1),
            ML[-1] * mfac(-1, -2), ML[-2] * mfac(-2, -3),
            ML[-3] * mfac(-3, -4))
    # rTrans > 0: upwind from below, Qi = Q(k)
    q_up = (QL[-3], QL[-2], QL[-1], QL[0], QL[1], QL[2], QL[3])
    m_up = (ML[-2] * mfac(-2, -3), ML[-1] * mfac(-1, -2),
            ML[0] * mfac(0, -1), ML[1] * mfac(1, 0),
            ML[2] * mfac(2, 1), ML[3] * mfac(3, 2))
    fn = os7mp_psi(rTrans, cflK, q_dn, m_dn)
    fp = os7mp_psi(rTrans, cflK, q_up, m_up)
    return torch.where(rTrans > 0.0, fp,
                       torch.where(rTrans < 0.0, fn, torch.zeros_like(fn)))


# ----------------------------------------------------------------------
# PPM / PQM (gad_ppm_*.F, gad_pqm_*.F, gad_plm_fun.F, gad_osc_*.F)
# ----------------------------------------------------------------------

def _plm_slope(ffll, ff00, ffrr):
    """gad.py:_plm_slope (:275): the monotone centred half-slope d0 and
    the one-sided halves."""
    eps = 1.0e-16
    dm = ff00 - ffll
    dp = ffrr - ff00
    d0 = 0.5 * (0.5 * (ff00 + ffrr) - 0.5 * (ffll + ff00))
    scal = torch.clamp(torch.minimum(dm.abs(), dp.abs())
                       / torch.clamp(d0.abs(), min=eps), max=1.0)
    d0 = torch.where(dm * dp > 0.0, scal * d0, torch.zeros_like(d0))
    return 0.5 * dm, d0, 0.5 * dp


def _ppm_coef(ff00, fell, ferr):
    """GAD_PPM_FUN_NULL coefficients on local coords s in [-1, 1]."""
    h1 = 1.5 * ff00 - 0.25 * (ferr + fell)
    h2 = 0.5 * (ferr - fell)
    h3 = -1.5 * ff00 + 0.75 * (ferr + fell)
    return h1, h2, h3


def _ppm_mono(ff00, ffll, ffrr, fell, ferr, d0, flags=None):
    """gad.py:_ppm_mono (:297): (h1, h2, h3, mono flag); flags, a dict,
    receives condA and condB."""
    extrema = (ffrr - ff00) * (ff00 - ffll) <= 0.0
    limL = (ffll - fell) * (fell - ff00) <= 0.0
    limR = (ffrr - ferr) * (ferr - ff00) <= 0.0
    fell = torch.where(limL, ff00 - d0, fell)
    ferr = torch.where(limR, ff00 + d0, ferr)
    h1, h2, h3 = _ppm_coef(ff00, fell, ferr)
    has_turn = h3.abs() > h2.abs() * 0.5
    turn = -0.5 * h2 / torch.where(h3 == 0.0, torch.ones_like(h3), h3)
    condA = has_turn & (turn >= -1.0) & (turn <= 0.0)
    condB = has_turn & (turn > 0.0) & (turn <= 1.0)
    ferr = torch.where(condA, 3.0 * ff00 - 2.0 * fell, ferr)
    fell = torch.where(condB, 3.0 * ff00 - 2.0 * ferr, fell)
    if flags is not None:
        flags.update(condA=condA, condB=condB)
    redo = condA | condB
    n1, n2, n3 = _ppm_coef(ff00, fell, ferr)
    h1 = torch.where(redo, n1, h1)
    h2 = torch.where(redo, n2, h2)
    h3 = torch.where(redo, n3, h3)
    zero = torch.zeros_like(h1)
    h1 = torch.where(extrema, ff00, h1)
    h2 = torch.where(extrema, zero, h2)
    h3 = torch.where(extrema, zero, h3)
    return h1, h2, h3, extrema | limL | limR | redo


def _pqm_coef(ff00, fell, ferr, dell, derr):
    """GAD_PQM_FUN_NULL coefficients (quartic, s in [-1, 1])."""
    h1 = ((30.0 / 16.0) * ff00 - (7.0 / 16.0) * (ferr + fell)
          + (1.0 / 16.0) * (derr - dell))
    h2 = (3.0 / 4.0) * (ferr - fell) - (1.0 / 4.0) * (derr + dell)
    h3 = (-(30.0 / 8.0) * ff00 + (15.0 / 8.0) * (ferr + fell)
          - (3.0 / 8.0) * (derr - dell))
    h4 = -(1.0 / 4.0) * (ferr - fell - derr - dell)
    h5 = ((30.0 / 16.0) * ff00 - (15.0 / 16.0) * (ferr + fell)
          + (5.0 / 16.0) * (derr - dell))
    return h1, h2, h3, h4, h5


def _pqm_mono(ff00, ffll, ffrr, fell, ferr, dell, derr, dfm, d0, dfp,
              flags=None):
    """gad.py:_pqm_mono (:336), with the QUADROOT inflexion test and the
    two edge 'pop' branches: (h1 .. h5, mono flag); flags, a dict,
    receives bindm, bindp and the pops taken, c1 and c2 (where bound)."""
    w = torch.where
    extrema = (ffrr - ff00) * (ff00 - ffll) <= 0.0
    limL = (ffll - fell) * (fell - ff00) <= 0.0
    limR = (ffrr - ferr) * (ferr - ff00) <= 0.0
    fell = w(limL, ff00 - d0, fell)
    ferr = w(limR, ff00 + d0, ferr)
    limDL = dell * dfm < 0.0
    limDR = derr * dfp < 0.0
    dell = w(limDL, dfm, dell)
    derr = w(limDR, dfp, derr)
    h1, h2, h3, h4, h5 = _pqm_coef(ff00, fell, ferr, dell, derr)

    # QUADROOT on 12*h5*x^2 + 6*h4*x + 2*h3 (the second derivative)
    one = torch.ones_like(h1)
    aa, bb, cc = 12.0 * h5, 6.0 * h4, 2.0 * h3
    sq = bb * bb - 4.0 * aa * cc
    hasA = (aa.abs() > 0.0) & (sq >= 0.0)
    hasB = (aa.abs() <= 0.0) & (bb.abs() > 0.0)
    sqr = torch.sqrt(torch.clamp(sq, min=0.0))
    ra = _rdiv(0.5, w(aa == 0.0, one, aa))
    rb = -cc / w(bb == 0.0, one, bb)
    far = 2.0 * one     # outside (-1, 1): no effect
    x1 = w(hasA, (-bb + sqr) * ra, w(hasB, rb, far))
    x2 = w(hasA, (-bb - sqr) * ra, w(hasB, rb, far))

    def dflx(x):
        return (h2 + x * h3 * 2.0 + _ipow(x, 2) * h4 * 3.0
                + _ipow(x, 3) * h5 * 4.0)

    bad1 = (x1 > -1.0) & (x1 < 1.0) & (dflx(x1) * d0 < 0.0)
    bad2 = (x2 > -1.0) & (x2 < 1.0) & (dflx(x2) * d0 < 0.0)
    anybad = bad1 | bad2
    bindm = anybad & (dell.abs() < derr.abs())
    bindp = anybad & ~bindm

    zero = torch.zeros_like(h1)
    # bind == -1: pop the inflexion onto the lower (-1) edge
    eA_l, eA_r = fell, ferr
    dA_r = -5.0 * ff00 + 3.0 * ferr + 2.0 * fell
    dA_l = (5.0 / 3.0) * ff00 - (1.0 / 3.0) * ferr - (4.0 / 3.0) * fell
    dA_l0 = dA_l
    c1 = dA_l * dfm < 0.0
    eA_r = w(c1, 5.0 * ff00 - 4.0 * eA_l, eA_r)
    dA_r = w(c1, 10.0 * ff00 - 10.0 * eA_l, dA_r)
    dA_l = w(c1, zero, dA_l)
    c2 = dA_r * dfp < 0.0
    eA_l = w(c2, (5.0 / 2.0) * ff00 - (3.0 / 2.0) * eA_r, eA_l)
    dA_l = w(c2, -(5.0 / 3.0) * ff00 + (5.0 / 3.0) * eA_r, dA_l)
    dA_r = w(c2, zero, dA_r)
    c2A = c2

    # bind == +1: pop the inflexion onto the upper (+1) edge
    eB_l, eB_r = fell, ferr
    dB_r = -(5.0 / 3.0) * ff00 + (4.0 / 3.0) * ferr + (1.0 / 3.0) * fell
    dB_l = 5.0 * ff00 - 2.0 * ferr - 3.0 * fell
    dB_l0 = dB_l
    c1 = dB_l * dfm < 0.0
    eB_r = w(c1, (5.0 / 2.0) * ff00 - (3.0 / 2.0) * eB_l, eB_r)
    dB_r = w(c1, (5.0 / 3.0) * ff00 - (5.0 / 3.0) * eB_l, dB_r)
    dB_l = w(c1, zero, dB_l)
    c2 = dB_r * dfp < 0.0
    eB_l = w(c2, 5.0 * ff00 - 4.0 * eB_r, eB_l)
    dB_l = w(c2, -10.0 * ff00 + 10.0 * eB_r, dB_l)
    dB_r = w(c2, zero, dB_r)
    if flags is not None:
        flags.update(bindm=bindm, bindp=bindp,
                     c1=(bindm & (dA_l0 * dfm < 0.0))
                     | (bindp & (dB_l0 * dfm < 0.0)),
                     c2=(bindm & c2A) | (bindp & c2))

    fell = w(bindm, eA_l, w(bindp, eB_l, fell))
    ferr = w(bindm, eA_r, w(bindp, eB_r, ferr))
    dell = w(bindm, dA_l, w(bindp, dB_l, dell))
    derr = w(bindm, dA_r, w(bindp, dB_r, derr))
    n = _pqm_coef(ff00, fell, ferr, dell, derr)
    out = [w(anybad, nn, hh) for nn, hh in zip(n, (h1, h2, h3, h4, h5))]
    flat = (ff00, zero, zero, zero, zero)
    out = [w(extrema, ff, hh) for ff, hh in zip(flat, out)]
    mono = extrema | limL | limR | limDL | limDR | anybad
    return out[0], out[1], out[2], out[3], out[4], mono


def _p3e_edge(s, mask, f):
    """GAD_PPM_P3E_*: the 3rd-order value at the left edge of each cell,
    with the outward mask-expansion of the 4-point stencil."""
    mm1 = s(mask, -1)
    fm1v = f + mm1 * (s(f, -1) - f)
    f0v = s(f, -1) + mask * (f - s(f, -1))
    mm2 = s(mask, -2) * mm1
    tmp = 2.0 * fm1v - f0v
    fm2v = tmp + mm2 * (s(f, -2) - tmp)
    mp1 = s(mask, 1) * mask
    tmp = 2.0 * f0v - fm1v
    fp1v = tmp + mp1 * (s(f, 1) - tmp)
    return (-(1.0 / 12.0) * (fm2v + fp1v)
            + (7.0 / 12.0) * (fm1v + f0v))


def _p5e_edge(s, mask, f, recip_dC):
    """GAD_PQM_P5E_*: the 5th-order edge value and the edge slope (scaled
    by the reciprocal spacing at the edge)."""
    mm1 = s(mask, -1)
    fm1v = f + mm1 * (s(f, -1) - f)
    f0v = s(f, -1) + mask * (f - s(f, -1))
    mm2 = s(mask, -2) * mm1
    mm3 = s(mask, -3) * mm2
    tmp = 2.0 * fm1v - f0v
    fm2v = tmp + mm2 * (s(f, -2) - tmp)
    tmp = 2.0 * fm2v - fm1v
    fm3v = tmp + mm3 * (s(f, -3) - tmp)
    mp1 = s(mask, 1) * mask
    mp2 = s(mask, 2) * mp1
    tmp = 2.0 * f0v - fm1v
    fp1v = tmp + mp1 * (s(f, 1) - tmp)
    tmp = 2.0 * fp1v - f0v
    fp2v = tmp + mp2 * (s(f, 2) - tmp)
    e1 = ((1.0 / 60.0) * (fm3v + fp2v) - (8.0 / 60.0) * (fm2v + fp1v)
          + (37.0 / 60.0) * (fm1v + f0v))
    e2 = (-(1.0 / 90.0) * (fm3v - fp2v) + (5.0 / 36.0) * (fm2v - fp1v)
          - (49.0 / 36.0) * (fm1v - f0v)) * recip_dC
    return e1, e2


def _osc_hat(s, mask, f):
    """GAD_OSC_LOC_* interior formula: masked 1st/2nd derivatives in local
    coords."""
    fm1 = f + s(mask, -1) * (s(f, -1) - f)
    fp1 = f + s(mask, 1) * (s(f, 1) - f)
    d1 = 0.25 * (fp1 - fm1)
    d2 = 0.25 * fp1 - 0.5 * f + 0.25 * fm1
    return d1, d2


def _osc_weights(dd, mm):
    """The WENO weights of gad.py:_osc_mul (:461-485) from the window's
    (d1, d2) pairs `dd` and masks `mm`, offsets -2 .. 2: (s1, s2)."""
    zero = 1.0e-20
    omin = omax = mval = None
    for off, (dd1, dd2), m in zip((-2, -1, 0, 1, 2), dd, mm):
        dfs1 = dd1 + dd2 * (2.0 * off)
        oval = _ipow(2.0 * dfs1, 2) + _ipow(4.0 * dd2, 2)
        omin = oval if omin is None else torch.minimum(omin, oval)
        omax = oval if omax is None else torch.maximum(omax, oval)
        mval = m if mval is None else mval * m
    # reference form s1 = 1e5/(omax+z)^3, s2 = 1/(omin+z)^3, normalised,
    # through the ratio q as in the JAX code
    q = _ipow((omax + zero) / (omin + zero), 3)
    ok = mval > 0.0
    s1 = _rdiv(1.0e5, 1.0e5 + q)
    s2 = q / (1.0e5 + q)
    return (torch.where(ok, s1, torch.zeros_like(s1)),
            torch.where(ok, s2, torch.ones_like(s2)))


def _osc_mul(s, mask, d1, d2):
    """GAD_OSC_MUL_* with hh = 2: the WENO oscillation weights."""
    offs = (-2, -1, 0, 1, 2)
    return _osc_weights([(s(d1, o), s(d2, o)) for o in offs],
                        [s(mask, o) for o in offs])


def _osc_ends(axis, mask, f, d1, d2):
    """GAD_OSC_LOC_* one-sided boundary columns (the first and last cell of
    the padded row or column; a single face)."""
    ax = -1 if axis == "x" else -2
    m = mask.movedim(ax, 0)
    g = f.movedim(ax, 0)
    e1 = d1.movedim(ax, 0).clone()
    e2 = d2.movedim(ax, 0).clone()
    f0 = g[0]
    f1 = f0 + m[1] * (g[1] - f0)
    f2 = f1 + m[2] * (g[2] - f1)
    e1[0] = 0.5 * (f1 - f0)
    e2[0] = 0.25 * f2 - 0.5 * f1 + 0.25 * f0
    h0 = g[-1]
    h1 = h0 + m[-2] * (g[-2] - h0)
    h2 = h1 + m[-3] * (g[-3] - h1)
    e1[-1] = 0.5 * (h0 - h1)
    e2[-1] = 0.25 * h0 - 0.5 * h1 + 0.25 * h2
    return e1.movedim(0, ax), e2.movedim(0, ax)


def _hat(scheme, ff00, ffll, ffrr, fell, ferr, dell, derr, osc, flags=None):
    """The cell polynomial from its edges (gad.py:_ppm_pqm_hat :488-526 and
    the cell part of _ppm_pqm_flux_r :728-747); osc: a thunk returning the
    WENO weights; flags, a dict, receives the limiters' branches."""
    ppm = scheme in PPM_SCHEMES
    if scheme in (ENUM_PPM_NULL, ENUM_PQM_NULL):
        if ppm:
            return _ppm_coef(ff00, fell, ferr)
        return _pqm_coef(ff00, fell, ferr, dell, derr)
    dfm, d0, dfp = _plm_slope(ffll, ff00, ffrr)
    if ppm:
        lhat = _ppm_mono(ff00, ffll, ffrr, fell, ferr, d0, flags)
    else:
        lhat = _pqm_mono(ff00, ffll, ffrr, fell, ferr, dell, derr, dfm, d0,
                         dfp, flags)
    mono, lhat = lhat[-1], lhat[:-1]
    if scheme in (ENUM_PPM_MONO, ENUM_PQM_MONO):
        return lhat
    uhat = (_ppm_coef(ff00, fell, ferr) if ppm
            else _pqm_coef(ff00, fell, ferr, dell, derr))
    fdel = (ffrr - ff00).abs() + (ff00 - ffll).abs()
    fmag = ffll.abs() + ff00.abs() + ffrr.abs()
    s1, s2 = osc()
    blend = mono & (fdel > 1.0e-6 * fmag)
    if flags is not None:
        flags.update(blend=blend, ok=s1 > 0.0)
    return tuple(torch.where(blend, s1 * uu + s2 * ll, ll)
                 for uu, ll in zip(uhat, lhat))


def _integ(ss11, ss22: float, cs):
    """The upwind polynomial integrated over [ss11, ss22] (gad.py:532-536,
    :760-764)."""
    tot = 0.0
    for n, c in enumerate(cs, start=1):
        tot = tot + (ss22 ** n - _ipow(ss11, n)) * (1.0 / n) * c
    return tot


def _sl_flux(s, uvel, ufac, coefs, cfl_up, cfl_dn, band):
    """GAD_PPM_FLX_* / GAD_PQM_FLX_*: the semi-Lagrangian edge flux, the
    upwind cell polynomial integrated over the swept interval."""
    up = _integ(1.0 - 2.0 * cfl_up, 1.0, [s(c, -1) for c in coefs])
    dn = _integ(-1.0 - 2.0 * cfl_dn, -1.0, list(coefs))
    pos = uvel > 0.0
    intF = torch.where(pos, up, dn)
    ucfl = torch.where(pos, cfl_up, cfl_dn)
    mag = torch.clamp(ucfl.abs(), min=1.0e-20)
    intF = 0.5 * intF / torch.where(ucfl >= 0.0, mag, -mag)
    return torch.where(uvel == 0.0, torch.zeros_like(intF),
                       ufac * intF) * band


def ppm_pqm_band(shape, axis: str, margin: int, dtype, device):
    """gad.py:ppm_pqm_band (:548-562): x columns / y rows [margin,
    n - margin + 1), margin 3 for PPM and 4 for PQM."""
    return _band(shape, axis, margin, margin - 1, dtype, device)


def _ppm_pqm_flux_h(grid, scheme: int, axis: str, trans, vel, tracer,
                    deltaT, flags=None):
    """gad.py:_ppm_pqm_flux_h (:565-600): the horizontal PPM/PQM flux on
    all levels at once with the 3-D maskC; flags, a dict, receives the
    limiters' branches."""
    if axis == "x":
        s = lambda a, d: sh(a, di=d)                       # noqa: E731
        recip_dF, recip_dC, dF = grid.recip_dxF, grid.recip_dxC, grid.dxF
    else:
        s = lambda a, d: sh(a, dj=d)                       # noqa: E731
        recip_dF, recip_dC, dF = grid.recip_dyF, grid.recip_dyC, grid.dyF
    mask = grid.maskC
    f = tracer
    ppm = scheme in PPM_SCHEMES
    if ppm:
        fell = _p3e_edge(s, mask, f)
        ferr = s(fell, 1)
        dell = derr = None
    else:
        e1, e2 = _p5e_edge(s, mask, f, recip_dC)
        xhat = dF * 0.5
        fell, ferr = e1, s(e1, 1)
        dell, derr = e2 * xhat, s(e2, 1) * xhat
    osc = None
    if scheme in (ENUM_PPM_WENO, ENUM_PQM_WENO):
        d1, d2 = _osc_ends(axis, mask, f, *_osc_hat(s, mask, f))
        osc = lambda: _osc_mul(s, mask, d1, d2)            # noqa: E731
    ffll = f + s(mask, -1) * (s(f, -1) - f)
    ffrr = f + s(mask, 1) * (s(f, 1) - f)
    coefs = _hat(scheme, f, ffll, ffrr, fell, ferr, dell, derr, osc, flags)
    if not ppm:
        # gad_pqm_hat_*.F zeroes the polynomial on dry cells
        coefs = tuple(c * mask for c in coefs)
    cfl_up = vel * deltaT * s(recip_dF, -1)
    cfl_dn = vel * deltaT * recip_dF
    band = ppm_pqm_band(f.shape, axis, 3 if ppm else 4, f.dtype, f.device)
    return _sl_flux(s, vel, trans, coefs, cfl_up, cfl_dn, band)


def _ppm_pqm_flux_r(grid, scheme: int, rTrans, wFld, tracer, deltaT):
    """gad.py:_ppm_pqm_flux_r (:630-780): the vertical PPM/PQM flux. The
    columns are padded with 3 ghost copies of their end values at both
    ends, whose mask is 0; the transport is rTrans * maskC(k-1). The flux
    at the surface is 0."""
    nr = tracer.shape[0]
    mC = grid.maskC
    ppm = scheme in PPM_SCHEMES
    P = torch.cat([tracer[:1].expand(3, -1, -1), tracer,
                   tracer[-1:].expand(3, -1, -1)])
    M = torch.cat([torch.zeros_like(mC[:3]), mC, torch.zeros_like(mC[:3])])

    def cell(a, d, n):
        # the value at 1-based cell ir+d for ir = 1..n (cell 1 at index 3)
        return a[3 + d:3 + d + n]

    # edges at interfaces 1..nr+1 (between cells ir-1 and ir): the stencils
    # of _p3e_edge / _p5e_edge on the padded column
    def s_edge(a, d):
        return cell(a, d, nr + 1)

    mm1 = s_edge(M, -1)
    fm1v = s_edge(P, 0) + mm1 * (s_edge(P, -1) - s_edge(P, 0))
    f0v = s_edge(P, -1) + s_edge(M, 0) * (s_edge(P, 0) - s_edge(P, -1))
    mm2 = s_edge(M, -2) * mm1
    tmp = 2.0 * fm1v - f0v
    fm2v = tmp + mm2 * (s_edge(P, -2) - tmp)
    mp1 = s_edge(M, 1) * s_edge(M, 0)
    if ppm:
        tmp = 2.0 * f0v - fm1v
        fp1v = tmp + mp1 * (s_edge(P, 1) - tmp)
        eval_ = (-(1.0 / 12.0) * (fm2v + fp1v)
                 + (7.0 / 12.0) * (fm1v + f0v))
    else:
        mm3 = s_edge(M, -3) * mm2
        tmp = 2.0 * fm2v - fm1v
        fm3v = tmp + mm3 * (s_edge(P, -3) - tmp)
        mp2 = s_edge(M, 2) * mp1
        tmp = 2.0 * f0v - fm1v
        fp1v = tmp + mp1 * (s_edge(P, 1) - tmp)
        tmp = 2.0 * fp1v - f0v
        fp2v = tmp + mp2 * (s_edge(P, 2) - tmp)
        eval_ = ((1.0 / 60.0) * (fm3v + fp2v)
                 - (8.0 / 60.0) * (fm2v + fp1v)
                 + (37.0 / 60.0) * (fm1v + f0v))
        eslp = (-(1.0 / 90.0) * (fm3v - fp2v)
                + (5.0 / 36.0) * (fm2v - fp1v)
                - (49.0 / 36.0) * (fm1v - f0v)
                ) * grid.recip_drC[:nr + 1, None, None]

    # the cell polynomials of cells 1..nr
    f, mk = tracer, mC
    mkm = torch.cat([torch.zeros_like(mk[:1]), mk[:-1]])
    mkp = torch.cat([mk[1:], torch.zeros_like(mk[:1])])
    fkm = torch.cat([f[:1], f[:-1]])
    fkp = torch.cat([f[1:], f[-1:]])
    ffll = f + mkm * (fkm - f)
    ffrr = f + mkp * (fkp - f)
    fell, ferr = eval_[:nr], eval_[1:]
    dell = derr = None
    if not ppm:
        rhat = grid.drF[:, None, None] * 0.5
        dell, derr = eslp[:nr] * rhat, eslp[1:] * rhat

    def osc():
        # the oscillation indicators on the padded column (the interior
        # formula: the padded ends lie outside the +-2 window of real cells)
        sh1 = torch.cat([M[:1] * 0, M[:-1]])
        fm1o = P + sh1 * (torch.cat([P[:1], P[:-1]]) - P)
        sh2 = torch.cat([M[1:], M[:1] * 0])
        fp1o = P + sh2 * (torch.cat([P[1:], P[-1:]]) - P)
        D1 = 0.25 * (fp1o - fm1o)
        D2 = 0.25 * fp1o - 0.5 * P + 0.25 * fm1o
        offs = (-2, -1, 0, 1, 2)
        return _osc_weights([(cell(D1, o, nr), cell(D2, o, nr))
                             for o in offs], [cell(M, o, nr) for o in offs])

    coefs = _hat(scheme, f, ffll, ffrr, fell, ferr, dell, derr, osc)
    if not ppm:
        coefs = tuple(c * mk for c in coefs)

    # the fluxes at interfaces 2..nr (array index 1..nr-1)
    rdrF = grid.recip_drF[:, None, None]
    cm = [torch.cat([c[:1], c[:-1]]) for c in coefs]
    w = wFld
    # w < 0: the upwind cell is ir-1, ss in [1 + 2 wCFL, 1]
    cfl_m = w * deltaT * torch.cat([rdrF[:1], rdrF[:-1]])
    # w > 0: cell ir, ss in [-1 + 2 wCFL, -1]
    cfl_p = w * deltaT * rdrF
    up = _integ(1.0 + 2.0 * cfl_m, 1.0, cm)
    dn = _integ(-1.0 + 2.0 * cfl_p, -1.0, list(coefs))
    neg = w < 0.0
    intF = torch.where(neg, up, dn)
    wcfl = torch.where(neg, cfl_m, cfl_p)
    mag = torch.clamp(wcfl.abs(), min=1.0e-20)
    # the sign of the JAX code (gad.py:772-777): divide the oriented
    # integral by -wCFL
    intF = -0.5 * intF / torch.where(wcfl >= 0.0, mag, -mag)
    flx = torch.where(w == 0.0, torch.zeros_like(intF), rTrans * mkm * intF)
    flx[0] = 0.0
    return flx
