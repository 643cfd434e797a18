"""Equation of state (mitgcm_tpu/ops/eos.py:find_rho) in z-coordinates:
LINEAR, JMD95Z/JMD95P/UNESCO (Jackett & McDougall 1995, rho_p0 over one
minus p over the secant bulk modulus) and MDJWF (McDougall, Jackett,
Wright & Feistel 2003, a rational function).

`find_rho` runs kernel R's eos_find_rho (kernels/csrc/eos.cu) for CUDA
tensors and the plain PyTorch twin `_find_rho_plain` for CPU tensors or
when impl="plain" is asked for; given maskC it returns rho * maskC from
the same launch (the step's rhoInSitu). The LINEAR kind reads tRef and
sRef from the grid (`ref_profiles`). find_rho's LINEAR kind, which the
gyre's adjoint differentiates, has a backward kernel on the card, kernel
R' (eos_linear_adj; its plain version `eos_linear_vjp_plain`);
calc_sigmaR's LINEAR kind runs under kernels.TwinVJP (its gradient is the
twin's); the nonlinear kinds refuse an input that requires grad
(`refuse_grad`, for find_rho and model/thermodynamics.py:calc_sigmaR
alike). `sigma_r_kernel`
launches kernel R's eos_sigma_r, which model/thermodynamics.py:calc_sigmaR
dispatches. POLY3, TEOS10, IDEALG and p-coordinates are refused.
"""

from __future__ import annotations

from typing import Optional

import torch

from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.grid import Grid

# Jackett & McDougall 1995 / UNESCO coefficients (find_rhop0.F,
# find_bulkmod.F), as in the JAX package
_EOS_JMDCFW = [999.842594, 6.793952e-2, -9.095290e-3, 1.001685e-4,
               -1.120083e-6, 6.536332e-9]
_EOS_JMDCSW = [8.244930e-1, -4.089900e-3, 7.643800e-5, -8.246700e-7,
               5.387500e-9, -5.724660e-3, 1.022700e-4, -1.654600e-6,
               4.831400e-4]
_EOS_JMDCKFW = [1.965933e4, 1.444304e2, -1.706103, 9.648704e-3, -4.190253e-5]
_EOS_JMDCKSW = [5.284855e1, -3.101089e-1, 6.283263e-3, -5.084188e-5,
                3.886640e-1, 9.085835e-3, -4.619924e-4]
_EOS_JMDCKP = [3.186519, 2.212276e-2, -2.984642e-4, 1.956415e-6,
               6.704388e-3, -1.847318e-4, 2.059331e-7, 1.480266e-4,
               2.102898e-4, -1.202016e-5, 1.394680e-7, -2.040237e-6,
               6.128773e-8, 6.207323e-10]
# McDougall et al. 2003 (ini_eos.F:235-260)
_MDJWF_NUM = [9.99843699e+02, 7.35212840e+00, -5.45928211e-02,
              3.98476704e-04, 2.96938239e+00, -7.23268813e-03,
              2.12382341e-03, 1.04004591e-02, 1.03970529e-07,
              5.18761880e-06, -3.24041825e-08, -1.23869360e-11]
_MDJWF_DEN = [1.00000000e+00, 7.28606739e-03, -4.60835542e-05,
              3.68390573e-07, 1.80809186e-10, 2.14691708e-03,
              -9.27062484e-06, -1.78343643e-10, 4.76534122e-06,
              1.63410736e-09, 5.30848875e-06, -3.03175128e-16,
              -1.27934137e-17]

_SI2BAR = 1.0e-5    # Pa -> bar
_SI2DBAR = 1.0e-4   # Pa -> dbar

JMD95 = ("JMD95Z", "JMD95P", "UNESCO")
NONLINEAR = JMD95 + ("MDJWF",)
# kernel R's eos switch
_KIND = {"JMD95Z": 0, "JMD95P": 0, "UNESCO": 0, "MDJWF": 1, "LINEAR": 2}

# calls of find_rho's twin, for the card's runs to show that the main path
# never ran it
plain_calls = 0


def rho_p0(t, s):
    """Density at p = 0 (find_rhop0.F)."""
    s3o2 = s * torch.sqrt(torch.clamp_min(s, 0.0))
    c = _EOS_JMDCFW
    rfresh = (c[0] + t * (c[1] + t * (c[2] + t * (c[3] + t * (c[4]
                                                             + t * c[5])))))
    d = _EOS_JMDCSW
    rsalt = (s * (d[0] + t * (d[1] + t * (d[2] + t * (d[3] + t * d[4]))))
             + s3o2 * (d[5] + t * (d[6] + t * d[7]))
             + s * s * d[8])
    return rfresh + rsalt


def bulkmod(p, t, s):
    """Secant bulk modulus K(S, T, p) (find_bulkmod.F); p in bar."""
    s3o2 = s * torch.sqrt(torch.clamp_min(s, 0.0))
    f = _EOS_JMDCKFW
    bfresh = f[0] + t * (f[1] + t * (f[2] + t * (f[3] + t * f[4])))
    g = _EOS_JMDCKSW
    bsalt = (s * (g[0] + t * (g[1] + t * (g[2] + t * g[3])))
             + s3o2 * (g[4] + t * (g[5] + t * g[6])))
    h = _EOS_JMDCKP
    bpres = (p * (h[0] + t * (h[1] + t * (h[2] + t * h[3])))
             + p * s * (h[4] + t * (h[5] + t * h[6])) + p * s3o2 * h[7]
             + p * p * (h[8] + t * (h[9] + t * h[10]))
             + p * p * s * (h[11] + t * (h[12] + t * h[13])))
    return bfresh + bsalt + bpres


def _mdjwf_num(t1, s1, p1):
    n = _MDJWF_NUM
    t2 = t1 * t1
    return (n[0] + t1 * (n[1] + t1 * (n[2] + n[3] * t1))
            + s1 * (n[4] + n[5] * t1 + n[6] * s1)
            + p1 * (n[7] + n[8] * t2 + n[9] * s1
                    + p1 * (n[10] + n[11] * t2)))


def _mdjwf_den(t1, s1, p1):
    """1/denominator (FIND_RHODEN)."""
    d = _MDJWF_DEN
    t2 = t1 * t1
    sp5 = torch.sqrt(torch.clamp_min(s1, 0.0))
    s1 = torch.clamp_min(s1, 0.0)
    p1t1 = p1 * t1
    den = (d[0] + t1 * (d[1] + t1 * (d[2] + t1 * (d[3] + t1 * d[4])))
           + s1 * (d[5] + t1 * (d[6] + d[7] * t2)
                   + sp5 * (d[8] + d[9] * t2))
           + p1 * (d[10] + p1t1 * (d[11] * t2 + d[12] * p1)))
    return 1.0 / den


def _pressure_terms(cfg: Config, grid: Grid, totPhiHyd):
    """How kernel R gets its pressure (pressure_for_eos.F, z-coordinates):
    (profile [nr], use_phi). With use_phi the pressure is
    (rhoConst * (totPhiHyd + profile[k]) + dp0) * scale, profile being
    phiRef(2k); otherwise it is profile[k] itself, the static reference
    pressure in bar (JMD95) or dbar (MDJWF)."""
    rc = grid.rC
    eos = cfg.eosType.upper()
    if cfg.selectP_inEOS_Zc == 2 and totPhiHyd is not None:
        return (rc - grid.rF[0]) * cfg.gravity * cfg.gravitySign, True
    if eos in JMD95:
        return -cfg.rhoConst * rc * cfg.gravity * _SI2BAR, False
    dp0 = cfg.surf_pRef - cfg.eosRefP0
    return (-cfg.rhoConst * rc * cfg.gravity + dp0) * _SI2DBAR, False


def _pressure_scale(cfg: Config) -> float:
    return _SI2BAR if cfg.eosType.upper() in JMD95 else _SI2DBAR


def ref_profiles(cfg: Config, grid: Grid, like: torch.Tensor):
    """(tRef, sRef) [nr] for the LINEAR kind: the grid's, which build_grid
    made on the device once; on a grid that holds none (one carried from
    the JAX package) made from cfg in like's dtype and on its device, each
    rounded as torch.tensor rounds it."""
    if grid.tRef is not None:
        return grid.tRef, grid.sRef
    return tuple(torch.tensor(ref, dtype=like.dtype, device=like.device)
                 for ref in (cfg.tRef, cfg.sRef))


def refuse_grad(cfg: Config, fn: str, **tensors) -> None:
    """Raise for the nonlinear kinds if one of `tensors` (None allowed)
    requires grad: only the LINEAR kind, which the gyre's adjoint
    differentiates, has a backward (kernel R' in find_rho, kernels.TwinVJP
    in calc_sigmaR)."""
    if cfg.eosType.upper() == "LINEAR":
        return
    grads = [n for n, t in tensors.items()
             if t is not None and t.requires_grad]
    if grads:
        raise ValueError(f"{fn}: {grads} require grad; kernel R has no "
                         f"backward kernel for eosType={cfg.eosType}")


def _find_rho_nonlinear_plain(cfg: Config, theta, salt, profile,
                              use_phi: bool, totPhiHyd):
    """Kernel R's twin: find_rho's JMD95 and MDJWF branches
    (ops/eos.py:233-275) in their operation order."""
    prof = profile[:, None, None]
    if use_phi:
        dp0 = cfg.surf_pRef - cfg.eosRefP0
        p = (cfg.rhoConst * (totPhiHyd + prof) + dp0) * _pressure_scale(cfg)
    else:
        p = prof
    if cfg.eosType.upper() in JMD95:
        rp0 = rho_p0(theta, salt)
        bm = bulkmod(p, theta, salt)
        return rp0 / (1.0 - p / bm) - cfg.rhoConst
    s1 = torch.clamp_min(salt, 0.0)
    return (_mdjwf_num(theta, s1, p) * _mdjwf_den(theta, salt, p)
            - cfg.rhoConst)


def pressure_for_eos(cfg: Config, grid: Grid, totPhiHyd):
    """pressure_for_eos.F in z-coordinates, in Pa (ops/eos.py:72-86):
    from totPhiHyd when selectP_inEOS_Zc = 2, else the static reference
    profile [nr, 1, 1]."""
    rc = grid.rC[:, None, None]
    dp0 = cfg.surf_pRef - cfg.eosRefP0
    if cfg.selectP_inEOS_Zc == 2 and totPhiHyd is not None:
        phiRef2k = (rc - grid.rF[0]) * cfg.gravity * cfg.gravitySign
        return cfg.rhoConst * (totPhiHyd + phiRef2k) + dp0
    return -cfg.rhoConst * rc * cfg.gravity + dp0


def find_alpha(cfg: Config, grid: Grid, theta, salt, totPhiHyd=None):
    """d(rho)/d(theta) at (k, kRef = k) (find_alpha.F; ops/eos.py:112),
    plain PyTorch in the JAX code's operation order. Kernel K
    (kernels/csrc/kpp.cu) evaluates it at the surface through eos.cuh."""
    check_eos(cfg)
    eos = cfg.eosType.upper()
    if eos == "LINEAR":
        return torch.full_like(theta, -cfg.rhoNil * cfg.tAlpha)
    p1 = pressure_for_eos(cfg, grid, totPhiHyd) * _pressure_scale(cfg)
    t1 = theta
    t2 = t1 * t1
    s1 = torch.clamp_min(salt, 0.0)
    if eos == "MDJWF":
        n, d = _MDJWF_NUM, _MDJWF_DEN
        sp5 = torch.sqrt(s1)
        p1t1 = p1 * t1
        rhoDen = _mdjwf_den(t1, salt, p1)
        rhoLoc = _mdjwf_num(t1, s1, p1)
        dnum_dt = (n[1] + t1 * (2.0 * n[2] + 3.0 * n[3] * t1) + n[5] * s1
                   + p1t1 * (2.0 * n[8] + 2.0 * n[11] * p1))
        dden_dt = (d[1] + t1 * (2.0 * d[2]
                                + t1 * (3.0 * d[3] + 4.0 * d[4] * t1))
                   + s1 * (d[6] + t1 * (3.0 * d[7] * t1
                                        + 2.0 * d[9] * sp5))
                   + p1 * p1 * (3.0 * d[11] * t2 + d[12] * p1))
        return rhoDen * (dnum_dt - (rhoLoc * rhoDen) * dden_dt)
    t3 = t2 * t1
    s3o2 = torch.sqrt(s1 * s1 * s1)
    p2 = p1 * p1
    cF, cS = _EOS_JMDCFW, _EOS_JMDCSW
    kF, kS, kP = _EOS_JMDCKFW, _EOS_JMDCKSW, _EOS_JMDCKP
    drhoP0dt = (cF[1] + 2.0 * cF[2] * t1 + 3.0 * cF[3] * t2
                + 4.0 * cF[4] * t3 + 5.0 * cF[5] * t3 * t1
                + s1 * (cS[1] + 2.0 * cS[2] * t1 + 3.0 * cS[3] * t2
                        + 4.0 * cS[4] * t3)
                + s3o2 * (cS[6] + 2.0 * cS[7] * t1))
    dKdt = (kF[1] + 2.0 * kF[2] * t1 + 3.0 * kF[3] * t2
            + 4.0 * kF[4] * t3
            + s1 * (kS[1] + 2.0 * kS[2] * t1 + 3.0 * kS[3] * t2)
            + s3o2 * (kS[5] + 2.0 * kS[6] * t1)
            + p1 * (kP[1] + 2.0 * kP[2] * t1 + 3.0 * kP[3] * t2)
            + p1 * s1 * (kP[5] + 2.0 * kP[6] * t1)
            + p2 * (kP[9] + 2.0 * kP[10] * t1)
            + p2 * s1 * (kP[12] + 2.0 * kP[13] * t1))
    K = bulkmod(p1, t1, s1)
    rp0 = rho_p0(t1, s1)
    Kp = K - p1
    return ((K * K * drhoP0dt - K * p1 * drhoP0dt - rp0 * p1 * dKdt)
            / (Kp * Kp))


def find_beta(cfg: Config, grid: Grid, theta, salt, totPhiHyd=None):
    """d(rho)/d(salt) at (k, kRef = k) (find_alpha.F FIND_BETA;
    ops/eos.py:175), as find_alpha."""
    check_eos(cfg)
    eos = cfg.eosType.upper()
    if eos == "LINEAR":
        return torch.full_like(theta, cfg.rhoNil * cfg.sBeta)
    p1 = pressure_for_eos(cfg, grid, totPhiHyd) * _pressure_scale(cfg)
    t1 = theta
    t2 = t1 * t1
    s1 = torch.clamp_min(salt, 0.0)
    if eos == "MDJWF":
        n, d = _MDJWF_NUM, _MDJWF_DEN
        sp5 = torch.sqrt(s1)
        rhoDen = _mdjwf_den(t1, salt, p1)
        rhoLoc = _mdjwf_num(t1, s1, p1)
        dnum_ds = n[4] + n[5] * t1 + 2.0 * n[6] * s1 + n[9] * p1
        dden_ds = (d[5] + t1 * (d[6] + d[7] * t2)
                   + 1.5 * sp5 * (d[8] + d[9] * t2))
        return rhoDen * (dnum_ds - (rhoLoc * rhoDen) * dden_ds)
    t3 = t2 * t1
    s3o2 = 1.5 * torch.sqrt(s1)
    cS = _EOS_JMDCSW
    kS, kP = _EOS_JMDCKSW, _EOS_JMDCKP
    drhoP0dS = (cS[0] + cS[1] * t1 + cS[2] * t2 + cS[3] * t3
                + cS[4] * t3 * t1
                + s3o2 * (cS[5] + cS[6] * t1 + cS[7] * t2)
                + 2.0 * cS[8] * s1)
    dKdS = (kS[0] + kS[1] * t1 + kS[2] * t2 + kS[3] * t3
            + s3o2 * (kS[4] + kS[5] * t1 + kS[6] * t2)
            + p1 * (kP[4] + kP[5] * t1 + kP[6] * t2)
            + s3o2 * p1 * kP[7]
            + p1 * p1 * (kP[11] + kP[12] * t1 + kP[13] * t2))
    K = bulkmod(p1, t1, s1)
    rp0 = rho_p0(t1, s1)
    Kp = K - p1
    return ((K * K * drhoP0dS - K * p1 * drhoP0dS - rp0 * p1 * dKdS)
            / (Kp * Kp))


def check_eos(cfg: Config) -> None:
    eos = cfg.eosType.upper()
    if eos != "LINEAR" and eos not in NONLINEAR:
        raise NotImplementedError(f"eosType={cfg.eosType} is not ported")
    if cfg.usingPCoords:
        raise NotImplementedError("find_rho: p-coordinates are not ported")


def _find_rho_plain(cfg: Config, grid: Grid, theta, salt, totPhiHyd,
                    mask):
    """Kernel R's eos_find_rho twin: find_rho (ops/eos.py:218-275) in the
    JAX code's operation order, times mask when given."""
    if cfg.eosType.upper() == "LINEAR":
        tref, sref = ref_profiles(cfg, grid, theta)
        drho = cfg.rhoNil - cfg.rhoConst
        rho = cfg.rhoNil * (cfg.sBeta * (salt - sref[:, None, None])
                            - cfg.tAlpha * (theta - tref[:, None, None])
                            ) + drho
    else:
        profile, use_phi = _pressure_terms(cfg, grid, totPhiHyd)
        rho = _find_rho_nonlinear_plain(cfg, theta, salt, profile, use_phi,
                                        totPhiHyd)
    return rho if mask is None else rho * mask


def kernel_inputs(cfg: Config, grid: Grid, theta, totPhiHyd):
    """What a launch of kernel R reads besides the tracers: {name: tensor}
    of totPhiHyd (under use_phi), the pressure profile (nonlinear kinds) or
    tRef and sRef (LINEAR), and the launch's (kind, use_phi, parameter
    array)."""
    eos = cfg.eosType.upper()
    params = [cfg.rhoConst, cfg.surf_pRef - cfg.eosRefP0,
              _pressure_scale(cfg), cfg.rhoNil, cfg.tAlpha, cfg.sBeta,
              cfg.rhoNil - cfg.rhoConst]
    if eos == "LINEAR":
        tref, sref = ref_profiles(cfg, grid, theta)
        return {"tRef": tref, "sRef": sref}, (_KIND[eos], False, params)
    profile, use_phi = _pressure_terms(cfg, grid, totPhiHyd)
    ins = {"profile": profile}
    if use_phi:
        ins["totPhiHyd"] = totPhiHyd
    return ins, (_KIND[eos], use_phi, params)


def _table(ins, *head):
    """Kernel R's pointer table: the tracers (head), totPhiHyd, the
    profile, tRef and sRef (None where not read)."""
    return list(head) + [ins.get(n) for n in ("totPhiHyd", "profile",
                                              "tRef", "sRef")]


def _find_rho_kernel(cfg: Config, grid: Grid, theta, salt, totPhiHyd,
                     mask):
    """Kernel R's eos_find_rho on the card (eos.cu)."""
    ins, (kind, use_phi, params) = kernel_inputs(cfg, grid, theta,
                                                 totPhiHyd)
    nr, nyp, nxp = theta.shape
    rho = torch.empty_like(theta)
    fields = dict(theta=theta, salt=salt, rho=rho)
    if use_phi:
        fields["totPhiHyd"] = totPhiHyd
    if mask is not None:
        fields["maskC"] = mask
    kernels.check_fields(theta.dtype, theta.shape, **fields)
    kernels.check_fields(theta.dtype, (nr,), **{
        n: t for n, t in ins.items() if n != "totPhiHyd"})
    table = _table(ins, theta, salt) + [mask, rho]
    params = kernels.doubles(params)
    kernels.launch("eos_find_rho", theta.dtype, kernels.pointer_table(table),
                   len(table), params, len(params), nr, nyp * nxp, kind,
                   int(use_phi), int(mask is not None))
    return (rho,)


def sigma_r_kernel(cfg: Config, grid: Grid, rhoInSitu, theta, salt,
                   totPhiHyd=None):
    """Kernel R's eos_sigma_r on the card (eos.cu): model/thermodynamics.py:
    calc_sigmaR, the k-1 water's density at level k read in place."""
    ins, (kind, use_phi, params) = kernel_inputs(cfg, grid, theta,
                                                 totPhiHyd)
    nr, nyp, nxp = theta.shape
    sigmaR = torch.empty_like(theta)
    fields = dict(theta=theta, salt=salt, maskC=grid.maskC,
                  rhoInSitu=rhoInSitu, sigmaR=sigmaR)
    if use_phi:
        fields["totPhiHyd"] = totPhiHyd
    kernels.check_fields(theta.dtype, theta.shape, **fields)
    kernels.check_fields(theta.dtype, (nr,), **{
        n: t for n, t in ins.items() if n != "totPhiHyd"})
    kernels.check_fields(theta.dtype, (nr + 1,), recip_drC=grid.recip_drC)
    table = _table(ins, theta, salt) + [grid.maskC, grid.recip_drC,
                                        rhoInSitu, sigmaR]
    params = kernels.doubles(params + [cfg.rkSign])
    kernels.launch("eos_sigma_r", theta.dtype, kernels.pointer_table(table),
                   len(table), params, len(params), nr, nyp, nxp, kind,
                   int(use_phi))
    return (sigmaR,)


def find_rho(cfg: Config, grid: Grid, theta: torch.Tensor,
             salt: torch.Tensor, totPhiHyd: Optional[torch.Tensor] = None,
             impl: str = None, mask: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """Density anomaly rho' = rho - rhoConst at every level (find_rho.F
    with kRef = k), times mask when given. totPhiHyd feeds the pressure
    when selectP_inEOS_Zc = 2 (the last step's hydrostatic potential)."""
    check_eos(cfg)
    phi = totPhiHyd if cfg.selectP_inEOS_Zc == 2 else None
    refuse_grad(cfg, "find_rho", theta=theta, salt=salt, totPhiHyd=phi)
    if not kernels.use_kernel(theta, impl):
        global plain_calls
        plain_calls += 1
        return _find_rho_plain(cfg, grid, theta, salt, totPhiHyd, mask)
    if cfg.eosType.upper() != "LINEAR":
        return _find_rho_kernel(cfg, grid, theta, salt, totPhiHyd, mask)[0]
    # the LINEAR kind reads no totPhiHyd; its gradient is kernel R'
    tref, sref = ref_profiles(cfg, grid, theta)
    kernels.refuse_grad("find_rho", mask=mask, tRef=tref, sRef=sref)
    return kernels.KernelVJP.apply(
        lambda t, s: _find_rho_kernel(cfg, grid, t, s, None, mask),
        lambda need, rho_bar: _eos_linear_adj_kernel(cfg, need, rho_bar,
                                                     mask),
        theta, salt)[0]


def eos_linear_vjp_plain(cfg: Config, rho_bar, mask=None):
    """Kernel R''s plain version, in its operation order: (theta_bar,
    salt_bar) of the LINEAR kind, times mask when given."""
    r = (rho_bar if mask is None else rho_bar * mask) * cfg.rhoNil
    return (-r) * cfg.tAlpha, r * cfg.sBeta


def _eos_linear_adj_kernel(cfg: Config, need, rho_bar, mask=None):
    """Kernel R''s eos_linear_adj on the card (eos.cu): the cotangents of
    (theta, salt) that `need` asks for, fresh."""
    outs = [torch.empty_like(rho_bar) if n else None for n in need]
    kernels.check_fields(rho_bar.dtype, rho_bar.shape, rho_bar=rho_bar, **{
        n: t for n, t in (("maskC", mask), ("theta_bar", outs[0]),
                          ("salt_bar", outs[1])) if t is not None})
    nr = rho_bar.shape[0]
    table = [rho_bar, mask, *outs]
    kernels.launch("eos_linear_adj", rho_bar.dtype,
                   kernels.pointer_table(table), len(table), nr,
                   rho_bar.numel() // nr, cfg.rhoNil, cfg.tAlpha, cfg.sBeta)
    return outs
