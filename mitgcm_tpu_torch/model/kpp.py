"""KPP boundary-layer mixing (Large, McWilliams & Doney 1994), the port of
mitgcm_tpu/model/kpp.py.

Reference: pkg/kpp - kpp_calc.F (top level), kpp_routines.F (KPPMIX,
BLDEPTH, WSCALE, RI_IWMIX, BLMIX, ENHANCE, STATEKPP), kpp_forcing_surf.F,
kpp_init_fixed.F (the turbulent-velocity-scale tables), model/src/swfrac.F.

`KPP.calc` runs kernel K (kernels/csrc/kpp.cu) for CUDA tensors: K-pre
(`kpp_pre`, one thread per cell: the densities of STATEKPP, dbloc, Ritop,
the shear and dVsq, and per column ustar, bo and bosol, then `kpp_smooth`,
the SMOOTH_DBLOC filter, when that option is on), and K-col (`kpp_col`,
one thread per column: RI_IWMIX, BLDEPTH, BLMIX, ENHANCE, the combine
step and the transfer to the state's fields). For CPU tensors, or with
impl="plain", it runs the plain twins `_kpp_pre_plain`,
`_kpp_smooth_plain` and `_kpp_col_plain`, which replay the JAX code's
operation order on whole
[nr(+2), nyp, nxp] arrays. Arrays suffixed `_f` keep the Fortran level
index on axis 0 (0..nr+1), as in the JAX code, so that each line can be
checked against its JAX line. `visc_uv` and `ghat_flux` are plain PyTorch
glue.

Left out, and refused by `check_kpp`: KPP_ESTIMATE_UREF, KPPuseDoubleDiff,
KPP_ghatUseTotalDiffus and the smoothing options the JAX experiment
refuses. No gradient: the adjoint refuses useKPP.
"""

from __future__ import annotations

import numpy as np
import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.ops import eos
from mitgcm_tpu_torch.ops.stencil import shift as sh

_NNI, _NNJ = 890, 480   # lookup table dims (KPP_PARAMS.h:153)

# options the port refuses: those of the JAX experiment (experiment.py:
# 413-417) and the KPP_ESTIMATE_UREF reference velocity
REFUSED_OPTIONS = ("KPP_ESTIMATE_UREF", "KPP_SMOOTH_DVSQ", "KPP_SMOOTH_DENS",
                   "KPP_SMOOTH_VISC", "KPP_SMOOTH_DIFF",
                   "ALLOW_KPP_VERTICALLY_SMOOTH")
DEFAULT_OPTIONS = frozenset({"KPP_GHAT", "KPP_SMOOTH_SHSQ",
                             "KPP_SMOOTH_DBLOC"})
# kernel K's EOS switch (eos.cuh)
_EOS_KIND = {"JMD95Z": 0, "JMD95P": 0, "UNESCO": 0, "MDJWF": 1, "LINEAR": 2}
# calls of KPP.calc that ran the plain twins (a run on the card reads it to
# show that its kernel path never did)
plain_calls = 0


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c rounded as one IEEE division on every device: PyTorch's CUDA
    kernels multiply by the reciprocal of a Python-number divisor, which
    kernel K (and the JAX package) do not, so the divisor is a tensor."""
    return a / a.new_tensor(c)


def _fsign(a: float, b: torch.Tensor) -> torch.Tensor:
    """Fortran SIGN(a, b): |a| with the sign of b (+ for b == 0)."""
    return torch.where(b >= 0, b.new_tensor(a), b.new_tensor(-a))


def swfrac(facz):
    """model/src/swfrac.F: fraction of shortwave at depth; facz = fact*z.
    Jerlov water type Ib (jwtype=2): rfac=0.62, a1=0.6, a2=20."""
    rfac, a1, a2 = 0.62, 0.6, 20.0
    return torch.where(facz < -200.0, facz.new_tensor(0.0),
                       rfac * torch.exp(_div(facz, a1))
                       + (1.0 - rfac) * torch.exp(_div(facz, a2)))


class KPP:
    """Fixed per-experiment KPP data (KPP_PARM01 + lookup tables + grid).

    group: KPP_PARM01 settings by name (as core/nml.py reads them from a
    data.kpp); options: the #define'd KPP_OPTIONS.h macros."""

    def __init__(self, cfg: Config, grid: Grid, group: dict | None = None,
                 options=None):
        self.cfg, self.grid = cfg, grid
        # --- KPP_PARM01 defaults (kpp_readparms.F:80-152) ---
        p = dict(
            kpp_freq=cfg.deltaTClock, KPPuseDoubleDiff=False,
            LimitHblStable=True, KPP_ghatUseTotalDiffus=False,
            minKPPhbl=None,
            epsln=1e-20, phepsi=1e-10, epsilon=0.1, vonk=0.4, dB_dz=5.2e-5,
            conc1=5.0, conam=1.257, concm=8.380, conc2=16.0, zetam=-0.2,
            conas=-28.86, concs=98.96, conc3=16.0, zetas=-1.0,
            Ricr=0.3, cekman=0.7, cmonob=1.0, concv=1.8, hbf=1.0,
            zmin=-4e-7, zmax=0.0, umin=0.0, umax=4e-2,
            num_v_smooth_Ri=0, Riinfty=0.7, BVSQcon=-0.2e-4,
            difm0=5e-3, difs0=5e-3, dift0=5e-3,
            difmcon=0.1, difscon=0.1, diftcon=0.1,
            Rrho0=1.9, dsfmax=10e-3, cstar=10.0,
        )
        lower = {k.lower(): k for k in p}
        for k, v in (group or {}).items():
            kc = lower.get(k.lower())
            if kc is None:
                if k.lower() not in ("kppwritestate", "kpp_dumpfreq",
                                     "kpp_tavefreq", "kppmixingmaps"):
                    raise KeyError(f"KPP_PARM01: unknown parameter {k}")
                continue
            p[kc] = type(p[kc])(v) if p[kc] is not None else float(v)
        self.p = p
        self.options = frozenset(options or ())
        # the JAX package reads no use_ghat: the nonlocal flux is applied
        # whether KPP_GHAT is defined or not (ROADMAP Queue 3)
        self.smooth_shsq = "KPP_SMOOTH_SHSQ" in self.options
        self.smooth_dbloc = "KPP_SMOOTH_DBLOC" in self.options

        # --- derived constants (kpp_init_fixed.F:125-126) ---
        self.Vtc = (p["concv"] * np.sqrt(0.2 / p["concs"] / p["epsilon"])
                    / p["vonk"] ** 2 / p["Ricr"])
        self.cg = (p["cstar"] * p["vonk"]
                   * (p["concs"] * p["vonk"] * p["epsilon"]) ** (1.0 / 3.0))

        # --- wm/ws lookup tables (kpp_init_fixed.F:132-157), numpy f64 ---
        self.deltaz = (p["zmax"] - p["zmin"]) / (_NNI + 1)
        self.deltau = (p["umax"] - p["umin"]) / (_NNJ + 1)
        zehat = self.deltaz * np.arange(_NNI + 2) + p["zmin"]   # [nni+2]
        usta = self.deltau * np.arange(_NNJ + 2) + p["umin"]    # [nnj+2]
        Z, U = np.meshgrid(zehat, usta, indexing="ij")
        zeta = Z / np.maximum(p["phepsi"], U ** 3)
        wmt = np.where(
            Z >= 0.0, p["vonk"] * U / (1.0 + p["conc1"] * zeta),
            np.where(zeta > p["zetam"],
                     p["vonk"] * U * np.abs(1.0 - p["conc2"] * zeta) ** 0.25,
                     p["vonk"] * np.abs(p["conam"] * U ** 3
                                        - p["concm"] * Z) ** (1.0 / 3.0)))
        wst = np.where(
            Z >= 0.0, p["vonk"] * U / (1.0 + p["conc1"] * zeta),
            np.where(zeta > p["zetas"],
                     p["vonk"] * U * np.sqrt(np.abs(1.0 - p["conc3"] * zeta)),
                     p["vonk"] * np.abs(p["conas"] * U ** 3
                                        - p["concs"] * Z) ** (1.0 / 3.0)))

        # --- vertical grid (kpp_init_fixed.F:163-181) ---
        nr = cfg.nr
        rC = grid.rC.detach().cpu().double().numpy()
        drF = grid.drF.detach().cpu().double().numpy()
        if p["minKPPhbl"] is None:
            p["minKPPhbl"] = float(-rC[0])
        zg = np.empty(nr + 2)
        zg[0] = p["phepsi"]
        zg[1:nr + 1] = rC
        zg[nr + 1] = rC[nr - 1] * 100.0
        hw = np.empty(nr + 2)
        hw[0] = p["phepsi"]
        hw[1:nr + 1] = drF
        hw[nr + 1] = p["phepsi"]
        self.zgrid_f, self.hwide_f = zg, hw
        # number of wet levels per column (nzmax / kLowC)
        self.kmtj = grid.maskC.sum(dim=0).to(torch.int32).contiguous()

        # per-level constants as the JAX code forms them in numpy float64,
        # then held in the working dtype (the kernel reads the same values)
        def vec(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=grid.rA.dtype, device=grid.rA.device)

        kl = np.arange(2, nr + 1)
        self.wmt, self.wst = vec(wmt), vec(wst)
        self.zg, self.hw = vec(zg), vec(hw)
        self.dz = vec(zg[1:nr + 1] - zg[2:nr + 2])          # [nr]
        worka = swfrac(torch.as_tensor(p["hbf"] * zg[kl],
                                       dtype=torch.float64))
        self.worka = vec(worka.numpy())                       # [nr-1]
        self.depth = vec(-zg[kl])                             # [nr-1]
        self.sigz = vec(-zg[1:nr + 1] + 0.5 * hw[1:nr + 1])   # [nr]
        self.rfac = vec(zg[1] - zg[1:nr + 1])                 # [nr]

    # ------------------------------------------------------------------
    def calc(self, u, v, theta, salt, totPhiHyd, sfU, sfV, sfT, sfS, Qsw,
             difT_prof, difS_prof, impl: str = None) -> dict:
        """KPP_CALC (kpp_calc.F:120-700): the full scheme, once per step.

        sfU/sfV: surfaceForcingU/V (tau/rhoConst, m^2/s^2); sfT/sfS:
        surfaceForcingT/S; difT_prof/difS_prof: background interface
        diffusivities [nr, ...] (index k = interface above cell k).
        Returns viscAz, diffKzT, diffKzS (same convention), ghat [nr, ...]
        (F level k at index k-1), hbl, frac and kbl (BLDEPTH's last
        boundary-layer level index, for checks)."""
        check_kpp(self)
        ins = (u, v, theta, salt, totPhiHyd, sfU, sfV, sfT, sfS, Qsw,
               difT_prof, difS_prof)
        if any(t.requires_grad for t in ins):
            raise ValueError("KPP.calc: an input requires grad; kernel K "
                             "has no backward kernel")
        global plain_calls
        args = (self, u, v, theta, salt, totPhiHyd, sfU, sfV, sfT, sfS, Qsw)
        if not kernels.use_kernel(theta, impl):
            plain_calls += 1
            pre = _kpp_pre_plain(*args)
            pre["dblocSm"] = (_kpp_smooth_plain(self, pre["dbraw"])
                              if self.smooth_dbloc else pre["dbloc"])
            return _kpp_col_plain(self, pre, difT_prof, difS_prof)
        pre = kpp_pre(*args)
        pre["dblocSm"] = (kpp_smooth(self, pre["dbraw"])
                          if self.smooth_dbloc else pre["dbloc"])
        return kpp_col(self, pre, difT_prof, difS_prof)


def check_kpp(kpp: KPP) -> None:
    """Raise NotImplementedError, naming each, for the KPP options and
    parameters off the ported path."""
    bad = sorted(o for o in REFUSED_OPTIONS if o in kpp.options)
    bad += [k for k in ("KPPuseDoubleDiff", "KPP_ghatUseTotalDiffus")
            if kpp.p[k]]
    if bad:
        raise NotImplementedError(f"KPP: not ported: {', '.join(bad)}")


# ----------------------------------------------------------------------
# plain twins
# ----------------------------------------------------------------------

def _smooth_horiz(fld, msk):
    """SMOOTH_HORIZ (kpp_routines.F:1216-1280): masked 9-point 121 filter,
    normalized by the local mask weight; points whose weight falls below
    0.25 keep their raw value. fld/msk: [nr, nyp, nxp]."""
    side_m = (sh(msk, di=-1) + sh(msk, di=1)
              + sh(msk, dj=-1) + sh(msk, dj=1))
    corn_m = (sh(msk, di=-1, dj=-1) + sh(msk, di=-1, dj=1)
              + sh(msk, di=1, dj=-1) + sh(msk, di=1, dj=1))
    w = 0.25 * msk + 0.125 * side_m + 0.0625 * corn_m
    fm = fld * msk
    num = (0.25 * fm
           + 0.125 * (sh(fm, di=-1) + sh(fm, di=1)
                      + sh(fm, dj=-1) + sh(fm, dj=1))
           + 0.0625 * (sh(fm, di=-1, dj=-1) + sh(fm, di=-1, dj=1)
                       + sh(fm, di=1, dj=-1) + sh(fm, di=1, dj=1)))
    return torch.where(w >= 0.25,
                       num / torch.where(w == 0.0, torch.ones_like(w), w),
                       fld)


def _at_bot(kpp: KPP, nr: int):
    kk0 = torch.arange(nr, device=kpp.kmtj.device)[:, None, None]
    return kk0 == (kpp.kmtj - 1)[None]


def _kpp_pre_plain(kpp: KPP, u, v, theta, salt, totPhiHyd, sfU, sfV, sfT,
                   sfS, Qsw) -> dict:
    """kpp_pre's twin: STATEKPP (kpp.py:197-225), the masking of dbloc and
    Ritop (:666-680), kpp_forcing_surf.F without the reference-velocity
    estimate (:228-252) and the shear of kpp_calc.F (:699-714). Level
    fields are cell-indexed [nr, ...]: dbraw holds dbloc_f0[1:nr+1], and
    dbloc, ritop, shsq and dvsq hold the F levels 1..nr of dbloc_f,
    Ritop_f, shsq_f and dvsq_f."""
    cfg, grid, p = kpp.cfg, kpp.grid, kpp.p
    nr = cfg.nr
    g = cfg.gravity
    # --- STATEKPP ---
    rho_c = eos.find_rho(cfg, grid, theta, salt, totPhiHyd, impl="plain")
    t_km1 = torch.cat([theta[:1], theta[:-1]])
    s_km1 = torch.cat([salt[:1], salt[:-1]])
    rho_km1 = eos.find_rho(cfg, grid, t_km1, s_km1, totPhiHyd, impl="plain")
    t_1 = theta[:1].expand_as(theta)
    s_1 = salt[:1].expand_as(salt)
    rho_1k = eos.find_rho(cfg, grid, t_1, s_1, totPhiHyd, impl="plain")
    alpha0 = eos.find_alpha(cfg, grid, theta, salt, totPhiHyd)[0]
    beta0 = eos.find_beta(cfg, grid, theta, salt, totPhiHyd)[0]
    rho1 = rho_c[0] + cfg.rhoConst
    db = g * (rho_c[1:] - rho_km1[1:]) / (rho_c[1:] + cfg.rhoConst)
    dbraw = torch.cat([db, torch.zeros_like(db[:1])])    # dbloc_f0[1:nr+1]
    dbsfc = g * (rho_c - rho_1k) / (rho_c + cfg.rhoConst)
    dbsfc[0] = 0.0

    # --- masks (kpp_calc.F), bottom-of-cell registration ---
    maskC = grid.maskC
    mask_kp1 = torch.cat([maskC[1:], maskC[-1:]])
    at_bot = _at_bot(kpp, nr)
    zero = torch.zeros_like(dbraw)
    dbloc = torch.where(at_bot, zero, dbraw * maskC * mask_kp1)
    ritop = kpp.rfac[:, None, None] * torch.where(
        at_bot, zero, dbsfc * maskC * maskC[:1])

    # --- kpp_forcing_surf.F ---
    drF1 = float(cfg.delR[0])
    a = sfU + sh(sfU, di=1)
    b = sfV + sh(sfV, dj=1)
    work3 = a * a + b * b
    epsLocSq = p["phepsi"] ** 2 * drF1 ** 2
    ustar = torch.where(work3 < epsLocSq,
                        work3.new_tensor(np.sqrt(0.5 * p["phepsi"] * drF1)),
                        torch.sqrt(torch.sqrt(work3) * 0.5))
    recip_Cp = 1.0 / cfg.HeatCapacity_Cp
    bo = -cfg.gravity * (alpha0 * sfT + beta0 * sfS) / rho1
    bosol = (cfg.gravity * alpha0 * Qsw * recip_Cp
             * (1.0 / cfg.rhoConst) / rho1)
    su, sv = sh(u, di=1), sh(v, dj=1)
    du, du1 = u[:1] - u, su[:1] - su
    dv, dv1 = v[:1] - v, sv[:1] - sv
    dvsq = 0.5 * (du * du + du1 * du1 + dv * dv + dv1 * dv1)

    # --- vertical shear at the interfaces (kpp_calc.F:450-486) ---
    du, du1 = u[:-1] - u[1:], su[:-1] - su[1:]
    dv, dv1 = v[:-1] - v[1:], sv[:-1] - sv[1:]
    shsq = 0.5 * (du * du + du1 * du1 + dv * dv + dv1 * dv1)
    if kpp.smooth_shsq:
        def sq(x):
            return x * x
        shsq = 0.5 * shsq + 0.125 * (
            sq(sh(du, dj=-1)) + sq(sh(du, di=1, dj=-1))
            + sq(sh(du, dj=1)) + sq(sh(du, di=1, dj=1))
            + sq(sh(dv, di=-1)) + sq(sh(dv, di=-1, dj=1))
            + sq(sh(dv, di=1)) + sq(sh(dv, di=1, dj=1)))
    shsq = torch.cat([shsq, torch.zeros_like(shsq[:1])])
    return dict(dbraw=dbraw, dbloc=dbloc, ritop=ritop, shsq=shsq,
                dvsq=dvsq, ustar=ustar, bo=bo, bosol=bosol)


def _kpp_smooth_plain(kpp: KPP, dbraw):
    """kpp_smooth's twin: KPP_SMOOTH_DBLOC (kpp.py:681-690), the masked
    9-point filter of the raw dbloc with the k+1 mask, which feeds only the
    shear-Ri part of RI_IWMIX (ghat_in_f[1:nr+1])."""
    maskC = kpp.grid.maskC
    nr = maskC.shape[0]
    mask_kp1 = torch.cat([maskC[1:], maskC[-1:]])
    sm = _smooth_horiz(dbraw, mask_kp1)
    sm[nr - 1] = 0.0                    # dbloc_f0[nr]
    return torch.where(_at_bot(kpp, nr), torch.zeros_like(sm),
                       sm * maskC * mask_kp1)


def _wscale(kpp: KPP, sigma, depth, ustar, bfsfc):
    """kpp_routines.F wscale (kpp.py:170-194): (wm, ws) by bilinear lookup,
    or the stable-limit formula above zmax."""
    p = kpp.p
    zehat = p["vonk"] * sigma * depth * bfsfc
    zdiff = zehat - p["zmin"]
    iz = torch.clamp(torch.floor(_div(zdiff, kpp.deltaz)), 0, _NNI).long()
    udiff = ustar - p["umin"]
    ju = torch.clamp(torch.floor(_div(udiff, kpp.deltau)), 0, _NNJ).long()
    zfrac = _div(zdiff, kpp.deltaz) - iz
    ufrac = _div(udiff, kpp.deltau) - ju
    fz = 1.0 - zfrac

    def bilin(tab):
        wa = fz * tab[iz, ju + 1] + zfrac * tab[iz + 1, ju + 1]
        wb = fz * tab[iz, ju] + zfrac * tab[iz + 1, ju]
        return (1.0 - ufrac) * wb + ufrac * wa

    u3 = ustar * ustar * ustar
    w_stable = p["vonk"] * ustar * u3 / (u3 + p["conc1"] * zehat)
    in_table = zehat <= p["zmax"]
    return (torch.where(in_table, bilin(kpp.wmt), w_stable),
            torch.where(in_table, bilin(kpp.wst), w_stable))


def _first(hit, offset: int, fallback):
    """Index (+ offset) of the first True along axis 0, else fallback:
    JAX's where(any(hit), argmax(hit) + offset, fallback)."""
    n = hit.shape[0]
    kk = torch.arange(n, device=hit.device)[:, None, None]
    first = torch.where(hit, kk, n).amin(dim=0)
    return torch.where(first < n, first + offset, fallback.long())


def _take(arr, k_idx):
    """arr[clip(k_idx), j, i] over axis 0 (jnp.take_along_axis)."""
    idx = k_idx.clamp(0, arr.shape[0] - 1)
    return torch.gather(arr, 0, idx[None])[0]


def _takev(vec, k_idx):
    """vec[clip(k_idx)] of a per-level vector."""
    return vec[k_idx.clamp(0, vec.shape[0] - 1)]


def _ri_iwmix(kpp: KPP, shsq_f, dbloc_f, dblocSm_f, difS_f, difT_f):
    """RI_IWMIX (kpp.py:335-371): interior viscosity and diffusivities,
    each [nr+2, ...] F-indexed."""
    cfg, p = kpp.cfg, kpp.p
    nr = cfg.nr
    kmtj = kpp.kmtj.long()
    dz = kpp.dz[:, None, None]
    Ri_raw = dblocSm_f[1:nr + 1] * dz / torch.clamp_min(shsq_f[1:nr + 1],
                                                         p["phepsi"])
    N2_raw = dbloc_f[1:nr + 1] / dz
    kk = torch.arange(1, nr + 1, device=kmtj.device)
    src = torch.minimum(kk[:, None, None],
                        torch.clamp_min(kmtj - 1, 1)[None])
    Ri = torch.gather(Ri_raw, 0, src - 1)
    N2 = torch.gather(N2_raw, 0, src - 1)
    dead = (kmtj <= 1)[None]
    Ri = torch.where(dead, torch.zeros_like(Ri), Ri)
    N2 = torch.where(dead, torch.zeros_like(N2), N2)

    Rig = torch.clamp_min(N2, p["BVSQcon"])
    ratio = torch.clamp_max(_div(p["BVSQcon"] - Rig, p["BVSQcon"]), 1.0)
    q = 1.0 - ratio * ratio
    fcon = q * q * q
    Rig = torch.clamp_min(Ri, 0.0)
    ratio = torch.clamp_max(_div(Rig, p["Riinfty"]), 1.0)
    q = 1.0 - ratio * ratio
    fRi = q * q * q

    kp1 = torch.clamp_max(kk + 1, nr)           # F level
    difS_kp1 = difS_f[kp1]
    difT_kp1 = difT_f[kp1]
    visc = cfg.viscAr + fcon * p["difmcon"] + fRi * p["difm0"]
    difs = difS_kp1 + fcon * p["difscon"] + fRi * p["difs0"]
    dift = difT_kp1 + fcon * p["diftcon"] + fRi * p["dift0"]
    zero = torch.zeros_like(visc[:1])

    def pad(a):
        return torch.cat([zero, a, zero])
    return pad(visc), pad(difs), pad(dift)


def _bf_at(kpp: KPP, h, bo, bosol):
    p = kpp.p
    wk = swfrac(-h)
    b = bo + bosol * (1.0 - wk)
    st = 0.5 + _fsign(0.5, b)
    b = _fsign(1.0, b) * torch.clamp_min(torch.abs(b), p["phepsi"])
    return b, st


def _bldepth(kpp: KPP, dvsq_f, dbloc_f, Ritop_f, ustar, bo, bosol, coriol):
    """BLDEPTH (kpp.py:374-446): hbl, bfsfc, stable, casea, kbl."""
    cfg, p = kpp.cfg, kpp.p
    nr = cfg.nr
    kmtj = kpp.kmtj.long()
    zg, hw = kpp.zg, kpp.hw
    bfsfc_k = bo[None] + bosol[None] * (1.0 - kpp.worka[:, None, None])
    stable_k = 0.5 + _fsign(0.5, bfsfc_k)
    sigma_k = stable_k + (1.0 - stable_k) * p["epsilon"]
    depth_k = kpp.depth[:, None, None]
    _, ws_k = _wscale(kpp, sigma_k, depth_k, ustar[None], bfsfc_k)
    dz = kpp.dz[:, None, None]
    bvsq = 0.5 * (dbloc_f[1:nr] / dz[:nr - 1] + dbloc_f[2:nr + 1] / dz[1:])
    vtsq = torch.where(bvsq == 0.0, torch.zeros_like(bvsq),
                       depth_k * ws_k * torch.sqrt(torch.abs(bvsq))
                       * kpp.Vtc)
    Rib = Ritop_f[2:nr + 1] / torch.clamp_min(dvsq_f[2:nr + 1] + vtsq,
                                              p["phepsi"])
    Rib_f = torch.cat([torch.zeros_like(Rib[:1]).expand(2, -1, -1), Rib])

    one = torch.ones_like(kmtj)
    kbl = _first(Rib > p["Ricr"], 2, kmtj)
    kbl = torch.where(kmtj < 1, one, kbl)
    hbl = -_takev(zg, torch.where(kmtj < 1, one, kmtj))
    interp_ok = (kbl > 1) & (kbl < kmtj)
    RibK = _take(Rib_f, kbl)
    RibKm = _take(Rib_f, kbl - 1)
    z1, z2 = _takev(zg, kbl - 1), _takev(zg, kbl)
    hbl_i = -z1 + (z1 - z2) * (p["Ricr"] - RibKm) / torch.where(
        RibK == RibKm, torch.ones_like(RibK), RibK - RibKm)
    hbl = torch.where(interp_ok, hbl_i, hbl)

    bfsfc, stable = _bf_at(kpp, hbl, bo, bosol)
    if p["LimitHblStable"]:
        hekman = p["cekman"] * ustar / torch.clamp_min(torch.abs(coriol),
                                                       p["phepsi"])
        hmonob = (_div(p["cmonob"] * (ustar * ustar * ustar), p["vonk"])
                  / torch.where(bfsfc == 0, torch.ones_like(bfsfc), bfsfc))
        hlimit = (stable * torch.minimum(hekman, hmonob)
                  + (stable - 1.0) * float(kpp.zgrid_f[nr]))
        hbl = torch.where(bfsfc > 0.0, torch.minimum(hbl, hlimit), hbl)
    hbl = torch.clamp_min(hbl, p["minKPPhbl"])

    kbl = _first(-zg[2:nr + 1][:, None, None] > hbl[None], 2, kmtj)
    kbl = torch.where(kmtj < 1, one, kbl)
    bfsfc, stable = _bf_at(kpp, hbl, bo, bosol)
    casea = 0.5 + _fsign(0.5, -_takev(zg, kbl) - 0.5 * _takev(hw, kbl)
                         - hbl)
    return hbl, bfsfc, stable, casea, kbl


def _shape(sig, hbl, wx, gat1, dat1):
    """hbl * w * sig * (1 + sig * G(sig)), the boundary-layer profile."""
    a1 = sig - 2.0
    a2 = 3.0 - 2.0 * sig
    a3 = sig - 1.0
    G = a1 + a2 * gat1 + a3 * dat1
    return hbl * wx * sig * (1.0 + sig * G)


def _blmix(kpp: KPP, ustar, bfsfc, hbl, stable, casea, diffus, kbl):
    """BLMIX (kpp.py:449-521): blmc [3 x nr], dkm1 [3], ghat_k [nr]."""
    p = kpp.p
    zg, hw = kpp.zg, kpp.hw
    sigma = stable * 1.0 + (1.0 - stable) * p["epsilon"]
    wm, ws = _wscale(kpp, sigma, hbl, ustar, bfsfc)
    wm = _fsign(1.0, wm) * torch.clamp_min(torch.abs(wm), p["phepsi"])
    ws = _fsign(1.0, ws) * torch.clamp_min(torch.abs(ws), p["phepsi"])

    caseaInt = (casea + p["phepsi"]).long()
    kn = caseaInt * (kbl - 1) + (1 - caseaInt) * kbl
    hw_kn = _takev(hw, kn)
    hw_knp1 = _takev(hw, kn + 1)
    delhat = 0.5 * hw_kn - _takev(zg, kn) - hbl
    R = 1.0 - delhat / hw_kn
    u2 = ustar * ustar
    f1 = stable * p["conc1"] * bfsfc / torch.clamp_min(u2 * u2, p["phepsi"])
    gat1, dat1 = [], []
    for d, wx in zip(diffus, (wm, ws, ws)):
        dvdzup = (_take(d, kn - 1) - _take(d, kn)) / hw_kn
        dvdzdn = (_take(d, kn) - _take(d, kn + 1)) / hw_knp1
        viscp = 0.5 * ((1.0 - R) * (dvdzup + torch.abs(dvdzup))
                       + R * (dvdzdn + torch.abs(dvdzdn)))
        visch = _take(d, kn) + viscp * delhat
        gat1.append(visch / hbl / wx)
        dat1.append(torch.clamp_max(-viscp / wx + f1 * visch, 0.0))

    # per-level shape functions (F levels 1..nr on axis 0)
    sig_k = kpp.sigz[:, None, None] / hbl[None]
    sigma_k = (stable[None] * sig_k
               + (1.0 - stable[None]) * torch.clamp_max(sig_k, p["epsilon"]))
    wm_k, ws_k = _wscale(kpp, sigma_k, hbl[None], ustar[None], bfsfc[None])
    blmc = [_shape(sig_k, hbl[None], wx, ga[None], da[None])
            for wx, ga, da in zip((wm_k, ws_k, ws_k), gat1, dat1)]
    ghat_k = (1.0 - stable[None]) * kpp.cg / torch.clamp_min(
        ws_k * hbl[None], p["phepsi"])

    # dkm1: at grid level kbl-1
    sig = -_takev(zg, kbl - 1) / hbl
    sigma1 = stable * sig + (1.0 - stable) * torch.clamp_max(
        sig, p["epsilon"])
    wm1, ws1 = _wscale(kpp, sigma1, hbl, ustar, bfsfc)
    dkm1 = [_shape(sig, hbl, wx, ga, da)
            for wx, ga, da in zip((wm1, ws1, ws1), gat1, dat1)]
    return blmc, dkm1, ghat_k


def _enhance(kpp: KPP, dkm1, hbl, kbl, diffus, casea, ghat_k, blmc):
    """ENHANCE (kpp.py:524-552): the blend at level kbl-1."""
    nr = kpp.cfg.nr
    zg = kpp.zg
    ki = kbl - 1                                    # F level
    valid = (ki >= 1) & (ki < nr)
    zki = _takev(zg, ki)
    delta = (hbl + zki) / torch.where(valid, zki - _takev(zg, ki + 1),
                                      torch.ones_like(hbl))
    kk = torch.arange(1, nr + 1, device=ki.device)[:, None, None]
    at_ki = (kk == ki[None]) & valid[None]
    out = []
    for md in range(3):
        d_ki = _take(diffus[md], ki)
        dkmp5 = casea * d_ki + (1.0 - casea) * _take(blmc[md], ki - 1)
        q = 1.0 - delta
        dstar = q * q * dkm1[md] + delta * delta * dkmp5
        newv = (1.0 - delta) * d_ki + delta * dstar
        out.append(torch.where(at_ki, newv[None], blmc[md]))
    ghat_k = torch.where(at_ki, (1.0 - casea)[None] * ghat_k, ghat_k)
    return out, ghat_k


def _kpp_col_plain(kpp: KPP, pre: dict, difT_prof, difS_prof) -> dict:
    """K-col's twin: KPPMIX (kpp.py:555-594) on the fields of K-pre, then
    the transfer to the state's fields (kpp_calc.F:565-590)."""
    cfg, grid = kpp.cfg, kpp.grid
    nr = cfg.nr
    kmtj = kpp.kmtj.long()
    z1 = torch.zeros_like(pre["dbloc"][:1])

    def f_levels(a, tail):   # [nr] cell-indexed -> F-indexed with pads
        return torch.cat([z1, a] + [z1] * tail)
    dbloc_f = f_levels(pre["dbloc"], 1)
    dblocSm_f = f_levels(pre["dblocSm"], 1)
    shsq_f = f_levels(pre["shsq"], 1)
    Ritop_f = f_levels(pre["ritop"], 0)
    dvsq_f = f_levels(pre["dvsq"], 0)
    difT_f = f_levels(difT_prof[:nr], 1)
    difS_f = f_levels(difS_prof[:nr], 1)
    ustar, bo, bosol = pre["ustar"], pre["bo"], pre["bosol"]

    visc_f, difs_f, dift_f = _ri_iwmix(kpp, shsq_f, dbloc_f, dblocSm_f,
                                       difS_f, difT_f)
    # zero at/below the sea floor (F k >= kmtj), k=1..nr+1
    kk = torch.arange(nr + 2, device=kmtj.device)[:, None, None]
    floor0 = (kk >= kmtj[None]) & (kk >= 1)
    diffus = [torch.where(floor0, torch.zeros_like(d), d)
              for d in (visc_f, difs_f, dift_f)]

    hbl, bfsfc, stable, casea, kbl = _bldepth(
        kpp, dvsq_f, dbloc_f, Ritop_f, ustar, bo, bosol, grid.fCori)
    blmc, dkm1, ghat_k = _blmix(kpp, ustar, bfsfc, hbl, stable, casea,
                                diffus, kbl)
    blmc, ghat_k = _enhance(kpp, dkm1, hbl, kbl, diffus, casea, ghat_k,
                            blmc)

    # combine: k < kbl -> boundary-layer values (with floors)
    kk1 = torch.arange(1, nr + 1, device=kmtj.device)[:, None, None]
    inbl = kk1 < kbl[None]
    floored = (torch.clamp_min(blmc[0], cfg.viscAr),
               torch.maximum(blmc[1], difS_f[nr]),
               torch.maximum(blmc[2], difT_f[nr]))
    new = [torch.where(inbl, b, d[1:nr + 1])
           for b, d in zip(floored, diffus)]
    ghat_c = torch.where(inbl, ghat_k, torch.zeros_like(ghat_k))

    # transfer to the state's fields (interface above cell k at index k)
    maskC = grid.maskC
    mm = maskC * torch.cat([maskC[:1], maskC[:-1]])
    viscAz, diffKzS, diffKzT = (torch.cat([z1, a[:nr - 1]]) * mm
                                for a in new)
    hbl = hbl * maskC[0]
    return dict(viscAz=viscAz, diffKzT=diffKzT, diffKzS=diffKzS,
                ghat=ghat_c * mm, hbl=hbl, frac=swfrac(-hbl),
                kbl=kbl.to(torch.int32))


# ----------------------------------------------------------------------
# kernel K
# ----------------------------------------------------------------------

def _pre_inputs(kpp: KPP, theta, totPhiHyd):
    """EOS settings of K-pre: (kind, use_phi, profile, aprof, tref, sref,
    phi) with the pressures formed exactly as find_rho and find_alpha
    form them."""
    cfg, grid = kpp.cfg, kpp.grid
    kind = _EOS_KIND[cfg.eosType.upper()]
    nr = cfg.nr
    like = dict(dtype=theta.dtype, device=theta.device)
    zeros = torch.zeros(nr, **like)
    if kind == 2:
        return (kind, 0, zeros, zeros, torch.tensor(cfg.tRef, **like),
                torch.tensor(cfg.sRef, **like), theta)
    profile, use_phi = eos._pressure_terms(cfg, grid, totPhiHyd)
    if use_phi:
        aprof = profile
    else:
        aprof = (eos.pressure_for_eos(cfg, grid, None)
                 * eos._pressure_scale(cfg)).reshape(nr)
    return (kind, int(use_phi), profile.contiguous(), aprof.contiguous(),
            zeros, zeros, totPhiHyd if use_phi else theta)


def kpp_pre(kpp: KPP, u, v, theta, salt, totPhiHyd, sfU, sfV, sfT, sfS,
            Qsw) -> dict:
    """Kernel `kpp_pre` on the card: the fields of `_kpp_pre_plain`."""
    cfg, grid, p = kpp.cfg, kpp.grid, kpp.p
    nr, nyp, nxp = theta.shape
    if nr < 2:
        raise ValueError("kernel K needs nr >= 2")
    kind, use_phi, profile, aprof, tref, sref, phi = _pre_inputs(
        kpp, theta, totPhiHyd)
    out = {n: torch.empty_like(theta)
           for n in ("dbraw", "dbloc", "ritop", "shsq", "dvsq")}
    out.update({n: torch.empty_like(sfU) for n in ("ustar", "bo", "bosol")})
    ins3 = dict(u=u, v=v, theta=theta, salt=salt, phi=phi, maskC=grid.maskC)
    ins2 = dict(sfU=sfU, sfV=sfV, sfT=sfT, sfS=sfS, Qsw=Qsw)
    ins1 = dict(profile=profile, aprof=aprof, tref=tref, sref=sref,
                rfac=kpp.rfac)
    kernels.check_tensors(theta.dtype, **ins3, **ins2, **ins1, **out)
    for name, t in {**ins3, **{n: out[n] for n in list(out)[:5]}}.items():
        kernels.check_shape(name, t, theta.shape)
    for name, t in {**ins2, **{n: out[n] for n in list(out)[5:]}}.items():
        kernels.check_shape(name, t, (nyp, nxp))
    for name, t in ins1.items():
        kernels.check_shape(name, t, (nr,))
    kernels.check_int32("kmtj", kpp.kmtj, (nyp, nxp))
    drF1 = float(cfg.delR[0])
    params = kernels.doubles([
        cfg.rhoConst, cfg.surf_pRef - cfg.eosRefP0, eos._pressure_scale(cfg),
        cfg.gravity, cfg.rhoNil, cfg.tAlpha, cfg.sBeta,
        cfg.rhoNil - cfg.rhoConst, -cfg.rhoNil * cfg.tAlpha,
        cfg.rhoNil * cfg.sBeta, p["phepsi"] ** 2 * drF1 ** 2,
        np.sqrt(0.5 * p["phepsi"] * drF1), 1.0 / cfg.HeatCapacity_Cp,
        1.0 / cfg.rhoConst])
    table = [*ins3.values(), *ins2.values(), *ins1.values(),
             *out.values(), kpp.kmtj]
    kernels.launch("kpp_pre", theta.dtype, kernels.pointer_table(table),
                   len(table), params, len(params), nr, nyp, nxp, kind,
                   use_phi, int(kpp.smooth_shsq))
    return out


def kpp_smooth(kpp: KPP, dbraw):
    """Kernel `kpp_smooth` on the card: `_kpp_smooth_plain`."""
    maskC = kpp.grid.maskC
    nr, nyp, nxp = dbraw.shape
    out = torch.empty_like(dbraw)
    kernels.check_tensors(dbraw.dtype, dbraw=dbraw, maskC=maskC, out=out)
    kernels.check_shape("maskC", maskC, dbraw.shape)
    kernels.check_int32("kmtj", kpp.kmtj, (nyp, nxp))
    kernels.launch("kpp_smooth", dbraw.dtype, dbraw.data_ptr(),
                   maskC.data_ptr(), kpp.kmtj.data_ptr(), out.data_ptr(), nr,
                   nyp, nxp)
    return out


def kpp_col(kpp: KPP, pre: dict, difT_prof, difS_prof) -> dict:
    """K-col on the card: the fields of `_kpp_col_plain`."""
    cfg, grid, p = kpp.cfg, kpp.grid, kpp.p
    nr, nyp, nxp = pre["dbloc"].shape
    dtype = pre["dbloc"].dtype
    difT, difS = difT_prof[:nr].contiguous(), difS_prof[:nr].contiguous()
    ins3 = dict(dbloc=pre["dbloc"], dblocSm=pre["dblocSm"],
                ritop=pre["ritop"], shsq=pre["shsq"], dvsq=pre["dvsq"],
                difT=difT, difS=difS, maskC=grid.maskC)
    ins2 = dict(ustar=pre["ustar"], bo=pre["bo"], bosol=pre["bosol"],
                fCori=grid.fCori)
    consts = dict(zg=kpp.zg, hw=kpp.hw, dz=kpp.dz, worka=kpp.worka,
                  sigz=kpp.sigz, wmt=kpp.wmt, wst=kpp.wst)
    out3 = {n: torch.empty_like(pre["dbloc"])
            for n in ("viscAz", "diffKzT", "diffKzS", "ghat")}
    out2 = {n: torch.empty_like(pre["ustar"]) for n in ("hbl", "frac")}
    kbl = torch.empty((nyp, nxp), dtype=torch.int32, device=difT.device)
    kernels.check_tensors(dtype, **ins3, **ins2, **consts, **out3, **out2)
    for name, t in {**ins3, **out3}.items():
        kernels.check_shape(name, t, (nr, nyp, nxp))
    for name, t in {**ins2, **out2}.items():
        kernels.check_shape(name, t, (nyp, nxp))
    for name, n in (("zg", nr + 2), ("hw", nr + 2), ("dz", nr),
                    ("worka", nr - 1), ("sigz", nr)):
        kernels.check_shape(name, consts[name], (n,))
    for name in ("wmt", "wst"):
        kernels.check_shape(name, consts[name], (_NNI + 2, _NNJ + 2))
    kernels.check_int32("kmtj", kpp.kmtj, (nyp, nxp))
    params = kernels.doubles([
        p["epsilon"], p["vonk"], p["conc1"], p["Ricr"], p["cekman"],
        p["cmonob"], p["phepsi"], p["minKPPhbl"], cfg.viscAr, p["difmcon"],
        p["difscon"], p["diftcon"], p["difm0"], p["difs0"], p["dift0"],
        p["BVSQcon"], p["Riinfty"], kpp.Vtc, kpp.cg, p["zmin"], p["zmax"],
        p["umin"], kpp.deltaz, kpp.deltau, kpp.zgrid_f[nr]])
    table = [*ins3.values(), *ins2.values(), *consts.values(),
             *out3.values(), *out2.values(), kpp.kmtj, kbl]
    kernels.launch("kpp_col", dtype, kernels.pointer_table(table),
                   len(table), params, len(params), nr, nyp, nxp,
                   int(p["LimitHblStable"]))
    return dict(**out3, **out2, kbl=kbl)


# ----------------------------------------------------------------------
# glue
# ----------------------------------------------------------------------

def visc_uv(cfg: Config, grid: Grid, kpp_fields, kappaRU, kappaRV):
    """KPP_CALC_VISC: blend KPP viscosity into KappaRU/RV at u/v points
    (kpp.py:745-752), on their first nr levels."""
    az = kpp_fields["viscAz"]
    newU = (kappaRU - cfg.viscAr
            + grid.maskW * 0.5 * (az + sh(az, di=-1)))
    newV = (kappaRV - cfg.viscAr
            + grid.maskS * 0.5 * (az + sh(az, dj=-1)))
    return torch.maximum(kappaRU, newU), torch.maximum(kappaRV, newV)


def ghat_flux(cfg: Config, grid: Grid, kz, ghat, sfc_forc, qsw_term,
              maskUp):
    """KPP_TRANSPORT_T/S + gad_calc_rhs.F:655-690 (kpp.py:755-766): the
    nonlocal flux added to fVer at the interfaces k >= 1.
    kz: KPPdiffKz* [nr, ...]; ghat: KPPghat (F level k at index k-1);
    sfc_forc: surfaceForcingT/S; qsw_term: -Qsw*recip_Cp*recip_rhoConst*
    (1-KPPfrac) for theta, 0 for salt."""
    df = -grid.rA * kz[1:] * ghat[:-1] * (sfc_forc + qsw_term)[None]
    df = df * maskUp[1:]
    return torch.cat([torch.zeros_like(df[:1]), df])
