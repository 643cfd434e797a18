"""GGL90 TKE vertical mixing (Gaspar, Gregoris & Lefevre 1990) with the
IDEMIX internal-wave energy model and the Langmuir parameterization, the
port of mitgcm_tpu/model/ggl90.py in z-coordinates.

Reference: pkg/ggl90 - ggl90_calc.F (the prognostic TKE equation with
implicit vertical diffusion of TKE and implicit dissipation),
ggl90_mixinglength.F (the mxlMaxFlag limiters and the Langmuir length),
ggl90_calc_visc.F / ggl90_calc_diff.F (the coupling into KappaRU/RV and the
tracer diffusivity), ggl90_idemix.F (IDEMIX, Olbers & Eden 2013, the CVMIX
variant), ggl90_add_stokesdrift.F, ggl90_readparms.F (the GGL90_PARM01/02
defaults) and model/src/solve_tridiagonal.F.

`GGL90.calc` runs kernel G9 (kernels/csrc/ggl90.cu) for CUDA tensors:
`ggl90_col`, one thread per (j, i) column in three passes over its levels,
for any nr up to `kernels.max_nr(G9_SHARED_VALUES, dtype)` (the
buoyancy frequency, the
mixing length and its two sweeps, Langmuir's length, the viscosity and
diffusivity, the shear, the Prandtl number, the explicit sources with
IDEMIX's and the Stokes drift's, the tridiagonal coefficients with their
surface and bottom Dirichlet folds, the Thomas solve and the TKE floor),
then `ggl90_visc`, one thread per cell (the viscosities at U and V
points). With useIDEMIX, `GGL90.idemix` runs first, as kernel H-IDEMIX
(kernels/csrc/idemix.cu): `idemix_prep` per column (the group velocities
c0 and v0 with v0's CFL cap, and the dissipation time scale tau_d),
`idemix_hdiff` per cell (the horizontal diffusion of E) and `idemix_col`
per column (the vertical solve with the surface and bottom energy fluxes,
and the TKE source tau_d E^2). For CPU tensors, or with impl="plain", each
launch's plain twin runs (`_ggl90_col_plain`, `_ggl90_visc_plain`,
`_idemix_prep_plain`, `_idemix_hdiff_plain`, `_idemix_col_plain`); they
replay the JAX code's operation order on whole [nr, nyp, nxp] arrays
(z-coordinates, so its coordFac factors of 1 are left out: x * 1.0 is x).

Left out, and refused by `check_ggl90`: p-coordinates, nr < 2, Langmuir
with mxlMaxFlag 0 (JAX raises there too) and IDEMIX_include_GM(_bottom),
which need GM-Redi (JAX accepts them and never reads them).
`stokes_drift` is the Coriolis-Stokes drift that flux-form momentum adds;
`step.check_supported` refuses Langmuir under flux form, and
vector-invariant momentum takes no Stokes term (as in JAX), so no path calls
it. No gradient: the adjoint refuses useGGL90.
"""

from __future__ import annotations

import numpy as np
import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model.gad_ho import _div, _rdiv
from mitgcm_tpu_torch.ops.stencil import shift as sh

GGL90EPS = 2.23e-16           # GGL90.h:69
SQRTTWO = float(np.sqrt(2.0))
TWO_OVER_PI = 2.0 / np.pi
# the largest nr kernel H-IDEMIX takes: idemix_col's Thomas sweep keeps
# per-level arrays of this length per thread
IDEMIX_MAX_NR = 64
# the values a level of each of a warp's columns that G9's ggl90_col keeps
# in dynamic shared memory (kernels/csrc/ggl90_col.cuh:ggl90_max_nr): 454
# levels at most in float64, 908 in float32
G9_SHARED_VALUES = 2
# calls of GGL90.calc that ran the plain twins (a run on the card reads it
# to show that its kernel path never did)
plain_calls = 0


class GGL90:
    """Fixed per-experiment GGL90 data: GGL90_PARM01 and GGL90_PARM02
    (IDEMIX; PARM03 is accepted as in the JAX package), klowC, the number
    of wet levels of each column, and IDEMIX's surface and bottom energy
    fluxes (zero until init_idemix_forc)."""

    def __init__(self, cfg: Config, grid: Grid, group: dict | None = None,
                 group3: dict | None = None, group2: dict | None = None):
        self.cfg, self.grid = cfg, grid
        p = dict(   # ggl90_readparms.F defaults
            GGL90ck=0.1, GGL90ceps=0.7, GGL90alpha=1.0, GGL90m2=3.75,
            GGL90TKEmin=1e-11, GGL90TKEsurfMin=1e-4, GGL90TKEbottom=None,
            GGL90viscMax=1e2, GGL90diffMax=1e2, GGL90diffTKEh=0.0,
            GGL90mixingLengthMin=1e-8, mxlMaxFlag=0, mxlSurfFlag=False,
            GGL90TKEFile="", GGL90_dirichlet=True, calcMeanVertShear=False,
            useLANGMUIR=False, LC_Gamma=10.0, LC_num=0.32, LC_lambda=40.0,
            useIDEMIX=False,
            # GGL90_PARM02: IDEMIX (ggl90_readparms.F:136-152)
            IDEMIX_tau_v=2.0 * 86400.0, IDEMIX_tau_h=10.0 * 86400.0,
            IDEMIX_gamma=1.57, IDEMIX_jstar=5.0, IDEMIX_mu0=1.0 / 3.0,
            IDEMIX_mixing_efficiency=0.1666, IDEMIX_diff_max=1.0,
            IDEMIX_diff_min=1e-9, IDEMIX_frac_F_b=1.0,
            IDEMIX_frac_F_s=0.2, IDEMIX_tidal_file="",
            IDEMIX_wind_file="", IDEMIX_include_GM=False,
            IDEMIX_include_GM_bottom=False,
        )
        lower = {k.lower(): k for k in p}
        for grp in (group or {}), (group3 or {}), (group2 or {}):
            for k, v in grp.items():
                kc = lower.get(k.lower())
                if kc is None:
                    if k.lower() in ("ggl90writestate", "ggl90dumpfreq",
                                     "ggl90tavefreq", "ggl90mixingmaps"):
                        continue
                    raise KeyError(f"GGL90 namelist: unknown parameter {k}")
                cur = p[kc]
                p[kc] = (type(cur)(v) if cur is not None else float(v))
        if p["GGL90TKEbottom"] is None:
            p["GGL90TKEbottom"] = p["GGL90TKEmin"]
        if p["GGL90diffTKEh"] > 0.0:
            raise NotImplementedError("GGL90 horizontal TKE diffusion")
        if p["mxlMaxFlag"] not in (0, 1, 2, 3):
            raise NotImplementedError(f"mxlMaxFlag={p['mxlMaxFlag']}")
        self.p = p
        self.klowC = grid.maskC.sum(dim=0).to(torch.int32).contiguous()
        self.idemix_F_b = torch.zeros_like(grid.rA)
        self.idemix_F_s = torch.zeros_like(grid.rA)

    def init_tke(self, dtype):
        """ggl90_init_varia.F: TKE = GGL90TKEmin on wet cells."""
        maskC = self.grid.maskC
        return (torch.full(maskC.shape, self.p["GGL90TKEmin"], dtype=dtype,
                           device=maskC.device) * maskC.to(dtype))

    def init_idemix_forc(self, load_2d):
        """IDEMIX's surface and bottom energy-flux maps
        (ggl90_init_varia.F:84-118): the files' fields clipped to [0, 1]
        W/m2 and scaled by frac / 1024, the bottom flux with a minus sign.
        load_2d(fname) returns the halo-filled [nyp, nxp] field."""
        p = self.p
        z = torch.zeros_like(self.grid.rA)
        fb = fs = z
        if p["IDEMIX_tidal_file"]:
            a = load_2d(p["IDEMIX_tidal_file"])
            fb = -torch.clamp(a, 0.0, 1.0) * (p["IDEMIX_frac_F_b"] / 1024.0)
        if p["IDEMIX_wind_file"]:
            a = load_2d(p["IDEMIX_wind_file"])
            fs = torch.clamp(a, 0.0, 1.0) * (p["IDEMIX_frac_F_s"] / 1024.0)
        self.idemix_F_b = fb.contiguous()
        self.idemix_F_s = fs.contiguous()
        return fb, fs

    def mixinglength(self, ML):
        """ggl90_mixinglength.F in z-coordinates: the limiters of
        mxlMaxFlag 0-3 on the buoyancy mixing length and, with Langmuir,
        the length LCML that the mixing uses (LC_Gamma times ML where the
        limiter set ML); returns (ML, LCML or None, rML)."""
        grid, p = self.grid, self.p
        nr = self.cfg.nr
        drF = grid.drF
        MLmin = p["GGL90mixingLengthMin"]
        flag = p["mxlMaxFlag"]
        mxDn = None
        if flag == 0:
            MaxLength = grid.Ro_surf - grid.R_low
            ML = torch.cat([ML[:1], torch.minimum(ML[1:], MaxLength[None])])
        elif flag == 1:
            rF = grid.rF[1:nr, None, None]
            MaxLength = torch.minimum(grid.Ro_surf[None] - rF,
                                      rF - grid.R_low[None])
            ML = torch.cat([ML[:1], torch.minimum(ML[1:], MaxLength)])
        else:
            # downward sweep from the surface: mxDn(1) = MLmin,
            # mxDn(k) = min(ML(k), mxDn(k-1) + drF(k-1))
            dn = [torch.full_like(ML[0], MLmin)]
            for k in range(1, nr):
                dn.append(torch.minimum(ML[k], dn[-1] + drF[k - 1]))
            mxDn = torch.stack(dn)
            # upward sweep from the bottom
            up = [torch.minimum(ML[nr - 1], MLmin + drF[nr - 1])]
            for k in range(nr - 2, 0, -1):
                up.append(torch.minimum(ML[k], up[-1] + drF[k]))
            ML = torch.stack([ML[0]] + up[::-1])
            ML = torch.cat([ML[:1], torch.minimum(ML[1:], mxDn[1:])])
        LCML = None
        if p["useLANGMUIR"]:
            if flag == 1:
                at_max = ML[1:] == grid.Ro_surf[None] - grid.rF[1:nr, None,
                                                                None]
            else:
                at_max = ML[1:] == mxDn[1:]
            LCML = torch.cat([torch.full_like(ML[:1], MLmin),
                              torch.where(at_max, p["LC_Gamma"] * ML[1:],
                                          ML[1:])])
            if flag in (1, 2):
                LCML = torch.cat([LCML[:1], torch.clamp(LCML[1:],
                                                        min=MLmin)])
        if flag == 3:
            MLtmp = torch.clamp(torch.sqrt(ML[1:] * mxDn[1:]), min=MLmin)
        else:
            MLtmp = torch.clamp(ML[1:], min=MLmin)
            ML = torch.cat([ML[:1], MLtmp])
        rML = torch.cat([torch.zeros_like(ML[:1]), torch.reciprocal(MLtmp)])
        return ML, LCML, rML

    def idemix(self, idemix_E, Nsq, impl: str = None):
        """GGL90_IDEMIX (ggl90_idemix.F, CVMIX version; ggl90.py:209-355):
        one step of the internal-wave energy E [nr, nyp, nxp] from the
        buoyancy frequency Nsq (0 at index 0). Returns (E', gTKE), gTKE =
        tau_d E'^2 the TKE source, 0 at index 0. Kernel H-IDEMIX for CUDA
        tensors, its twins for CPU tensors or impl="plain"."""
        for name, t in (("idemix_E", idemix_E), ("Nsq", Nsq)):
            if t.requires_grad:
                raise ValueError(f"GGL90.idemix: {name} requires grad; "
                                 "kernel H-IDEMIX has no backward kernel")
        if not kernels.use_kernel(idemix_E, impl):
            prep = _idemix_prep_plain(self, Nsq)
            E = _idemix_hdiff_plain(self, idemix_E, prep["v0"])
            return _idemix_col_plain(self, E, prep["c0"], prep["tau_d"])
        prep = idemix_prep(self, Nsq)
        E = idemix_hdiff(self, idemix_E, prep["v0"])
        return idemix_col(self, E, prep["c0"], prep["tau_d"])

    def calc(self, u, v, tke, sigmaR, sfU, sfV, idemix_E=None,
             impl: str = None):
        """GGL90_CALC (ggl90_calc.F): one TKE step on the start-of-step
        velocities, TKE and sigmaR [nr, nyp, nxp], with the surface stress
        sfU/sfV [nyp, nxp] (tau / rhoConst) and, with useIDEMIX, the
        internal-wave energy idemix_E. Returns (tke', viscArU, viscArV,
        diffKr, idemix_E') [nr, nyp, nxp]; the mixing coefficients are
        F-level k at index k-1 (the interface above cell k), zero at index
        0; idemix_E' is idemix_E without useIDEMIX."""
        check_ggl90(self)
        ins = (u, v, tke, sigmaR, sfU, sfV)
        if self.p["useIDEMIX"]:
            if idemix_E is None:
                raise ValueError("GGL90.calc: useIDEMIX needs idemix_E")
            ins += (idemix_E,)
        if any(t.requires_grad for t in ins):
            raise ValueError("GGL90.calc: an input requires grad; kernel G9 "
                             "has no backward kernel")
        global plain_calls
        col_fn, visc_fn = ggl90_col, ggl90_visc
        if not kernels.use_kernel(tke, impl):
            plain_calls += 1
            col_fn, visc_fn = _ggl90_col_plain, _ggl90_visc_plain
        gTKE, E_new = None, idemix_E
        if self.p["useIDEMIX"]:
            Nsq = nsq(self.cfg, sigmaR)
            E_new, gTKE = self.idemix(idemix_E, Nsq, impl=impl)
        col = col_fn(self, u, v, tke, sigmaR, sfU, sfV, gTKE)
        viscU, viscV = visc_fn(self, col["visctmp"])
        return col["tke"], viscU, viscV, col["diffKr"], E_new

    def stokes_drift(self, sfU, sfV):
        """ggl90_add_stokesdrift.F (ggl90.py:576-587): the Stokes drift
        profiles at U and V points [nr, nyp, nxp] that flux-form momentum's
        Coriolis term sees; depthFac uses rC(k)."""
        p, grid = self.p, self.grid
        recip_Lasq = (1.0 / p["LC_num"]) ** 2
        depthFac = recip_Lasq * torch.exp(
            4.0 * np.pi / p["LC_lambda"] * grid.rC)[:, None, None]
        uStar = torch.sign(sfU) * torch.sqrt(sfU.abs())
        vStar = torch.sign(sfV) * torch.sqrt(sfV.abs())
        return uStar[None] * depthFac, vStar[None] * depthFac


def check_ggl90(g9: GGL90) -> None:
    """Raise NotImplementedError, naming each, for the GGL90 options off
    the ported path."""
    p = g9.p
    bad = [k for k in ("IDEMIX_include_GM", "IDEMIX_include_GM_bottom")
           if p[k]]
    if p["useLANGMUIR"] and p["mxlMaxFlag"] == 0:
        bad.append("useLANGMUIR with mxlMaxFlag=0")
    if g9.cfg.usingPCoords or not g9.cfg.usingZCoords:
        bad.append("p-coordinates")
    if g9.cfg.nr < 2:
        bad.append("nr < 2")
    if bad:
        raise NotImplementedError(f"GGL90: not ported: {', '.join(bad)}")


def nsq(cfg: Config, sigmaR):
    """The squared buoyancy frequency GGL90 sees at the interfaces
    (ggl90.py:382-384), 0 at the surface."""
    out = cfg.gravity * cfg.gravitySign * (1.0 / cfg.rhoConst) * sigmaR
    out[0] = 0.0
    return out


def hfac_I(grid: Grid):
    """The open fraction at the interface above each cell and its
    reciprocal (0 where closed), (hFacI, recip_hFacI) (ggl90.py:375-379)."""
    hFacC = grid.hFacC
    hfac_km1 = torch.cat([hFacC[:1], hFacC[:-1]])
    hFacI = torch.clamp(hfac_km1, max=0.5) + torch.clamp(hFacC, max=0.5)
    recip = torch.where(hFacI != 0.0,
                        _rdiv(1.0, torch.where(hFacI == 0.0, 1.0, hFacI)),
                        0.0)
    return hFacI, recip


def solve_tridiagonal(a, b, c, y):
    """model/src/solve_tridiagonal.F (default branch): the Thomas algorithm
    along axis 0, over all columns at once; a zero pivot gives its row a
    reciprocal of 0 (ggl90.py:solve_tridiagonal)."""
    nr = y.shape[0]
    cp, yp = [], []
    cpm1 = ypm1 = torch.zeros_like(y[0])
    for k in range(nr):
        den = b[k] - a[k] * cpm1
        ok = den != 0.0
        rec = torch.where(ok, torch.reciprocal(torch.where(ok, den, 1.0)),
                          0.0)
        cpm1 = c[k] * rec
        ypm1 = (y[k] - a[k] * ypm1) * rec
        cp.append(cpm1)
        yp.append(ypm1)
    out = [yp[nr - 1]]
    for k in range(nr - 2, -1, -1):
        out.append(yp[k] - cp[k] * out[-1])
    return torch.stack(out[::-1])


# ----------------------------------------------------------------------
# plain twins
# ----------------------------------------------------------------------

def _ggl90_col_plain(g9: GGL90, u, v, tke, sigmaR, sfU, sfV,
                     gTKE=None) -> dict:
    """ggl90_col's twin: GGL90.calc (ggl90.py:358-571) in z-coordinates,
    with IDEMIX's TKE source gTKE when useIDEMIX and the Langmuir length
    and Stokes source when useLANGMUIR, up to the TKE floor and diffKr.
    Returns tke', diffKr, visctmp (the viscosity that ggl90_visc averages
    to U and V points) and prandtl: without IDEMIX the cells where the
    Richardson number takes the Prandtl number off 1 (Ri >= 0.2), with it
    the Prandtl number before its clip to [1, 10]."""
    cfg, grid, p = g9.cfg, g9.grid, g9.p
    nr = cfg.nr
    dt = cfg.deltaTTracer
    maskC = grid.maskC
    mask_km1 = torch.cat([maskC[:1], maskC[:-1]])
    mskLoc = maskC * mask_km1           # mask at the interface above cell k
    recip_drC = grid.recip_drC

    sqrttke = torch.sqrt(tke)
    Nsq = nsq(cfg, sigmaR)

    ML = SQRTTWO * sqrttke / torch.sqrt(torch.clamp(Nsq, min=GGL90EPS))
    ML = torch.cat([torch.full_like(ML[:1], p["GGL90mixingLengthMin"]),
                    ML[1:] * mskLoc[1:]])
    ML, LCML, rML = g9.mixinglength(ML)

    KappaM = p["GGL90ck"] * (ML if LCML is None else LCML) * sqrttke
    visctmp = torch.clamp(KappaM, min=cfg.diffKrS) * mskLoc
    KappaM = torch.clamp(KappaM, min=cfg.viscAr) * mskLoc

    # vertical shear of the cell-centre velocity at interfaces k >= 2
    rdrC1 = recip_drC[1:nr, None, None]
    su, sv = sh(u, di=1), sh(v, dj=1)
    if p["calcMeanVertShear"]:
        du, dup = u[:-1] - u[1:], su[:-1] - su[1:]
        dv, dvp = v[:-1] - v[1:], sv[:-1] - sv[1:]
        shear2 = ((du * du + dup * dup) + (dv * dv + dvp * dvp)) \
            * 0.5 * (rdrC1 * rdrC1)
    else:
        uc = 0.5 * (u + su)
        vc = 0.5 * (v + sv)
        du = (uc[:-1] - uc[1:]) * rdrC1
        dv = (vc[:-1] - vc[1:]) * rdrC1
        shear2 = du * du + dv * dv
    shear2 = torch.cat([torch.zeros_like(shear2[:1]), shear2])

    Ri = torch.clamp(Nsq, min=0.0) / (shear2 + GGL90EPS)
    if p["useIDEMIX"]:
        IDEMIX_Ri = (torch.clamp(KappaM * Nsq, min=0.0)
                     / (GGL90EPS + gTKE))
        prandtl = 6.6 * torch.minimum(Ri, IDEMIX_Ri)
        Pr = torch.clamp(torch.clamp(prandtl, max=10.0), min=1.0)
    else:
        prandtl = Ri >= 0.2
        Pr = torch.clamp(torch.where(prandtl, 5.0 * Ri, 1.0), max=10.0)
    Pr[0] = 1.0
    KappaH = KappaM / Pr
    KappaE = p["GGL90alpha"] * KappaM * mskLoc

    # explicit TKE sources at interfaces k >= 2 (explDissFac = 0)
    tke1 = tke[1:] + dt * (KappaM[1:] * shear2[1:] - KappaH[1:] * Nsq[1:])
    if p["useIDEMIX"]:
        tke1 = tke1 + dt * gTKE[1:]
    if p["useLANGMUIR"]:
        recip_Lasq = (1.0 / p["LC_num"]) ** 2
        recip_LD = 4.0 * np.pi / p["LC_lambda"]
        uStar = torch.sign(sfU) * torch.sqrt(sfU.abs())
        vStar = torch.sign(sfV) * torch.sqrt(sfV.abs())
        depthFac = recip_Lasq * torch.exp(
            recip_LD * grid.rF[1:nr])[:, None, None]
        dstU = recip_LD * uStar[None] * depthFac
        dstV = recip_LD * vStar[None] * depthFac
        if p["calcMeanVertShear"]:
            stokes = ((du * dstU + dup * sh(dstU, di=1))
                      + (dv * dstV + dvp * sh(dstV, dj=1))) * 0.5 * rdrC1
        else:
            stokes = 0.5 * (du * (dstU + sh(dstU, di=1))
                            + dv * (dstV + sh(dstV, dj=1)))
        tke1 = tke1 + dt * KappaM[1:] * stokes
    tke = torch.cat([tke[:1], tke1])

    # tridiagonal coefficients; row k = F level k+1, zero at k = 0; with
    # IDEMIX the rows carry the interface's 1 / hFacI (ggl90.py:474)
    kk = torch.arange(nr, device=tke.device)[:, None, None]
    rdrF = grid.recip_drF[:, None, None]
    rdrF_km1 = torch.cat([rdrF[:1], rdrF[:-1]])
    rhfac = grid.recip_hFacC
    rhfac_km1 = torch.cat([rhfac[:1], rhfac[:-1]])
    rdrC = recip_drC[:nr, None, None]
    full = KappaE.shape
    KE_km1 = KappaE.gather(0, torch.clamp(kk - 1, min=1).expand(full))
    a3d = (-dt * rdrF_km1 * rhfac_km1
           * 0.5 * (KappaE + KE_km1) * rdrC * maskC)
    # kp1 = max(1, min(klowC, k+1))
    klow = g9.klowC.to(torch.long)[None]
    kp1c = torch.clamp(torch.minimum(klow - 1, kk + 1), min=0)
    KE_kp1 = KappaE.gather(0, kp1c.expand(full))
    c3d = (-dt * rdrF * rhfac
           * 0.5 * (KappaE + KE_kp1) * rdrC * mask_km1)
    if p["useIDEMIX"]:
        rhI = hfac_I(grid)[1]
        a3d = a3d * rhI
        c3d = c3d * rhI
    a3d[0] = 0.0
    c3d[0] = 0.0
    kBot = torch.clamp(klow - 1, min=0)
    at_bot = kk == kBot
    if not p["GGL90_dirichlet"]:
        # Neumann bottom: no flux from the bottom
        c3d = torch.where(at_bot, 0.0, c3d)

    b3d = (1.0 - c3d - a3d
           + dt * p["GGL90ceps"] * sqrttke * rML * mskLoc)

    # surface friction velocity
    if p["calcMeanVertShear"]:
        su, sv = sh(sfU, di=1), sh(sfV, dj=1)
        usq = ((sfU * sfU + su * su) + (sfV * sfV + sv * sv)) * 0.5
    else:
        a = 0.5 * (sfU + sh(sfU, di=1))
        b = 0.5 * (sfV + sh(sfV, dj=1))
        usq = a * a + b * b
    usq = torch.sqrt(usq)
    tkeSurf = torch.clamp(p["GGL90m2"] * usq, min=p["GGL90TKEsurfMin"])

    # Dirichlet surface condition folded into row 1; Dirichlet bottom
    # condition folded into the bottom row klowC-1
    tke1 = maskC[0] * tkeSurf
    tke[0] = tke1
    tke[1] = tke[1] + -a3d[1] * tke1
    a3d[1] = 0.0
    if p["GGL90_dirichlet"]:
        cBot = c3d.gather(0, kBot)
        tke = torch.where(at_bot, tke - p["GGL90TKEbottom"] * cBot, tke)
        c3d = torch.where(at_bot, 0.0, c3d)

    tke = solve_tridiagonal(a3d, b3d, c3d, tke)
    tke = torch.cat([tke[:1], mskLoc[1:] * torch.clamp(
        tke[1:], min=p["GGL90TKEmin"])])

    # output diffusivity (k >= 2; level 1 stays zero)
    diffKr = torch.clamp(torch.clamp(visctmp / Pr, max=p["GGL90diffMax"]),
                         min=cfg.diffKrS)
    diffKr[0] = 0.0
    return dict(tke=tke, diffKr=diffKr, visctmp=visctmp, prandtl=prandtl)


def _ggl90_visc_plain(g9: GGL90, visctmp):
    """ggl90_visc's twin: the viscosities at U and V points
    (ggl90.py:560-573), zero at index 0."""
    cfg, grid, p = g9.cfg, g9.grid, g9.p
    maskW_i = grid.maskW * torch.cat([grid.maskW[:1], grid.maskW[:-1]])
    maskS_i = grid.maskS * torch.cat([grid.maskS[:1], grid.maskS[:-1]])
    viscU = torch.clamp(torch.clamp(
        maskW_i * 0.5 * (visctmp + sh(visctmp, di=-1)),
        max=p["GGL90viscMax"]), min=cfg.viscAr)
    viscV = torch.clamp(torch.clamp(
        maskS_i * 0.5 * (visctmp + sh(visctmp, dj=-1)),
        max=p["GGL90viscMax"]), min=cfg.viscAr)
    viscU[0] = 0.0
    viscV[0] = 0.0
    return viscU, viscV


def _idemix_prep_plain(g9: GGL90, Nsq, branches: bool = False) -> dict:
    """idemix_prep's twin (ggl90.py:224-257): per column the integrated
    buoyancy frequency bN0 (summed k = 1..nr-1 in order) and the mode-1
    speed cstar, then per level the vertical and horizontal group
    velocities c0 and v0 (v0 under its CFL cap when IDEMIX_tau_h > 0) and
    the dissipation time scale tau_d, all 0 at index 0. With branches, also
    the masks of the discrete choices: hofx1 < 0 (N < |f|), the CFL cap,
    and the floors of cstar and tau_d."""
    cfg, grid, p = g9.cfg, g9.grid, g9.p
    nr = cfg.nr
    dt = cfg.deltaTTracer
    pijstar = np.pi * p["IDEMIX_jstar"]
    hFacI = hfac_I(grid)[0]
    drC = grid.drC[:nr, None, None]

    NsqP = torch.clamp(Nsq, min=0.0)        # CVMIX: clip only
    NsqP[0] = 0.0
    sqrtN = torch.sqrt(NsqP)
    bN0 = torch.zeros_like(sqrtN[0])
    for k in range(1, nr):
        bN0 = bN0 + sqrtN[k] * drC[k] * hFacI[k]

    fxb = grid.fCori.abs()
    fxa = sqrtN / (1e-22 + fxb)
    cstar_raw = _div(bN0, pijstar)
    cstar = torch.clamp(cstar_raw, min=1e-2)

    # IDEMIX_gofx2 / IDEMIX_hofx1 (ggl90_idemix.F:549-566)
    xg = torch.clamp(fxa, min=3.0)
    cg = 1.0 - TWO_OVER_PI * torch.asin(_rdiv(1.0, xg))
    gofx2 = (_rdiv(TWO_OVER_PI, cg) * 0.9 * torch.pow(xg, -2.0 / 3.0)
             * (1.0 - torch.exp(_div(-xg, 4.3))))
    xh = torch.clamp(fxa, min=1.01)
    hofx1 = (_rdiv(TWO_OVER_PI,
                   1.0 - TWO_OVER_PI * torch.asin(_rdiv(1.0, xh)))
             * (fxa - 1.0) / (fxa + 1.0))
    cstar_g = cstar * p["IDEMIX_gamma"]
    c0 = torch.clamp(cstar_g * gofx2, min=0.0)
    v0 = torch.clamp(cstar_g * hofx1, min=0.0)
    fxc = torch.clamp(fxa, min=1.0)
    fxc = torch.log(fxc + torch.sqrt(fxc * fxc - 1.0))
    tau_raw = p["IDEMIX_mu0"] * fxb * fxc / (cstar * cstar)
    tau_d = torch.clamp(tau_raw, min=1e-4)
    for t in (c0, v0, tau_d):
        t[0] = 0.0
    v0_raw = v0
    if p["IDEMIX_tau_h"] > 0.0:
        fxa_cfl = float(np.sqrt(1.0 / (dt * p["IDEMIX_tau_h"])))
        v0 = torch.minimum(v0, 0.5 * torch.minimum(grid.dxF, grid.dyF)
                           * fxa_cfl)
    out = dict(c0=c0, v0=v0, tau_d=tau_d)
    if branches:
        out.update(hofx1_neg=(hofx1 < 0.0)[1:], cfl_cap=(v0 < v0_raw)[1:],
                   cstar_floor=cstar_raw < 1e-2,
                   tau_floor=(tau_raw < 1e-4)[1:])
    return out


def _idemix_hdiff_plain(g9: GGL90, E, v0):
    """idemix_hdiff's twin (ggl90.py:253-285): E + dt gE below the surface,
    gE the divergence of the down-gradient fluxes of v0 E through the west
    and south faces (zero-filled shifts as in the JAX code); E itself when
    IDEMIX_tau_h <= 0."""
    cfg, grid, p = g9.cfg, g9.grid, g9.p
    if not p["IDEMIX_tau_h"] > 0.0:
        return E
    nr = cfg.nr
    dt = cfg.deltaTTracer
    mkl = grid.maskC
    drC = grid.drC[:nr, None, None]
    rdrC = grid.recip_drC[:nr, None, None]
    rhI = hfac_I(grid)[1]
    hW_km1 = torch.cat([grid.hFacW[:1], grid.hFacW[:-1]])
    hS_km1 = torch.cat([grid.hFacS[:1], grid.hFacS[:-1]])
    v0m = v0 * mkl
    v0E = v0 * E
    tau_h = p["IDEMIX_tau_h"] * 0.5
    fxaW = tau_h * (sh(v0m, di=-1) + v0m)
    dfx = (-fxaW * grid.dyG * drC
           * (torch.clamp(hW_km1, max=0.5) + torch.clamp(grid.hFacW, max=0.5))
           * grid.recip_dxC * (v0E - sh(v0E, di=-1)) * grid.maskW)
    fxaS = tau_h * (sh(v0m, dj=-1) + v0m)
    dfy = (-fxaS * grid.dxG * drC
           * (torch.clamp(hS_km1, max=0.5) + torch.clamp(grid.hFacS, max=0.5))
           * grid.recip_dyC * (v0E - sh(v0E, dj=-1)) * grid.maskS)
    gE = (-rdrC * grid.recip_rA * rhI
          * ((sh(dfx, di=1) - dfx) + (sh(dfy, dj=1) - dfy))) * mkl
    return torch.cat([E[:1], E[1:] + dt * gE[1:]])


def _idemix_col_plain(g9: GGL90, E, c0, tau_d):
    """idemix_col's twin (ggl90.py:287-355): the implicit vertical step of
    E with the diffusivity delta from the neighbouring c0, the dissipation
    dt tau_d E, the wind flux into level 1 and the tidal flux into the
    bottom level klowC-1; returns (E', gTKE = tau_d E'^2)."""
    cfg, grid, p = g9.cfg, g9.grid, g9.p
    nr = cfg.nr
    dt = cfg.deltaTTracer
    maskC = grid.maskC
    mask_km1 = torch.cat([maskC[:1], maskC[:-1]])
    rdrC = grid.recip_drC[:nr, None, None]
    rdrF = grid.recip_drF[:, None, None]
    rhI = hfac_I(grid)[1]
    full = E.shape

    # vertical solve for E: delta_k = dt tau_v / drF_k (c_k + c_k+1) / 2
    c0_kp1 = torch.cat([c0[1:], c0[-1:]])
    delta = (dt * p["IDEMIX_tau_v"] * rdrF * grid.recip_hFacC * 0.5
             * (c0 + c0_kp1))
    delta[0] = 0.0
    delta[nr - 1] = 0.0
    kk = torch.arange(nr, device=E.device)[:, None, None]
    kB0 = torch.clamp(g9.klowC.to(torch.long) - 1, min=0)[None]
    delta = torch.where(kk == kB0, 0.0, delta)

    delta_km1 = torch.cat([delta[:1], delta[:-1]])
    a3d = -delta_km1 * rdrC * rhI * maskC
    c3d = -delta * rdrC * rhI * mask_km1
    a3d[0] = 0.0
    c3d[0] = 0.0
    c3d = torch.where(kk == kB0, 0.0, c3d)
    a3d[1] = 0.0

    b3d = 1.0 + dt * tau_d * E * maskC * mask_km1 - (a3d + c3d) * c0
    b3d[0] = 1.0
    # complete the off-diagonals with the neighbouring c0
    a3d = a3d * c0.gather(0, torch.clamp(kk - 1, min=1).expand(full))
    c3d = c3d * c0.gather(0, torch.clamp(kk + 1, max=nr - 1).expand(full))

    # the flux conditions: surface wind into level 1, bottom tides into
    # the bottom level
    E = E.clone()
    E[1] = E[1] + (dt * g9.idemix_F_s * grid.recip_drC[1] * rhI[1]
                   * maskC[1])
    rdrC_b = rdrC.expand(full).gather(0, kB0)[0]
    incr = (-dt * g9.idemix_F_b * rdrC_b * rhI.gather(0, kB0)[0]
            * maskC.gather(0, kB0)[0])
    E = torch.where(kk == kB0, E + incr[None], E)

    E = solve_tridiagonal(a3d, b3d, c3d, E)
    gTKE = tau_d * E * E
    gTKE[0] = 0.0
    return E, gTKE


# ----------------------------------------------------------------------
# kernels G9 and H-IDEMIX
# ----------------------------------------------------------------------

def _col_inputs(g9: GGL90, u, v, tke, sigmaR, sfU, sfV, gTKE=None) -> dict:
    """ggl90_col's inputs by name, in the order of its pointer table
    (kernels/csrc/ggl90_col.cuh:Ggl90Args); without IDEMIX the slots of
    hFacC and gTKE, which the kernel then does not read, hold maskC and
    tke."""
    grid, idemix = g9.grid, g9.p["useIDEMIX"]
    return dict(u=u, v=v, tke=tke, sigmaR=sigmaR, maskC=grid.maskC,
                recip_hFacC=grid.recip_hFacC,
                hFacC=grid.hFacC if idemix else grid.maskC,
                gTKE=gTKE if idemix else tke, sfU=sfU, sfV=sfV,
                Ro_surf=grid.Ro_surf, R_low=grid.R_low, drF=grid.drF,
                recip_drF=grid.recip_drF, recip_drC=grid.recip_drC,
                rF=grid.rF, klowC=g9.klowC)


def _col_params(g9: GGL90) -> tuple:
    """ggl90_col's scalars, in the order of kernels/csrc/ggl90_col.cuh:
    Ggl90Params, then its flags (mxlMaxFlag, calcMeanVertShear,
    GGL90_dirichlet, useIDEMIX, useLANGMUIR)."""
    cfg, p = g9.cfg, g9.p
    dt = cfg.deltaTTracer
    params = [
        dt, cfg.gravity * cfg.gravitySign * (1.0 / cfg.rhoConst),
        SQRTTWO, GGL90EPS, p["GGL90mixingLengthMin"], p["GGL90ck"],
        cfg.diffKrS, cfg.viscAr, p["GGL90alpha"], dt * p["GGL90ceps"],
        p["GGL90m2"], p["GGL90TKEsurfMin"], p["GGL90TKEbottom"],
        p["GGL90TKEmin"], p["GGL90diffMax"], p["LC_Gamma"],
        4.0 * np.pi / p["LC_lambda"], (1.0 / p["LC_num"]) ** 2]
    flags = [p["mxlMaxFlag"], int(p["calcMeanVertShear"]),
             int(p["GGL90_dirichlet"]), int(p["useIDEMIX"]),
             int(p["useLANGMUIR"])]
    return params, flags


def ggl90_col(g9: GGL90, u, v, tke, sigmaR, sfU, sfV, gTKE=None) -> dict:
    """Kernel `ggl90_col` on the card: tke', diffKr and visctmp of
    `_ggl90_col_plain`."""
    nr, nyp, nxp = tke.shape
    kernels.check_nr("G9", nr, 2, kernels.max_nr(G9_SHARED_VALUES,
                                                   tke.dtype))
    ins = _col_inputs(g9, u, v, tke, sigmaR, sfU, sfV, gTKE)
    ins3 = {n: ins[n] for n in ("u", "v", "tke", "sigmaR", "maskC",
                                "recip_hFacC")}
    if g9.p["useIDEMIX"]:
        ins3.update(hFacC=ins["hFacC"], gTKE=ins["gTKE"])
    ins2 = {n: ins[n] for n in ("sfU", "sfV", "Ro_surf", "R_low")}
    ins1 = {n: ins[n] for n in ("drF", "recip_drF", "recip_drC", "rF")}
    out = {n: torch.empty_like(tke) for n in ("tkeNew", "diffKr", "visctmp")}
    kernels.check_tensors(tke.dtype, **ins3, **ins2, **ins1, **out)
    for name, t in {**ins3, **out}.items():
        kernels.check_shape(name, t, (nr, nyp, nxp))
    for name, t in ins2.items():
        kernels.check_shape(name, t, (nyp, nxp))
    for name, n in (("drF", nr), ("recip_drF", nr), ("recip_drC", nr + 1),
                    ("rF", nr + 1)):
        kernels.check_shape(name, ins1[name], (n,))
    kernels.check_int32("klowC", g9.klowC, (nyp, nxp))
    params, flags = _col_params(g9)
    params = kernels.doubles(params)
    table = [*ins.values(), *out.values()]
    kernels.launch("ggl90_col", tke.dtype, kernels.pointer_table(table),
                   len(table), params, len(params), nr, nyp, nxp, *flags)
    return dict(tke=out["tkeNew"], diffKr=out["diffKr"],
                visctmp=out["visctmp"])


def ggl90_visc(g9: GGL90, visctmp):
    """Kernel `ggl90_visc` on the card: viscU and viscV of
    `_ggl90_visc_plain`."""
    cfg, grid, p = g9.cfg, g9.grid, g9.p
    nr, nyp, nxp = visctmp.shape
    viscU, viscV = torch.empty_like(visctmp), torch.empty_like(visctmp)
    kernels.check_tensors(visctmp.dtype, visctmp=visctmp, maskW=grid.maskW,
                          maskS=grid.maskS, viscU=viscU, viscV=viscV)
    for name, t in (("maskW", grid.maskW), ("maskS", grid.maskS)):
        kernels.check_shape(name, t, (nr, nyp, nxp))
    kernels.launch("ggl90_visc", visctmp.dtype, visctmp.data_ptr(),
                   grid.maskW.data_ptr(), grid.maskS.data_ptr(),
                   viscU.data_ptr(), viscV.data_ptr(), nr, nyp, nxp,
                   float(p["GGL90viscMax"]), float(cfg.viscAr))
    return viscU, viscV


def _idemix_launch(kernel: str, g9: GGL90, ins3: dict, ins2: dict,
                   ins1: dict, outs: dict, params, klowC=False) -> None:
    """Check the tensors of an H-IDEMIX launch ([nr, nyp, nxp], [nyp, nxp]
    and the per-level fields) and launch it on their pointer table (in the
    order ins3, ins2, ins1, klowC when the kernel reads it, outs)."""
    first = next(iter(ins3.values()))
    nr, nyp, nxp = first.shape
    kernels.check_nr("H-IDEMIX", nr, 2, IDEMIX_MAX_NR)
    kernels.check_tensors(first.dtype, **ins3, **ins2, **ins1, **outs)
    for name, t in {**ins3, **outs}.items():
        kernels.check_shape(name, t, (nr, nyp, nxp))
    for name, t in ins2.items():
        kernels.check_shape(name, t, (nyp, nxp))
    for name, t in ins1.items():
        kernels.check_shape(name, t, (nr + (name in ("drC", "recip_drC")),))
    if klowC:
        kernels.check_int32("klowC", g9.klowC, (nyp, nxp))
    table = [*ins3.values(), *ins2.values(), *ins1.values(),
             *([g9.klowC] if klowC else []), *outs.values()]
    params = kernels.doubles(params)
    kernels.launch(kernel, first.dtype, kernels.pointer_table(table),
                   len(table), params, len(params), nr, nyp, nxp)


def idemix_prep(g9: GGL90, Nsq) -> dict:
    """Kernel `idemix_prep` on the card: c0, v0 and tau_d of
    `_idemix_prep_plain`."""
    grid, p = g9.grid, g9.p
    tau_h = p["IDEMIX_tau_h"]
    cap = (float(np.sqrt(1.0 / (g9.cfg.deltaTTracer * tau_h)))
           if tau_h > 0.0 else -1.0)
    outs = {n: torch.empty_like(Nsq) for n in ("c0", "v0", "tau_d")}
    _idemix_launch("idemix_prep", g9,
                   dict(Nsq=Nsq, hFacC=grid.hFacC),
                   dict(fCori=grid.fCori, dxF=grid.dxF, dyF=grid.dyF),
                   dict(drC=grid.drC), outs,
                   [TWO_OVER_PI, np.pi * p["IDEMIX_jstar"],
                    p["IDEMIX_gamma"], p["IDEMIX_mu0"], cap, -2.0 / 3.0])
    return outs


def idemix_hdiff(g9: GGL90, E, v0):
    """Kernel `idemix_hdiff` on the card: `_idemix_hdiff_plain`."""
    grid, p = g9.grid, g9.p
    if not p["IDEMIX_tau_h"] > 0.0:
        return E
    out = torch.empty_like(E)
    _idemix_launch("idemix_hdiff", g9,
                   dict(E=E, v0=v0, maskC=grid.maskC, hFacC=grid.hFacC,
                        hFacW=grid.hFacW, hFacS=grid.hFacS,
                        maskW=grid.maskW, maskS=grid.maskS),
                   dict(dxG=grid.dxG, dyG=grid.dyG, recip_dxC=grid.recip_dxC,
                        recip_dyC=grid.recip_dyC, recip_rA=grid.recip_rA),
                   dict(drC=grid.drC, recip_drC=grid.recip_drC),
                   dict(E_out=out),
                   [g9.cfg.deltaTTracer, p["IDEMIX_tau_h"] * 0.5])
    return out


def idemix_col(g9: GGL90, E, c0, tau_d):
    """Kernel `idemix_col` on the card: (E', gTKE) of `_idemix_col_plain`."""
    grid, p = g9.grid, g9.p
    dt = g9.cfg.deltaTTracer
    outs = {n: torch.empty_like(E) for n in ("E_new", "gTKE")}
    _idemix_launch("idemix_col", g9,
                   dict(E=E, c0=c0, tau_d=tau_d, maskC=grid.maskC,
                        hFacC=grid.hFacC, recip_hFacC=grid.recip_hFacC),
                   dict(F_s=g9.idemix_F_s, F_b=g9.idemix_F_b),
                   dict(recip_drF=grid.recip_drF, recip_drC=grid.recip_drC),
                   outs, [dt, dt * p["IDEMIX_tau_v"]], klowC=True)
    return outs["E_new"], outs["gTKE"]
