"""GGL90 TKE vertical mixing (Gaspar, Gregoris & Lefevre 1990), the port of
mitgcm_tpu/model/ggl90.py in z-coordinates.

Reference: pkg/ggl90 - ggl90_calc.F (the prognostic TKE equation with
implicit vertical diffusion of TKE and implicit dissipation),
ggl90_mixinglength.F (the mxlMaxFlag limiters), ggl90_calc_visc.F /
ggl90_calc_diff.F (the coupling into KappaRU/RV and the tracer
diffusivity), ggl90_readparms.F (the GGL90_PARM01 defaults) and
model/src/solve_tridiagonal.F.

`GGL90.calc` runs kernel G9 (kernels/csrc/ggl90.cu) for CUDA tensors:
`ggl90_col`, one thread per (j, i) column (the buoyancy frequency, the
mixing length and its two sweeps, the viscosity and diffusivity, the
shear, the Prandtl number, the explicit sources, the tridiagonal
coefficients with their surface and bottom Dirichlet folds, the Thomas
solve and the TKE floor), then `ggl90_visc`, one thread per cell (the
viscosities at U and V points). For CPU tensors, or with impl="plain", it
runs the plain twins `_ggl90_col_plain` and `_ggl90_visc_plain`, which
replay the JAX code's operation order on whole [nr, nyp, nxp] arrays
(z-coordinates, so its coordFac factors of 1 are left out: x * 1.0 is x).

Left out, and refused by `check_ggl90`: IDEMIX, the Langmuir
parameterization and p-coordinates. No gradient: the adjoint refuses
useGGL90.
"""

from __future__ import annotations

import numpy as np
import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.ops.stencil import shift as sh

GGL90EPS = 2.23e-16           # GGL90.h:69
SQRTTWO = float(np.sqrt(2.0))
# the largest nr kernel G9 takes: its Thomas sweep keeps four per-level
# arrays of this length per thread
MAX_NR = 64
# calls of GGL90.calc that ran the plain twins (a run on the card reads it
# to show that its kernel path never did)
plain_calls = 0


class GGL90:
    """Fixed per-experiment GGL90 data: GGL90_PARM01 (and the PARM02/03
    settings, held so that the namelist checks match the JAX package's)
    and klowC, the number of wet levels of each column."""

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

    def init_tke(self, dtype):
        """ggl90_init_varia.F: TKE = GGL90TKEmin on wet cells."""
        maskC = self.grid.maskC
        return (torch.full(maskC.shape, self.p["GGL90TKEmin"], dtype=dtype,
                           device=maskC.device) * maskC.to(dtype))

    def mixinglength(self, ML):
        """ggl90_mixinglength.F in z-coordinates without Langmuir: the
        limiters of mxlMaxFlag 0-3 on the buoyancy mixing length; returns
        (ML, rML)."""
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
        if flag == 3:
            MLtmp = torch.clamp(torch.sqrt(ML[1:] * mxDn[1:]), min=MLmin)
        else:
            MLtmp = torch.clamp(ML[1:], min=MLmin)
            ML = torch.cat([ML[:1], MLtmp])
        rML = torch.cat([torch.zeros_like(ML[:1]), torch.reciprocal(MLtmp)])
        return ML, rML

    def calc(self, u, v, tke, sigmaR, sfU, sfV, impl: str = None):
        """GGL90_CALC (ggl90_calc.F): one TKE step on the start-of-step
        velocities, TKE and sigmaR [nr, nyp, nxp], with the surface stress
        sfU/sfV [nyp, nxp] (tau / rhoConst). Returns (tke', viscArU,
        viscArV, diffKr) [nr, nyp, nxp]; the mixing coefficients are F-level
        k at index k-1 (the interface above cell k), zero at index 0."""
        check_ggl90(self)
        ins = (u, v, tke, sigmaR, sfU, sfV)
        if any(t.requires_grad for t in ins):
            raise ValueError("GGL90.calc: an input requires grad; kernel G9 "
                             "has no backward kernel")
        global plain_calls
        col_fn, visc_fn = ggl90_col, ggl90_visc
        if not kernels.use_kernel(tke, impl):
            plain_calls += 1
            col_fn, visc_fn = _ggl90_col_plain, _ggl90_visc_plain
        col = col_fn(self, *ins)
        viscU, viscV = visc_fn(self, col["visctmp"])
        return col["tke"], viscU, viscV, col["diffKr"]


def check_ggl90(g9: GGL90) -> None:
    """Raise NotImplementedError, naming each, for the GGL90 options off
    the ported path."""
    bad = [k for k in ("useIDEMIX", "useLANGMUIR") if g9.p[k]]
    if g9.cfg.usingPCoords or not g9.cfg.usingZCoords:
        bad.append("p-coordinates")
    if g9.cfg.nr < 2:
        bad.append("nr < 2")
    if bad:
        raise NotImplementedError(f"GGL90: not ported: {', '.join(bad)}")


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

def _ggl90_col_plain(g9: GGL90, u, v, tke, sigmaR, sfU, sfV) -> dict:
    """ggl90_col's twin: GGL90.calc (ggl90.py:358-571) without IDEMIX and
    Langmuir, in z-coordinates, up to the TKE floor and diffKr. Returns
    tke', diffKr, visctmp (the viscosity that ggl90_visc averages to U and
    V points) and prandtl, the cells where the Richardson number takes the
    Prandtl number off 1 (Ri >= 0.2)."""
    cfg, grid, p = g9.cfg, g9.grid, g9.p
    nr = cfg.nr
    dt = cfg.deltaTTracer
    maskC = grid.maskC
    mask_km1 = torch.cat([maskC[:1], maskC[:-1]])
    mskLoc = maskC * mask_km1           # mask at the interface above cell k
    recip_drC = grid.recip_drC

    sqrttke = torch.sqrt(tke)
    Nsq = cfg.gravity * cfg.gravitySign * (1.0 / cfg.rhoConst) * sigmaR
    Nsq[0] = 0.0

    ML = SQRTTWO * sqrttke / torch.sqrt(torch.clamp(Nsq, min=GGL90EPS))
    ML = torch.cat([torch.full_like(ML[:1], p["GGL90mixingLengthMin"]),
                    ML[1:] * mskLoc[1:]])
    ML, rML = g9.mixinglength(ML)

    KappaM = p["GGL90ck"] * ML * sqrttke
    visctmp = torch.clamp(KappaM, min=cfg.diffKrS) * mskLoc
    KappaM = torch.clamp(KappaM, min=cfg.viscAr) * mskLoc

    # vertical shear of the cell-centre velocity at interfaces k >= 2
    rdrC1 = recip_drC[1:nr, None, None]
    if p["calcMeanVertShear"]:
        su, sv = sh(u, di=1), sh(v, dj=1)
        du, dup = u[:-1] - u[1:], su[:-1] - su[1:]
        dv, dvp = v[:-1] - v[1:], sv[:-1] - sv[1:]
        shear2 = ((du * du + dup * dup) + (dv * dv + dvp * dvp)) \
            * 0.5 * (rdrC1 * rdrC1)
    else:
        uc = 0.5 * (u + sh(u, di=1))
        vc = 0.5 * (v + sh(v, dj=1))
        du = (uc[:-1] - uc[1:]) * rdrC1
        dv = (vc[:-1] - vc[1:]) * rdrC1
        shear2 = du * du + dv * dv
    shear2 = torch.cat([torch.zeros_like(shear2[:1]), shear2])

    Ri = torch.clamp(Nsq, min=0.0) / (shear2 + GGL90EPS)
    prandtl = Ri >= 0.2
    Pr = torch.clamp(torch.where(prandtl, 5.0 * Ri, 1.0), max=10.0)
    Pr[0] = 1.0
    KappaH = KappaM / Pr
    KappaE = p["GGL90alpha"] * KappaM * mskLoc

    # explicit TKE sources at interfaces k >= 2 (explDissFac = 0)
    tke = torch.cat([tke[:1], tke[1:] + dt * (KappaM[1:] * shear2[1:]
                                              - KappaH[1:] * Nsq[1:])])

    # tridiagonal coefficients; row k = F level k+1, zero at k = 0
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
    a3d[0] = 0.0
    # kp1 = max(1, min(klowC, k+1))
    klow = g9.klowC.to(torch.long)[None]
    kp1c = torch.clamp(torch.minimum(klow - 1, kk + 1), min=0)
    KE_kp1 = KappaE.gather(0, kp1c.expand(full))
    c3d = (-dt * rdrF * rhfac
           * 0.5 * (KappaE + KE_kp1) * rdrC * mask_km1)
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


# ----------------------------------------------------------------------
# kernel G9
# ----------------------------------------------------------------------

def ggl90_col(g9: GGL90, u, v, tke, sigmaR, sfU, sfV) -> dict:
    """Kernel `ggl90_col` on the card: tke', diffKr and visctmp of
    `_ggl90_col_plain`."""
    cfg, grid, p = g9.cfg, g9.grid, g9.p
    nr, nyp, nxp = tke.shape
    if not 2 <= nr <= MAX_NR:
        raise ValueError(f"kernel G9 takes 2 <= nr <= {MAX_NR}, not {nr}")
    ins3 = dict(u=u, v=v, tke=tke, sigmaR=sigmaR, maskC=grid.maskC,
                recip_hFacC=grid.recip_hFacC)
    ins2 = dict(sfU=sfU, sfV=sfV, Ro_surf=grid.Ro_surf, R_low=grid.R_low)
    ins1 = dict(drF=grid.drF, recip_drF=grid.recip_drF,
                recip_drC=grid.recip_drC, rF=grid.rF)
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
    dt = cfg.deltaTTracer
    params = kernels.doubles([
        dt, cfg.gravity * cfg.gravitySign * (1.0 / cfg.rhoConst),
        SQRTTWO, GGL90EPS, p["GGL90mixingLengthMin"], p["GGL90ck"],
        cfg.diffKrS, cfg.viscAr, p["GGL90alpha"], dt * p["GGL90ceps"],
        p["GGL90m2"], p["GGL90TKEsurfMin"], p["GGL90TKEbottom"],
        p["GGL90TKEmin"], p["GGL90diffMax"]])
    table = [*ins3.values(), *ins2.values(), *ins1.values(), g9.klowC,
             *out.values()]
    kernels.launch("ggl90_col", tke.dtype, kernels.pointer_table(table),
                   len(table), params, len(params), nr, nyp, nxp,
                   p["mxlMaxFlag"], int(p["calcMeanVertShear"]),
                   int(p["GGL90_dirichlet"]))
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
