"""Richardson-number vertical mixing: PP81 (Pacanowski & Philander 1981)
and MY82 (Mellor & Yamada level 2.0), the port of
mitgcm_tpu/model/vertmix.py.

Reference: pkg/pp81 - pp81_calc.F, pp81_ri_number.F, pp81_readparms.F
(RiLimit derived from PPnu0, viscAr, PPviscMax, PPnRi and PPalpha); pkg/my82
- my82_calc.F, my82_ri_number.F, my82_init_varia.F (the stability
functions' constants from A1, A2, B1, B2 and C1).

Both schemes are diagnostic (no state from step to step): a gradient
Richardson number at each interface from the shear of the cell-centred
velocity and the density of the water above displaced to the interface's
level, mapped to interface viscosities and diffusivities viscAr and diffKr
[nr, nyp, nxp] (index k the interface above cell k; level 0 the background
times maskC). The step blends viscAr into KappaRU/RV at u and v points
(pp81/my82_calc_visc.F: model/step.py:kappa_uv, kernel J-uv's max-blend,
the one KPP's viscosity takes) and adds diffKr - diffKrS to both tracers' diffusivity
(*_calc_diff.F; kernel J-ts's diffKr addend, the one GGL90's takes).

`PP81.calc` and `MY82.calc` run kernel U (`vertmix_calc`,
kernels/csrc/vertmix.cu) on CUDA tensors: one thread walks a column, both
densities from eos.cuh's equation of state at the interface's level (with
totPhiHyd under selectP_inEOS_Zc = 2); MY82 keeps each level's TKE and
stability functions in shared memory for its second pass, after the
column's TKE-weighted depth. On CPU tensors, or with impl="plain", the
twin `_vertmix_plain` runs, in the JAX code's operation order (PP81's
denom ** PPnRi multiplied out as JAX's integer_pow does, MY82's column
sums level by level from the top). No gradient: the adjoint refuses both.
"""

from __future__ import annotations

import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model.gad_ho import _div, _ipow, _rdiv
from mitgcm_tpu_torch.ops import eos
from mitgcm_tpu_torch.ops.stencil import shift as sh

EPS = 1.0e-10      # pp81/my82_ri_number.F epsilon

# MY82.h closure constants
A1, A2, B1, B2, C1 = 0.92, 0.74, 16.6, 10.1, 0.08

# the values a level of each of a warp's columns that kernel U keeps in
# dynamic shared memory under MY82: 302 levels at most in float64, 605 in
# float32
U_SHARED_VALUES = 3

# calls of the twin (a run on the card reads it to show that its kernel
# path never did)
plain_calls = 0


def _read_group(defaults: dict, group: dict, name: str,
                skipped: tuple) -> dict:
    """The namelist group over the defaults, keys matched without case;
    the *writestate / dump keys, which steer output only, skipped; an
    unknown key raises."""
    p = dict(defaults)
    lower = {k.lower(): k for k in p}
    for k, v in (group or {}).items():
        kc = lower.get(k.lower())
        if kc is None:
            if k.lower() in skipped:
                continue
            raise KeyError(f"{name}: unknown parameter {k}")
        p[kc] = type(p[kc])(v) if p[kc] is not None else float(v)
    return p


class PP81:
    """PP81_PARM01 (pp81_readparms.F defaults) and its RiLimit."""

    scheme = "PP81"

    def __init__(self, cfg: Config, grid: Grid, group: dict | None = None):
        self.cfg, self.grid = cfg, grid
        p = _read_group(dict(PPnRi=2, PPviscMin=0.0, PPdiffMin=0.0,
                             PPviscMax=1.0, PPnu0=1e-2, PPalpha=5.0,
                             RiLimit=None), group, "PP81_PARM01",
                        ("ppwritestate", "ppdumpfreq", "ppmixingmaps"))
        if p["RiLimit"] is None:
            # pp81_readparms.F:84-90
            p["RiLimit"] = (((p["PPnu0"] + cfg.viscAr) / p["PPviscMax"])
                            ** (1.0 / p["PPnRi"]) - 1.0) / p["PPalpha"]
        if p["PPnRi"] < 1:
            raise NotImplementedError(f"PP81: PPnRi = {p['PPnRi']} < 1 is "
                                      f"not ported")
        self.p = p

    def calc(self, u, v, theta, salt, totPhiHyd, impl: str = None):
        """PP81_CALC: (viscAr, diffKr) interface fields."""
        return vertmix_calc(self, u, v, theta, salt, totPhiHyd, impl)


class MY82:
    """MY_PARM01 (my82_readparms.F defaults) and the my82_init_varia.F
    constants of the level-2.0 closure."""

    scheme = "MY82"

    def __init__(self, cfg: Config, grid: Grid, group: dict | None = None):
        self.cfg, self.grid = cfg, grid
        p = _read_group(dict(MYviscMax=1.0, MYdiffMax=1.0, MYhblScale=0.1,
                             RiMax=0.1950), group, "MY_PARM01",
                        ("mywritestate", "mydumpfreq", "mymixingmaps"))
        # my82_init_varia.F:31-39 (M. Satoh p.314)
        gam1 = 1.0 / 3.0 - 2.0 * A1 / B1
        gam2 = (B2 + 6.0 * A1) / B1
        p["alpha1"] = 3.0 * A2 * gam1
        p["alpha2"] = 3.0 * A2 * (gam1 + gam2)
        p["beta1"] = A1 * B1 * (gam1 - C1)
        p["beta2"] = A1 * (B1 * (gam1 - C1) + 6.0 * A1 + 3.0 * A2)
        p["beta3"] = A2 * B1 * gam1
        p["beta4"] = A2 * (B1 * (gam1 + gam2) - 3.0 * A1)
        self.p = p

    def calc(self, u, v, theta, salt, totPhiHyd, impl: str = None):
        """MY82_CALC: (viscAr, diffKr) from the level-2.0 closure."""
        return vertmix_calc(self, u, v, theta, salt, totPhiHyd, impl)


def ri_number(cfg: Config, grid: Grid, u, v, theta, salt, totPhiHyd):
    """pp81/my82_ri_number.F: (buoyFreq, vertShear) [nr, ...], index k the
    interface above cell k, row 0 zero. buoyFreq = g * mass2rUnit * (rho of
    the k-1 water - rho of the k water) / drC(k), both densities at level
    k's pressure."""
    nr = cfg.nr
    rhoK = eos._find_rho_plain(cfg, grid, theta, salt, totPhiHyd, None)
    t_km1 = torch.cat([theta[:1], theta[:-1]], dim=0)
    s_km1 = torch.cat([salt[:1], salt[:-1]], dim=0)
    rhoKm1 = eos._find_rho_plain(cfg, grid, t_km1, s_km1, totPhiHyd, None)
    rdrC = grid.recip_drC[1:nr, None, None]
    uc = 0.5 * (u + sh(u, di=1))
    vc = 0.5 * (v + sh(v, dj=1))
    du = (uc[:-1] - uc[1:]) * rdrC
    dv = (vc[:-1] - vc[1:]) * rdrC
    shear = du * du + dv * dv
    buoy = (cfg.gravity * cfg.mass2rUnit * (rhoKm1[1:] - rhoK[1:]) * rdrC)
    z1 = torch.zeros_like(shear[:1])
    return torch.cat([z1, buoy], dim=0), torch.cat([z1, shear], dim=0)


def _richardson(buoy, shear):
    """-buoyFreq / max(vertShear, EPS) at the interfaces below the top."""
    return -buoy[1:] / torch.clamp_min(shear[1:], EPS)


def _pp81_plain(vm: PP81, buoy, shear):
    cfg, grid, p = vm.cfg, vm.grid, vm.p
    Ri = _richardson(buoy, shear)
    low = Ri < p["RiLimit"]
    denom = torch.where(low, torch.full_like(Ri, 1.0 + p["PPalpha"]
                                             * p["RiLimit"]),
                        1.0 + p["PPalpha"] * Ri)
    viscTmp = torch.where(low, torch.full_like(Ri, p["PPviscMax"]),
                          _rdiv(p["PPnu0"], _ipow(denom, p["PPnRi"])))
    visc = torch.clamp_min(viscTmp, cfg.viscAr)
    diff = torch.clamp_min(visc / denom, cfg.diffKrS)
    # ALLOW_PP81_LOWERBOUND is undef by default; masking only
    visc = visc * grid.maskC[1:]
    diff = diff * grid.maskC[1:]
    visc = torch.cat([torch.full_like(visc[:1], cfg.viscAr)
                      * grid.maskC[:1], visc], dim=0)
    diff = torch.cat([torch.full_like(diff[:1], cfg.diffKrS)
                      * grid.maskC[:1], diff], dim=0)
    return visc, diff


def _my82_plain(vm: MY82, buoy, shear):
    cfg, grid, p = vm.cfg, vm.grid, vm.p
    nr = cfg.nr
    Ri = _richardson(buoy, shear)
    RiTmp = torch.clamp_max(Ri, p["RiMax"])
    btmp = p["beta1"] + p["beta4"] * RiTmp
    RiFlux = _div(btmp - torch.sqrt(
        btmp * btmp - 4.0 * p["beta2"] * p["beta3"] * RiTmp),
        2.0 * p["beta2"])
    SHt = (p["alpha1"] - p["alpha2"] * RiFlux) / (1.0 - RiFlux)
    SMt = (SHt * (p["beta1"] - p["beta2"] * RiFlux)
           / (p["beta3"] - p["beta4"] * RiFlux))
    tke2 = torch.clamp_min(B1 * (SHt * buoy[1:] + SMt * shear[1:]), 0.0)
    tke = torch.sqrt(tke2)
    z1 = torch.zeros_like(tke[:1])
    SH = torch.cat([z1, SHt], dim=0)
    SM = torch.cat([z1, SMt], dim=0)
    tke = torch.cat([z1, tke], dim=0)
    # the tke-weighted depth -> the boundary-layer scale (my82_calc.F:
    # 126-148), summed level by level from the top, as kernel U sums
    GM = torch.zeros_like(tke[0])
    GH = torch.zeros_like(tke[0])
    for k in range(1, nr):
        GM = GM + tke[k] * grid.rF[k]
        GH = GH + tke[k]
    none = GH == 0.0
    hbl = torch.where(none, torch.zeros_like(GH),
                      -GM / torch.where(none, torch.ones_like(GH), GH)
                      * p["MYhblScale"])
    tkel = hbl[None] * tke
    visc = hbl[None] * tkel * SM
    diff = hbl[None] * tkel * SH
    visc = torch.clamp_min(visc, cfg.viscAr)
    diff = torch.clamp_min(diff, cfg.diffKrS)
    visc = torch.clamp_max(visc, p["MYviscMax"]) * grid.maskC
    diff = torch.clamp_max(diff, p["MYdiffMax"]) * grid.maskC
    return visc, diff


def _vertmix_plain(vm, u, v, theta, salt, totPhiHyd):
    """Kernel U's twin: (viscAr, diffKr) of PP81_CALC or MY82_CALC."""
    buoy, shear = ri_number(vm.cfg, vm.grid, u, v, theta, salt, totPhiHyd)
    if vm.scheme == "PP81":
        return _pp81_plain(vm, buoy, shear)
    return _my82_plain(vm, buoy, shear)


def u_params(vm) -> list:
    """Kernel U's scalars (vertmix.cuh:VertmixParams): the EOS's seven
    (ops/eos.py:kernel_inputs), gravity * mass2rUnit, viscAr, diffKrS, then
    PP81's PPalpha, RiLimit, 1 + PPalpha * RiLimit, PPviscMax, PPnu0 or
    MY82's RiMax, alpha1, alpha2, beta1..beta4, 4 beta2 beta3, 2 beta2,
    MYhblScale, MYviscMax, MYdiffMax, B1 (unused slots 0)."""
    cfg, p = vm.cfg, vm.p
    head = [cfg.gravity * cfg.mass2rUnit, cfg.viscAr, cfg.diffKrS]
    if vm.scheme == "PP81":
        tail = [p["PPalpha"], p["RiLimit"],
                1.0 + p["PPalpha"] * p["RiLimit"], p["PPviscMax"],
                p["PPnu0"]]
    else:
        tail = [p["RiMax"], p["alpha1"], p["alpha2"], p["beta1"],
                p["beta2"], p["beta3"], p["beta4"],
                4.0 * p["beta2"] * p["beta3"], 2.0 * p["beta2"],
                p["MYhblScale"], p["MYviscMax"], p["MYdiffMax"], B1]
    return head + tail + [0.0] * (13 - len(tail))


def _vertmix_kernel(vm, u, v, theta, salt, totPhiHyd):
    """Kernel U's vertmix_calc on the card (vertmix.cu)."""
    cfg, grid = vm.cfg, vm.grid
    nr, nyp, nxp = theta.shape
    # MY82 keeps U_SHARED_VALUES a level in shared memory; PP81 keeps none
    most = (kernels.max_nr(U_SHARED_VALUES, theta.dtype)
            if vm.scheme == "MY82" else nr)
    kernels.check_nr("U", nr, 1, most)
    ins, (kind, use_phi, eos_params) = eos.kernel_inputs(cfg, grid, theta,
                                                         totPhiHyd)
    visc, diff = torch.empty_like(theta), torch.empty_like(theta)
    fields = dict(u=u, v=v, theta=theta, salt=salt, maskC=grid.maskC,
                  viscAr=visc, diffKr=diff)
    if use_phi:
        fields["totPhiHyd"] = totPhiHyd
    kernels.check_fields(theta.dtype, theta.shape, **fields)
    kernels.check_fields(theta.dtype, (nr,), **{
        n: t for n, t in ins.items() if n != "totPhiHyd"})
    kernels.check_fields(theta.dtype, (nr + 1,), recip_drC=grid.recip_drC,
                         rF=grid.rF)
    table = [u, v, theta, salt, ins.get("totPhiHyd"), ins.get("profile"),
             ins.get("tRef"), ins.get("sRef"), grid.maskC, grid.recip_drC,
             grid.rF, visc, diff]
    params = kernels.doubles(eos_params + u_params(vm))
    kernels.launch("vertmix_calc", theta.dtype, kernels.pointer_table(table),
                   len(table), params, len(params), nr, nyp, nxp,
                   int(vm.scheme == "MY82"), kind, int(use_phi),
                   vm.p.get("PPnRi", 0))
    return visc, diff


def vertmix_calc(vm, u, v, theta, salt, totPhiHyd, impl: str = None):
    """(viscAr, diffKr) [nr, nyp, nxp] of PP81 or MY82 (vm) on the
    start-of-step state: kernel U on CUDA tensors, its twin on CPU tensors
    or with impl="plain"."""
    phi = totPhiHyd if vm.cfg.selectP_inEOS_Zc == 2 else None
    kernels.refuse_grad(f"{vm.scheme}.calc", u=u, v=v, theta=theta,
                        salt=salt, totPhiHyd=phi)
    if not kernels.use_kernel(theta, impl):
        global plain_calls
        plain_calls += 1
        return _vertmix_plain(vm, u, v, theta, salt, totPhiHyd)
    return _vertmix_kernel(vm, u, v, theta, salt, phi)

