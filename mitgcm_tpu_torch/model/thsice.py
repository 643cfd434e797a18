"""pkg/thsice: Winton (1999) three-layer thermodynamic sea ice
(mitgcm_tpu/model/thsice.py), the plain twin of kernel TH.

`ThSIce.step` is one step of thsice_main.F (get_ocean -> map_exf ->
step_temp -> step_fwd -> extend) written op by op as the JAX package
writes it: the albedo, the surface fluxes over ice from the atmospheric
state (thsice_get_exf.F's fixed-coefficient branch), the implicit surface
and ice temperature solve with its per-cell Terrmax freeze-out, growth and
melt at the top and bottom, sublimation, flooding, the Winton layer
reshaping, lateral melt and new ice from freezing sea water, and the
ocean's Qnet, Qsw, EmPmR and saltFlux. `ThSIce.advance` dispatches:
kernel TH (kernels/csrc/thsice.cu, model/thsice_kernels.py) on CUDA
tensors, this twin on CPU tensors or with impl="plain". The order of
every expression is the JAX code's, the Python-number constants that it
folds are folded here in double, a division by a Python number is one
IEEE division (`_div`, `_rdiv`), and the power law's fifth power is
multiplied out as integer_pow does, so that the kernel can match the twin
bit for bit.

Parsed and never read, as in the JAX package: stressReduction (no stress
reduction under ice is applied), thSIce_diffK, hMxL_default,
sMxL_default and vMxL_default. sIceLoad, which the JAX step computes and
drops (mitgcm_tpu/model/step.py:779), is not formed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model.gad import _div
from mitgcm_tpu_torch.model.seaice import _max, _min, _rdiv, _where
from mitgcm_tpu_torch.ops.stencil import cyclic_fill_halo, shift as sh

# the nine State fields of the thsice state (THSICE_VARS.h), in the order
# of kernel TH's table
TH_FIELDS = ("thIceMask", "thIceH", "thSnowH", "thSnowAge", "thTsrf",
             "thTice1", "thTice2", "thQice1", "thQice2")
# the ocean's surface fluxes that a step overwrites
TH_FLUXES = ("Qnet", "Qsw", "EmPmR", "saltFlux")
# the atmospheric state a step reads (pkg/exf's fields)
TH_FORCING = ("atemp", "aqh", "lwdown", "swdown", "precip", "runoff",
              "wspeed")

# pkg/exf's bulk constants that thsice_get_exf.F reads (EXF_CONSTANTS.h,
# exf_readparms.F; mitgcm_tpu/model/exf.py:55-67), and the defaults that
# the JAX code's BULK.get supplies: snow and ice emissivity, the ice's
# Dalton and Stanton numbers
EXF_BULK = dict(cen2kel=273.150, atmrho=1.200, atmcp=1005.0,
                flamb=2500000.0, flami=334000.0, cvapor_fac_ice=11637800.0,
                cvapor_exp_ice=5897.8, gamma_blk=0.010, ht=2.0,
                stefanBoltzmann=5.670e-8, snow_emissivity=0.95,
                ice_emissivity=0.95, exf_iceCe=1.63e-3, exf_iceCh=1.63e-3)

# the branches of solve4temp, calc_thickn and extend that `ThSIce.step`
# reports by name (its `branches` dict also holds each cell's count of
# live surface iterations, "iterations")
BRANCHES = ("melting surface", "top melt of snow", "top melt of layer 1",
            "top melt of layer 2", "bottom growth",
            "bottom melt through snow", "hIce < hIceMin", "snow sublimation",
            "ice sublimation", "hIce < hIceMin after sublimation",
            "flooding", "hiMax cap", "reshaping, layer 1 thicker",
            "reshaping, layer 2 thicker", "lateral melt, fraction kept",
            "lateral melt, fraction lost", "new ice", "thickening")

# calls of the twin (`ThSIce.step`) through `advance`, for the card's runs
# to show that the main path never ran it
plain_calls = 0


@dataclass
class ThsiceParams:
    # THSICE_CONST (thsice_readparms.F:105-144 defaults)
    rhos: float = 330.0
    rhoi: float = 900.0
    rhosw: float = 0.0            # = rhoConst
    rhofw: float = 0.0            # = rhoConstFresh
    cpIce: float = 2106.0
    cpWater: float = 0.0          # = HeatCapacity_Cp
    kIce: float = 2.03
    kSnow: float = 0.30
    bMeltCoef: float = 0.006
    Lfresh: float = 3.34e5
    qsnow: float = 3.34e5
    albColdSnow: float = 0.85
    albWarmSnow: float = 0.70
    tempSnowAlb: float = -10.0
    albOldSnow: float = 0.55
    albIceMax: float = 0.65
    albIceMin: float = 0.20
    hAlbIce: float = 0.50
    hAlbSnow: float = 0.30
    hNewSnowAge: float = 2.0e-3
    snowAgTime: float = 50.0 * 86400.0
    i0swFrac: float = 0.3
    ksolar: float = 1.5
    dhSnowLin: float = 0.0
    saltIce: float = 4.0
    S_winton: float = 1.0
    mu_Tf: float = 0.054
    Tf0kel: float = 273.15
    Terrmax: float = 0.5
    nitMaxTsf: int = 20
    hIceMin: float = 1.0e-2
    hiMax: float = 10.0
    hsMax: float = 10.0
    iceMaskMax: float = 1.0
    iceMaskMin: float = 0.1
    fracEnMelt: float = 0.4
    fracEnFreez: float = 0.0
    hThinIce: float = 0.2
    hThickIce: float = 2.5
    hNewIceMax: float = -1.0      # UNSET -> hiMax
    floodFac: float = 0.0         # derived: (rhosw-rhoi)/rhos
    # THSICE_PARM01
    startIceModel: int = 0
    thSIce_skipThermo: bool = False
    thSIce_calc_albNIR: bool = False
    thSIce_deltaT: float = 0.0    # = dTtracerLev(1)
    thSIce_dtTemp: float = 0.0    # = thSIce_deltaT
    ocean_deltaT: float = 0.0     # = dTtracerLev(1)
    hMxL_default: float = 50.0
    sMxL_default: float = 35.0
    vMxL_default: float = 5.0e-2
    thSIce_diffK: float = 0.0
    thSIceAdvScheme: int = 0
    stressReduction: float = 1.0  # 0 when useSEAICE
    thSIceBalanceAtmFW: int = 0
    fract_file: str = ""
    thick_file: str = ""
    snowh_file: str = ""
    snowa_file: str = ""
    enthp_file: str = ""
    tsurf_file: str = ""

    @property
    def Tmlt1(self) -> float:
        """Melting temperature of the upper (brine-pocket) layer,
        -mu_Tf*S_winton (THSICE_PARAMS.h)."""
        return -self.mu_Tf * self.S_winton


_CONST_KEYS = {
    "rhos": "rhos", "rhoi": "rhoi", "cpice": "cpIce", "kice": "kIce",
    "ksnow": "kSnow", "bmeltcoef": "bMeltCoef", "lfresh": "Lfresh",
    "qsnow": "qsnow", "albcoldsnow": "albColdSnow",
    "albwarmsnow": "albWarmSnow", "tempsnowalb": "tempSnowAlb",
    "alboldsnow": "albOldSnow", "albicemax": "albIceMax",
    "albicemin": "albIceMin", "halbice": "hAlbIce", "halbsnow": "hAlbSnow",
    "hnewsnowage": "hNewSnowAge", "snowagtime": "snowAgTime",
    "i0swfrac": "i0swFrac", "ksolar": "ksolar", "dhsnowlin": "dhSnowLin",
    "saltice": "saltIce", "s_winton": "S_winton", "mu_tf": "mu_Tf",
    "tf0kel": "Tf0kel", "terrmax": "Terrmax", "nitmaxtsf": "nitMaxTsf",
    "hicemin": "hIceMin", "himax": "hiMax", "hsmax": "hsMax",
    "icemaskmax": "iceMaskMax", "icemaskmin": "iceMaskMin",
    "fracenmelt": "fracEnMelt", "fracenfreez": "fracEnFreez",
    "hthinice": "hThinIce", "hthickice": "hThickIce",
    "hnewicemax": "hNewIceMax",
}
_PARM01_KEYS = {
    "starticemodel": "startIceModel",
    "thsice_skipthermo": "thSIce_skipThermo",
    "thsice_calc_albnir": "thSIce_calc_albNIR",
    "thsice_deltat": "thSIce_deltaT", "thsice_dttemp": "thSIce_dtTemp",
    "ocean_deltat": "ocean_deltaT", "hmxl_default": "hMxL_default",
    "smxl_default": "sMxL_default", "vmxl_default": "vMxL_default",
    "thsice_diffk": "thSIce_diffK", "thsiceadvscheme": "thSIceAdvScheme",
    "stressreduction": "stressReduction",
    "thsicebalanceatmfw": "thSIceBalanceAtmFW",
    "thsicefract_initfile": "fract_file",
    "thsicethick_initfile": "thick_file",
    "thsicesnowh_initfile": "snowh_file",
    "thsicesnowa_initfile": "snowa_file",
    "thsiceenthp_initfile": "enthp_file",
    "thsicetsurf_initfile": "tsurf_file",
    # IO cadence (no effect on the solution)
    "thsice_monfreq": None, "thsice_diagfreq": None,
    "thsice_tavefreq": None,
}


def params_from_namelists(cfg: Config, const: dict, parm01: dict
                          ) -> ThsiceParams:
    """ThsiceParams from data.ice's THSICE_CONST and THSICE_PARM01 (keys
    in any case), with the derived defaults of thsice_readparms.F; an
    unknown key raises."""
    p = ThsiceParams()
    p.rhosw = cfg.rhoConst
    p.rhofw = cfg.rhoConstFresh or cfg.rhoConst
    p.cpWater = cfg.HeatCapacity_Cp
    p.Tf0kel = cfg.celsius2K
    for src, table in ((const, _CONST_KEYS), (parm01, _PARM01_KEYS)):
        for k, v in src.items():
            kk = k.lower()
            if kk not in table:
                raise NotImplementedError(f"data.ice key {k}")
            tgt = table[kk]
            if tgt is None:
                continue
            cur = getattr(p, tgt)
            if isinstance(cur, bool):
                setattr(p, tgt, bool(v))
            elif isinstance(cur, int):
                setattr(p, tgt, int(v))
            elif isinstance(cur, str):
                setattr(p, tgt, str(v).strip())
            else:
                setattr(p, tgt, float(v))
    if p.thSIce_deltaT == 0.0:
        p.thSIce_deltaT = cfg.deltaTTracer or cfg.deltaTClock
    if p.thSIce_dtTemp == 0.0:
        p.thSIce_dtTemp = p.thSIce_deltaT
    if p.ocean_deltaT == 0.0:
        p.ocean_deltaT = cfg.deltaTTracer or cfg.deltaTClock
    if p.hNewIceMax < 0.0:
        p.hNewIceMax = p.hiMax
    if cfg.useSEAICE and "stressreduction" not in {k.lower()
                                                  for k in parm01}:
        p.stressReduction = 0.0
    p.floodFac = (p.rhosw - p.rhoi) / p.rhos
    return p


def _clip(a, lo: float, hi: float):
    """jnp.clip: the minimum of the maximum."""
    return _min(_max(a, lo), hi)


def _safe(x, cond):
    """The JAX code's safe(x, cond): x where cond, else 1."""
    return _where(cond, x, 1.0)


def _pow5(x):
    """x**5 as jax's integer_pow multiplies it out: x * (x^2 * x^2)."""
    x2 = x * x
    return x * (x2 * x2)


class ThSIce:
    """thsice's parameters on a grid, with the JAX package's four
    refusals; `advance` is one step on the kernel or the twin."""

    def __init__(self, cfg: Config, grid: Grid, p: ThsiceParams):
        self.cfg, self.grid, self.p = cfg, grid, p
        self.maskC0 = grid.maskC[cfg.ksurf0]
        # the surface level's thickness, read once (kernel TH's parameter)
        self.drF_ks = float(grid.drF[cfg.ksurf0])
        if p.thSIceAdvScheme > 0:
            raise NotImplementedError(
                "thSIceAdvScheme > 0 (thsice_advection) not implemented "
                "yet; decks with thSIceAdvScheme=0 run")
        if p.thSIce_calc_albNIR:
            raise NotImplementedError("thSIce_calc_albNIR")
        if p.thSIce_skipThermo:
            raise NotImplementedError("thSIce_skipThermo")
        if p.thSIceBalanceAtmFW:
            raise NotImplementedError("thSIceBalanceAtmFW")

    def fill(self, a):
        return cyclic_fill_halo(a, self.cfg.oly, self.cfg.olx, impl="plain")

    # ------------------------------------------------------------------
    def init_state(self, iceMask=None, iceH=None, snowH=None, snowA=None,
                   tsrf=None, enthalpy=None) -> Dict[str, torch.Tensor]:
        """thsice_ini_vars.F's fresh start (mitgcm_tpu/model/thsice.py:
        init_state) from padded [nyp, nxp] fields in place of its files
        (None: zero), enthalpy a pair (Qice1, Qice2) or None for that of
        new ice at Tf = -1.70 degC where the ice fraction is not 0; a dict
        of the nine th* State fields."""
        p = self.p
        z2 = torch.zeros_like(self.maskC0)
        iceMask = (z2 if iceMask is None else iceMask) * self.maskC0
        iceH = z2 if iceH is None else iceH * self.maskC0
        snowH = z2 if snowH is None else snowH * self.maskC0
        snowA = z2 if snowA is None else snowA
        tsrf = z2 if tsrf is None else tsrf
        if enthalpy is not None:
            q1, q2 = enthalpy
        else:
            # enthalpy of new ice at Tf=-1.70C (thsice_ini_vars.F:149-162)
            Tf = -1.70
            q1v = (-p.cpWater * p.Tmlt1 + p.cpIce * (p.Tmlt1 - Tf)
                   + p.Lfresh * (1.0 - p.Tmlt1 / Tf))
            q2v = -p.cpIce * Tf + p.Lfresh
            q1 = _where(iceMask != 0.0, q1v, 0.0, like=z2)
            q2 = _where(iceMask != 0.0, q2v, 0.0, like=z2)
        return {"thIceMask": self.fill(iceMask), "thIceH": self.fill(iceH),
                "thSnowH": self.fill(snowH), "thSnowAge": self.fill(snowA),
                "thTsrf": self.fill(tsrf), "thTice1": z2,
                "thTice2": z2.clone(), "thQice1": self.fill(q1),
                "thQice2": self.fill(q2)}

    # ------------------------------------------------------------------
    def albedo(self, iceMask, hIce, hSnow, tSrf, snowAge):
        """thsice_albedo.F"""
        p = self.p
        albice = p.albIceMax + (p.albIceMin - p.albIceMax) \
            * torch.exp(_div(-hIce, p.hAlbIce))
        if p.tempSnowAlb < 0.0:
            albNewSnow = p.albColdSnow + (
                p.albWarmSnow - p.albColdSnow) * _clip(
                    1.0 - _div(tSrf, p.tempSnowAlb), 0.0, 1.0)
        else:
            albNewSnow = torch.full_like(tSrf, p.albColdSnow)
        albsno = p.albOldSnow + (albNewSnow - p.albOldSnow) \
            * torch.exp(_div(-0.2 * snowAge, 86400.0))
        albedo = albsno + (albice - albsno) * torch.exp(
            _div(-hSnow, p.hAlbSnow))
        return _where(iceMask > 0.0, albedo, 0.0)

    # ------------------------------------------------------------------
    def get_exf(self, forc, icFlag, hSnow, tsfCel):
        """thsice_get_exf.F's fixed-coefficient branch
        (useStabilityFct_overIce=F): the surface fluxes over ice at the
        surface temperature tsfCel [degC]: (flxExcSw, dFlxdT, evapLoc,
        dEvdT); fluxes +down, evaporation +up [kg/m2/s]."""
        B = EXF_BULK
        lath = B["flamb"] + B["flami"]
        emiss = _where(hSnow > 0.3, B["snow_emissivity"],
                       B["ice_emissivity"], like=hSnow)
        Tsf = tsfCel + B["cen2kel"]
        Ts2 = Tsf * Tsf
        ssq = _div(B["cvapor_fac_ice"]
                   * torch.exp(_rdiv(-B["cvapor_exp_ice"], Tsf)), B["atmrho"])
        deltap = forc.atemp + B["gamma_blk"] * B["ht"] - Tsf
        delq = forc.aqh - ssq
        dEvdT0 = ssq * B["cvapor_exp_ice"] / Ts2
        flwup = emiss * B["stefanBoltzmann"] * Ts2 * Ts2
        dflwupdT = 4.0 * emiss * B["stefanBoltzmann"] * Ts2 * Tsf
        flwNet_dwn = emiss * forc.lwdown - flwup
        wsm = forc.wspeed
        tau = B["atmrho"] * B["exf_iceCe"] * wsm
        evapLoc = -tau * delq
        hl = -lath * evapLoc
        hs = B["atmcp"] * B["atmrho"] * B["exf_iceCh"] * wsm * deltap
        dEvdT = tau * dEvdT0
        dflhdT = -lath * dEvdT
        dfshdT = -B["atmcp"] * B["atmrho"] * B["exf_iceCh"] * wsm
        flxExcSw = flwNet_dwn + hs + hl
        dFlxdT = -dflwupdT + dfshdT + dflhdT
        # atemp==0 guard (thsice_get_exf.F:488-500)
        ok = (icFlag > 0.0) & (forc.atemp > 0.0)
        z = torch.zeros_like(flxExcSw)
        return (torch.where(ok, flxExcSw, z), torch.where(ok, dFlxdT, z),
                torch.where(ok, evapLoc, z), torch.where(ok, dEvdT, z))

    # ------------------------------------------------------------------
    def solve4temp(self, forc, icMask, hIce, hSnow, tFrz, flxSW, tSrf,
                   qIc1, qIc2, stats=None):
        """thsice_solve4temp.F: the implicit surface and ice temperature
        solve, nitMaxTsf iterations under masks with the per-cell Terrmax
        freeze-out (a cell stops once |dTsrf| < Terrmax). Returns
        (flxSW_out [below-ice shortwave to the ocean], tSrf, qIc1, qIc2,
        tIc1, tIc2, sHeat, flxCnB, flxAtm, evpAtm). `stats`, a dict, gets
        each cell's count of live iterations ("iterations") and whether a
        live iteration took the melting-surface branch ("melt")."""
        p = self.p
        dt = p.thSIce_dtTemp
        on = icMask > 0.0
        # use a safe hIce where ice-free to avoid 1/0 (results masked)
        hIceS = _where(on, _max(hIce, p.hIceMin), 1.0)
        recip_dhSnowLin = 1.0 / p.dhSnowLin if p.dhSnowLin > 0.0 else 0.0
        # fractional snow cover (solve4temp:258-266)
        icm = _where(on, icMask, 1.0)
        frsnow_r = hSnow * recip_dhSnowLin / icm
        frsnow = _where(hSnow > icm * p.dhSnowLin, 1.0,
                        torch.sqrt(_max(frsnow_r, 0.0)))
        # SW partition
        fswpen = flxSW * (1.0 - frsnow) * p.i0swFrac
        fswocn = fswpen * torch.exp(-p.ksolar * hIceS)
        fswint = fswpen - fswocn
        fswdn = flxSW - fswpen
        flxAtm = _where(on, flxSW, 0.0)
        flxSW_out = torch.where(on, fswocn, flxSW)
        sHeat = fswdn
        # conductivities
        k12 = _rdiv(4.0 * p.kIce * p.kSnow,
                    p.kSnow * hIceS + 4.0 * p.kIce * hSnow)
        k32 = _rdiv(2.0 * p.kIce, hIceS)
        # ice temperatures from enthalpies (solve4temp:291-296)
        a1 = p.cpIce
        b1 = qIc1 + (p.cpWater - p.cpIce) * p.Tmlt1 - p.Lfresh
        c1 = p.Lfresh * p.Tmlt1
        disc = torch.sqrt(_max(b1 * b1 - 4.0 * a1 * c1, 0.0))
        tIc1 = _where(on, _div(0.5 * (-b1 - disc), a1), 0.0)
        tIc2 = _where(on, _div(p.Lfresh - qIc2, p.cpIce), 0.0)
        tIc1s = _where(on, _min(tIc1, -1.0e-10), -1.0)
        # quadratic coefficients (solve4temp:312-326)
        rci = p.rhoi * p.cpIce
        a10 = (_div(rci * hIceS, 2.0 * dt)
               + k32 * (4.0 * dt * k32 + rci * hIceS)
               / (6.0 * dt * k32 + rci * hIceS))
        b10 = (_div(-hIceS * (rci * tIc1
                              + _rdiv(p.rhoi * p.Lfresh * p.Tmlt1, tIc1s)),
                    2.0 * dt)
               - k32 * (4.0 * dt * k32 * tFrz + rci * hIceS * tIc2)
               / (6.0 * dt * k32 + rci * hIceS)
               - fswint)
        c10 = _div(p.rhoi * p.Lfresh * hIceS * p.Tmlt1, 2.0 * dt)
        icFlag = _where(on, 1.0, 0.0, like=tSrf)
        # fluxes over melting surface Ts=0
        flx0, _d0, evap_0, _de0 = self.get_exf(forc, icFlag, hSnow,
                                               torch.zeros_like(tSrf))

        # --- fixed-iteration implicit solve (solve4temp:363-545) ---
        z = torch.zeros_like(tSrf)
        tSrf_c, tIc1_c, dTsrf_c = tSrf, tIc1, torch.full_like(tSrf,
                                                              p.Terrmax)
        flxT_c = evapT_c = dFdT_c = dEdT_c = z
        active = on
        live = torch.zeros_like(tSrf, dtype=torch.int32)
        melted = torch.zeros_like(on)
        for _ in range(p.nitMaxTsf):
            flxT, dFdT, evapT, dEdT = self.get_exf(forc, icFlag, hSnow,
                                                   tSrf_c)
            # only update where still iterating
            flxT = torch.where(active, flxT, flxT_c)
            dFdT = torch.where(active, dFdT, dFdT_c)
            evapT = torch.where(active, evapT, evapT_c)
            dEdT = torch.where(active, dEdT, dEdT_c)
            flxNet = sHeat + flxT
            den = k12 - dFdT
            a1i = a10 - k12 * dFdT / den
            b1i = b10 - k12 * (flxNet - dFdT * tSrf_c) / den
            disc_i = torch.sqrt(_max(b1i * b1i - 4.0 * a1i * c10, 0.0))
            t1 = -(b1i + disc_i) / (2.0 * a1i)
            dTs = (flxNet + k12 * (t1 - tSrf_c)) / den
            TsfTmp = tSrf_c + dTs
            # melting-surface branch (Tsf > 0 -> fix at 0)
            a1m = a10 + k12
            disc_m = torch.sqrt(_max(b10 * b10 - 4.0 * a1m * c10, 0.0))
            t1m = (-b10 - disc_m) / (2.0 * a1m)
            melt = TsfTmp > 0.0
            t1_new = torch.where(melt, t1m, t1)
            ts_new = _where(melt, 0.0, TsfTmp)
            flxT_new = torch.where(melt, flx0, flxT)
            evapT_new = torch.where(melt, evap_0, evapT)
            dTs_new = _where(melt, 0.0, dTs)
            # apply only where active & iced
            upd = active & on
            if stats is not None:
                live = live + upd.to(torch.int32)
                melted = melted | (upd & melt)
            tSrf_c = torch.where(upd, ts_new, tSrf_c)
            tIc1_c = torch.where(upd, t1_new, tIc1_c)
            dTsrf_c = torch.where(upd, dTs_new, dTsrf_c)
            flxT_c = torch.where(upd, flxT_new, flxT_c)
            evapT_c = torch.where(upd, evapT_new, evapT_c)
            dFdT_c, dEdT_c = dFdT, dEdT
            active = on & (dTsrf_c.abs() >= p.Terrmax)
        if stats is not None:
            stats["iterations"], stats["melt"] = live, melted
        tSrf, tIc1, dTsrf = tSrf_c, tIc1_c, dTsrf_c
        flxTexSW, evapT, dFlxdT, dEvdT = flxT_c, evapT_c, dFdT_c, dEdT_c

        # new bottom-layer temperature (solve4temp:566-573)
        tIc2 = torch.where(on, (2.0 * dt * k32 * (tIc1 + 2.0 * tFrz)
                                + rci * hIceS * tIc2)
                           / (6.0 * dt * k32 + rci * hIceS), tIc2)
        # final fluxes (solve4temp:580-600)
        fct = k12 * (tSrf - tIc1)
        flxCnB = _where(on, 4.0 * p.kIce * (tIc2 - tFrz) / hIceS, 0.0)
        flxNet = sHeat + flxTexSW + dFlxdT * dTsrf
        evpAtm = _where(on, evapT + dEvdT * dTsrf, 0.0)
        flxAtm = _where(on, flxAtm + flxTexSW + dFlxdT * dTsrf
                        + evpAtm * p.Lfresh, 0.0)
        sHeat = _where(on, flxNet - fct, 0.0)
        # new enthalpies (solve4temp:607-610)
        tIc1s2 = _where(on, _min(tIc1, -1.0e-10), -1.0)
        qIc1 = torch.where(on, -p.cpWater * p.Tmlt1
                           + p.cpIce * (p.Tmlt1 - tIc1)
                           + p.Lfresh * (1.0 - _rdiv(p.Tmlt1, tIc1s2)),
                           qIc1)
        qIc2 = torch.where(on, -p.cpIce * tIc2 + p.Lfresh, qIc2)
        return (flxSW_out, tSrf, qIc1, qIc2, tIc1, tIc2, sHeat, flxCnB,
                flxAtm, evpAtm)

    # ------------------------------------------------------------------
    def calc_thickn(self, iceMask, tFrz, tOce, v2oc, snowP, prcAtm,
                    sHeat, flxCnB, icFrac, hIce, hSnow, tSrf, qIc1, qIc2,
                    frwAtm, fzMlOc, flx2oc, branches=None):
        """thsice_calc_thickn.F: top and bottom growth and melt,
        sublimation, flooding, the Winton layer reshaping, lateral melt
        and the ocean fluxes, with THSICE_FRACEN_POWERLAW's degree-5 power
        law (THSICE_OPTIONS.h:11, powerLawExp2=2). Returns (icFrac, hIce,
        hSnow, tSrf, qIc1, qIc2, frwAtm, fzMlOc, flx2oc, frw2oc, fsalt,
        frzSeaWat). `branches`, a dict, gets the mask of the cells that
        took each branch, by name."""
        p = self.p
        dt = p.thSIce_deltaT
        on = iceMask > 0.0
        cpchr = p.cpWater * p.rhosw * p.bMeltCoef
        lowIcFrac1 = p.iceMaskMin * 1.01
        lowIcFrac2 = p.iceMaskMin * 1.10
        z = torch.zeros_like(hIce)
        br = {} if branches is None else branches

        q1, q2 = qIc1, qIc2
        evapLoc = torch.where(on, frwAtm, z)
        # --- power-law vertical/lateral energy-partition coefficients
        # (calc_thickn:253-269 with powerLaw = 1+2**powerLawExp2 = 5)
        powerLaw = 5
        rec_pLaw = 1.0 / powerLaw
        c1Mlt = p.fracEnMelt ** rec_pLaw
        c2Mlt = (1.0 - p.fracEnMelt) ** rec_pLaw
        aMlt = (c1Mlt + c2Mlt) / (p.hThickIce - p.hThinIce)
        hMlt = p.hThinIce + c2Mlt / aMlt
        c1Frz = p.fracEnFreez ** rec_pLaw
        c2Frz = (1.0 - p.fracEnFreez) ** rec_pLaw
        aFrz = (c1Frz + c2Frz) / (p.hThickIce - p.hThinIce)
        hFrz = p.hThinIce + c2Frz / aFrz
        # enFrc* = clip(fracEn* - [a*(hi-h*)]^powerLaw, 0, 1)
        # (calc_thickn:317-340)
        xxMlt = _pow5(aMlt * (hIce - hMlt))
        xxFrz = _pow5(aFrz * (hIce - hFrz))
        enFrcMlt = _clip(p.fracEnMelt - xxMlt, 0.0, 1.0)
        enFrcFrz = _clip(p.fracEnFreez - xxFrz, 0.0, 1.0)
        # --- Fbot: ocean heat flux to the ice base (calc_thickn:343-409)
        frz = fzMlOc >= 0.0
        fb_frz = torch.where(icFrac < p.iceMaskMax, enFrcFrz * fzMlOc,
                             fzMlOc)
        ustar = _max(5.0e-3, torch.sqrt(0.00536 * v2oc))
        fb_mlt = _min(_max(cpchr * (tFrz - tOce) * ustar, fzMlOc), 0.0)
        Fbot = torch.where(on, torch.where(frz, fb_frz, fb_mlt), z)
        mwater0 = p.rhos * hSnow + p.rhoi * hIce
        msalt0 = p.rhoi * hIce * p.saltIce

        # --- lateral-melt energy fraction (calc_thickn:436-442 powerlaw)
        if p.fracEnMelt == 0.0:
            frace = z
        else:
            frace = _div(icFrac - lowIcFrac1, lowIcFrac2 - p.iceMaskMin)
            frace = _min(enFrcMlt, _max(0.0, frace))
        pos = sHeat > 0.0
        etop = torch.where(on & pos, (1.0 - frace) * sHeat * dt, z)
        etope = torch.where(on & pos, frace * sHeat * dt, z)
        esurp = torch.where(on & ~pos, sHeat * dt, z)
        ebot = torch.where(on, (flxCnB - Fbot) * dt, z)
        ebote = torch.where(ebot > 0.0, frace * ebot, z)
        ebot = ebot - ebote

        # --- layers + top melt (snow -> l1 -> l2), calc_thickn:498-576
        h1 = hIce * 0.5
        h2 = hIce * 0.5
        c = on & (etop > 0.0) & (hSnow > 0.0)
        rq = p.rhos * p.qsnow
        rqh = rq * hSnow
        less = etop < rqh
        br["top melt of snow"] = c
        hSnow = torch.where(c, _where(less, hSnow - _div(etop, rq), 0.0),
                            hSnow)
        etop = torch.where(c, _where(less, 0.0, etop - rqh), etop)

        def melt_top(h, q, etop, name):
            c = on & (etop > 0.0)
            br[name] = c
            rq = p.rhoi * _safe(q, q > 0.0)
            rqh = rq * h
            less = etop < rqh
            h_new = torch.where(c, _where(less, h - etop / rq, 0.0), h)
            # reference zeroes etop where it was <= 0 inside the loop
            etop_new = torch.where(c, _where(less, 0.0, etop - rqh),
                                   _where(on, 0.0, etop))
            return h_new, etop_new

        h1, etop = melt_top(h1, q1, etop, "top melt of layer 1")
        h2, etop = melt_top(h2, q2, etop, "top melt of layer 2")

        # --- bottom growth (calc_thickn:595-612)
        grow = on & (ebot < 0.0)
        br["bottom growth"] = grow
        qbot = -p.cpIce * tFrz + p.Lfresh
        dhi = torch.where(grow, -ebot / (qbot * p.rhoi), z)
        q2 = torch.where(grow, (h2 * q2 + dhi * qbot)
                         / _safe(h2 + dhi, (h2 + dhi) > 0.0), q2)
        h2 = torch.where(grow, h2 + dhi, h2)
        frzSeaWat = torch.where(grow, _div(p.rhoi * dhi, dt), z)
        ebot = _where(grow, 0.0, ebot)

        # --- bottom melt (l2 -> l1 -> snow), calc_thickn:622-684
        def melt_bot(h, q, ebot):
            c = on & (ebot > 0.0) & (h > 0.0)
            rq = p.rhoi * _safe(q, q > 0.0)
            rqh = rq * h
            less = ebot < rqh
            h_new = torch.where(c, _where(less, h - ebot / rq, 0.0), h)
            ebot_new = torch.where(c, _where(less, 0.0, ebot - rqh), ebot)
            return h_new, ebot_new

        h2, ebot = melt_bot(h2, q2, ebot)
        h1, ebot = melt_bot(h1, q1, ebot)
        c = on & (ebot > 0.0) & (hSnow > 0.0)
        br["bottom melt through snow"] = c
        rq = p.rhos * p.qsnow
        rqh = rq * hSnow
        less = ebot < rqh
        hSnow = torch.where(c, _where(less, hSnow - _div(ebot, rq), 0.0),
                            hSnow)
        ebot = torch.where(c, _where(less, 0.0, ebot - rqh), ebot)

        # --- total thickness; melt all if < hIceMin (calc_thickn:686-707)
        hIce = torch.where(on, h1 + h2, hIce)
        tiny = on & (hIce < p.hIceMin) & ((hIce + hSnow) > 0.0)
        br["hIce < hIceMin"] = tiny
        esurp = torch.where(tiny, esurp - p.rhos * p.qsnow * hSnow
                            - p.rhoi * q1 * h1 - p.rhoi * q2 * h2, esurp)
        hIce = _where(tiny, 0.0, hIce)
        h1 = _where(tiny, 0.0, h1)
        h2 = _where(tiny, 0.0, h2)
        hSnow = _where(tiny, 0.0, hSnow)
        tSrf = _where(tiny, 0.0, tSrf)
        icFrac = _where(tiny, 0.0, icFrac)
        q1 = _where(tiny, 0.0, q1)
        q2 = _where(tiny, 0.0, q2)

        # --- mass budget -> frw2oc; return snow if ice gone (714-731)
        frw2oc = torch.where(on, _div(mwater0 - (p.rhos * hSnow
                                                 + p.rhoi * hIce), dt), z)
        gone = on & (hIce <= 0.0)
        frw2oc = torch.where(gone, frw2oc + snowP, frw2oc)
        flx2oc = torch.where(gone, flx2oc - snowP * p.Lfresh, flx2oc)

        # --- snow fall + snow sublimation (736-758)
        has_ice = on & (hIce > 0.0)
        hSnow = torch.where(has_ice, hSnow + _div(dt * snowP, p.rhos),
                            hSnow)
        c = has_ice & (hSnow > 0.0)
        subl_all = _div(evapLoc, p.rhos) * dt > hSnow
        br["snow sublimation"] = c & (evapLoc > 0.0)
        hSnow_new = _where(subl_all, 0.0,
                           hSnow - _div(evapLoc, p.rhos) * dt)
        evap_new = _where(subl_all, evapLoc - _div(hSnow * p.rhos, dt),
                          0.0)
        hSnow = torch.where(c, hSnow_new, hSnow)
        evapLoc = torch.where(c, evap_new, evapLoc)

        # --- ice sublimation, enthalpy-aware (calc_thickn:762-815)
        def subl(h, q, evapLoc, esurp):
            c = on & (hIce > 0.0) & (evapLoc > 0.0)
            br["ice sublimation"] = br.get("ice sublimation", c) | c
            dhi = _div(evapLoc, p.rhoi) * dt
            all_ = dhi >= h
            esurp_new = torch.where(c & all_, esurp - h * p.rhoi
                                    * (q - p.Lfresh), esurp)
            evap_n = _where(all_, evapLoc - _div(h * p.rhoi, dt), 0.0)
            hq = h * q - dhi * p.Lfresh
            h_n = _where(all_, 0.0, h - dhi)
            q_n = torch.where(all_, q, hq / _safe(h_n, h_n > 0.0))
            return (torch.where(c, h_n, h), torch.where(c, q_n, q),
                    torch.where(c, evap_n, evapLoc), esurp_new)

        h1, q1, evapLoc, esurp = subl(h1, q1, evapLoc, esurp)
        h2, q2, evapLoc, esurp = subl(h2, q2, evapLoc, esurp)

        # --- recompute thickness; hIceMin check again (820-846)
        was_ice = on & (hIce > 0.0)
        hIce = torch.where(was_ice, h1 + h2, hIce)
        tiny2 = was_ice & (hIce > 0.0) & (hIce < p.hIceMin)
        br["hIce < hIceMin after sublimation"] = tiny2
        frw2oc = torch.where(tiny2, frw2oc + _div(p.rhos * hSnow
                                                  + p.rhoi * hIce, dt),
                             frw2oc)
        esurp = torch.where(tiny2, esurp - p.rhos * p.qsnow * hSnow
                            - p.rhoi * q1 * h1 - p.rhoi * q2 * h2, esurp)
        hIce = _where(tiny2, 0.0, hIce)
        h1 = _where(tiny2, 0.0, h1)
        h2 = _where(tiny2, 0.0, h2)
        hSnow = _where(tiny2, 0.0, hSnow)
        tSrf = _where(tiny2, 0.0, tSrf)
        icFrac = _where(tiny2, 0.0, icFrac)
        q1 = _where(tiny2, 0.0, q1)
        q2 = _where(tiny2, 0.0, q2)

        # --- snow-to-ice flooding (calc_thickn:856-886)
        alive = on & (hIce > 0.0)
        flood = alive & ((hSnow > hIce * p.floodFac) | (hSnow > p.hsMax))
        br["flooding"] = flood
        dhs = _div((hSnow - hIce * p.floodFac) * p.rhoi, p.rhosw)
        dhs = _max(hSnow - p.hsMax, dhs)
        dhi = _div(dhs * p.rhos, p.rhoi)
        rqh = p.rhoi * q1 * h1 + p.rhos * p.qsnow * dhs
        h1f = h1 + dhi
        q1 = torch.where(flood, rqh / (p.rhoi * _safe(h1f, h1f > 0.0)), q1)
        h1 = torch.where(flood, h1f, h1)
        hIce = torch.where(flood, hIce + dhi, hIce)
        hSnow = torch.where(flood, hSnow - dhs, hSnow)

        # --- hiMax cap (calc_thickn:920-934)
        cap = alive & (hIce > p.hiMax)
        br["hiMax cap"] = cap
        chi = hIce - p.hiMax
        h1 = torch.where(cap, h1 - chi * 0.5, h1)
        h2 = torch.where(cap, h2 - chi * 0.5, h2)
        frw2oc = torch.where(cap, frw2oc + _div(chi * p.rhoi, dt), frw2oc)
        hIce = torch.where(alive, h1 + h2, hIce)

        # --- Winton layer reshaping (inlined THSICE_RESHAPE_LAYERS)
        hlyr = hIce * 0.5
        hl_s = _safe(hlyr, hlyr > 0.0)
        give12 = h1 > h2
        f1a = (h1 - hlyr) / hl_s
        q2tmp = f1a * q1 + (1.0 - f1a) * q2
        qh2 = hlyr * q2
        qhtot = h1 * q1 + h2 * q2
        q1_keep = (qhtot - qh2) / hl_s
        q2_a = torch.where(q2tmp > p.Lfresh, q2tmp, q2)
        q1_a = torch.where(q2tmp > p.Lfresh, q1, q1_keep)
        f1b = h1 / hl_s
        q1_b = f1b * q1 + (1.0 - f1b) * q2
        resh = alive & (hIce > 0.0)
        br["reshaping, layer 1 thicker"] = resh & give12
        br["reshaping, layer 2 thicker"] = resh & ~give12
        q1 = torch.where(resh, torch.where(give12, q1_a, q1_b), q1)
        q2 = torch.where(resh, torch.where(give12, q2_a, q2), q2)

        # --- final fluxes (calc_thickn:1003-1052)
        icFrac = _where(on & (hIce <= 0.0), 0.0, icFrac)
        flx2oc = torch.where(on, flx2oc + Fbot
                             + _div(esurp + etop + ebot, dt), flx2oc)
        frw2oc = torch.where(on, frw2oc - evapLoc, frw2oc)
        flx2oc = torch.where(on, flx2oc + evapLoc * p.Lfresh, flx2oc)
        fsalt = torch.where(on, _div(msalt0 - p.rhoi * hIce * p.saltIce,
                                     dt), z)
        frw2oc = torch.where(on, frw2oc + (prcAtm - snowP), frw2oc)

        # --- lateral melting (calc_thickn:1058-1095)
        extend = etope + ebote
        lat = on & (icFrac > 0.0) & (extend > 0.0)
        rq = p.rhoi * 0.5 * (q1 + q2)
        rs = p.rhos * p.qsnow
        rqh = rq * hIce + rs * hSnow
        rqh_s = _safe(rqh, rqh > 0.0)
        freshe = _div(p.rhos * hSnow + p.rhoi * hIce, dt)
        salte = _div(p.rhoi * hIce * p.saltIce, dt)
        partial = extend < rqh
        icFrac_m = (1.0 - extend / rqh_s) * icFrac
        keep = partial & (icFrac_m >= p.iceMaskMin)
        br["lateral melt, fraction kept"] = lat & keep
        br["lateral melt, fraction lost"] = lat & ~keep
        frw2oc = torch.where(lat, torch.where(
            keep, frw2oc + extend / rqh_s * freshe, frw2oc + freshe),
            frw2oc)
        fsalt = torch.where(lat, torch.where(
            keep, fsalt + extend / rqh_s * salte, fsalt + salte), fsalt)
        flx2oc = torch.where(lat & ~keep, flx2oc + _div(extend - rqh, dt),
                             flx2oc)
        icFrac = torch.where(lat, _where(keep, icFrac_m, 0.0), icFrac)
        hIce = _where(lat & ~keep, 0.0, hIce)
        hSnow = _where(lat & ~keep, 0.0, hSnow)
        # extend > 0 on non-fraction cells goes straight to the ocean
        lat0 = on & (icFrac <= 0.0) & ~lat & (extend > 0.0)
        flx2oc = torch.where(lat0, flx2oc + _div(extend, dt), flx2oc)

        # --- outputs (calc_thickn:1098-1121)
        frwAtm = torch.where(on, frwAtm - prcAtm, frwAtm)
        fzMlOc = torch.where(on, fzMlOc - Fbot * iceMask, fzMlOc)
        return (icFrac, hIce, hSnow, tSrf, q1, q2, frwAtm, fzMlOc,
                flx2oc, frw2oc, fsalt, frzSeaWat)

    # ------------------------------------------------------------------
    def extend(self, fzMlOc, tFrz, tOce, icFrac, hIce, hSnow, tSrf,
               tIc1, tIc2, qIc1, qIc2, branches=None):
        """thsice_extend.F: freeze sea water, make or extend ice. Returns
        (icFrac, hIce, hSnow, tSrf, tIc1, tIc2, qIc1, qIc2, flx2oc,
        frw2oc, fsalt). `branches`, a dict, gets the cells of new ice and
        of thickened ice."""
        p = self.p
        dt = p.thSIce_deltaT
        act = fzMlOc > 0.0
        z = torch.zeros_like(hIce)
        # enthalpy of (possibly new) ice
        no_ice = icFrac <= 0.0
        q1n = (-p.cpWater * p.Tmlt1 + p.cpIce * (p.Tmlt1 - tFrz)
               + p.Lfresh * (1.0 - _rdiv(p.Tmlt1,
                                         _where(tFrz < 0.0, tFrz, -1.0e-10))))
        q2n = -p.cpIce * tFrz + p.Lfresh
        q1 = torch.where(act & no_ice, q1n, qIc1)
        q2 = torch.where(act & no_ice, q2n, qIc2)
        qicAv = p.rhoi * (q1 + q2) * 0.5
        newIce = torch.where(act, fzMlOc * dt
                             / _where(qicAv > 0.0, qicAv, 1.0), z)
        iceVol = icFrac * hIce
        # branch 1: no ice yet, enough new ice
        mk = act & no_ice & (newIce > p.hIceMin * p.iceMaskMin)
        th1 = _min(p.hThinIce, _div(newIce, p.iceMaskMin))
        th1 = _max(th1, _div(newIce, p.iceMaskMax))
        fr1 = newIce / _where(th1 > 0.0, th1, 1.0)
        formed1 = newIce
        # branch 2: existing ice below hiMax*maskMax
        mk2 = act & ~no_ice & (iceVol < p.hiMax * p.iceMaskMax)
        if branches is not None:
            branches["new ice"], branches["thickening"] = mk, mk2
        hNewIce = _min(_where(hIce > 0.0, hIce, p.hNewIceMax), p.hNewIceMax)
        fr2 = _min(icFrac + newIce / _where(hNewIce > 0.0, hNewIce, 1.0),
                   p.iceMaskMax)
        th2 = _min(p.hiMax, (iceVol + newIce) / _where(fr2 > 0.0, fr2, 1.0))
        formed2 = th2 * fr2 - iceVol
        hSnow2 = hSnow * icFrac / _where(fr2 > 0.0, fr2, 1.0)

        newFrac = torch.where(mk, fr1, torch.where(mk2, fr2, icFrac))
        newThick = torch.where(mk, th1, torch.where(mk2, th2, hIce))
        formed = torch.where(mk, formed1, torch.where(mk2, formed2, z))
        hSnow = torch.where(mk2, hSnow2, hSnow)
        flx2oc = torch.where(act, _div(qicAv * formed, dt), z)
        frw2oc = torch.where(act, _div(-p.rhoi * formed, dt), z)
        fsalt = torch.where(act, _div(-(p.rhoi * p.saltIce) * formed, dt),
                            z)
        # new-ice state where ice appears on an ice-free cell
        fresh = act & (newFrac > 0.0) & no_ice
        tSrf = torch.where(fresh, tFrz, tSrf)
        tIc1 = torch.where(fresh, tFrz, tIc1)
        tIc2 = torch.where(fresh, tFrz, tIc2)
        qIc1 = torch.where(act, q1, qIc1)
        qIc2 = torch.where(act, q2, qIc2)
        icFrac = torch.where(act, newFrac, icFrac)
        hIce = torch.where(act, newThick, hIce)
        return (icFrac, hIce, hSnow, tSrf, tIc1, tIc2, qIc1, qIc2,
                flx2oc, frw2oc, fsalt)

    # ------------------------------------------------------------------
    def step(self, th, forc, theta_ks, salt_ks, uVel_ks, vVel_ks,
             hFacC_ks, Qnet, Qsw, EmPmR, saltFlux, branches=None):
        """One thsice step (thsice_main.F: get_ocean -> map_exf ->
        step_temp -> step_fwd), kernel TH's twin. th: the dict of the nine
        th* fields; forc: the atmospheric state (TH_FORCING). Returns (th',
        {Qnet, Qsw, EmPmR, saltFlux}), every field halo-filled.
        `branches`, a dict, gets the cells of each branch of solve4temp,
        calc_thickn and extend, by name."""
        p = self.p
        cfg = self.cfg
        grid = self.grid
        br = {} if branches is None else branches
        iceMask = th["thIceMask"]
        hIce = th["thIceH"]
        hSnow = th["thSnowH"]
        snowAge = th["thSnowAge"]
        tSrf = th["thTsrf"]
        q1, q2 = th["thQice1"], th["thQice2"]

        # --- THSICE_GET_OCEAN (thsice_get_ocean.F) ---
        ks = cfg.ksurf0
        hOceMxL = grid.drF[ks] * hFacC_ks
        tOceMxL = theta_ks
        sOceMxL = salt_ks
        u2 = uVel_ks * uVel_ks + sh(uVel_ks, di=1) * sh(uVel_ks, di=1)
        v2 = vVel_ks * vVel_ks + sh(vVel_ks, dj=1) * sh(vVel_ks, dj=1)
        v2ocMxL = (u2 + v2) * 0.5

        # --- THSICE_MAP_EXF (thsice_map_exf.F) ---
        rhofw_cfg = cfg.rhoConstFresh or cfg.rhoConst
        totPrc = (forc.precip + forc.runoff) * rhofw_cfg
        flxSW0 = forc.swdown
        snowPrc = _where((iceMask > 0.0) & (forc.atemp <= cfg.celsius2K),
                         forc.precip * rhofw_cfg, 0.0)
        qPrcRnO = torch.zeros_like(totPrc)
        if cfg.temp_EvPrRn is not None:
            qPrcRnO = (cfg.HeatCapacity_Cp
                       * (forc.atemp - cfg.celsius2K - cfg.temp_EvPrRn)
                       * (forc.precip * rhofw_cfg - snowPrc)
                       + cfg.HeatCapacity_Cp
                       * (tOceMxL - cfg.temp_EvPrRn)
                       * forc.runoff * rhofw_cfg)

        # --- THSICE_STEP_TEMP (thsice_step_temp.F) ---
        on = iceMask > 0.0
        alb = self.albedo(iceMask, hIce, hSnow, tSrf, snowAge)
        icFlxSW = torch.where(on, flxSW0 * (1.0 - alb), flxSW0)
        tFrzOce = _where(on, -p.mu_Tf * sOceMxL, 0.0)
        stats = {} if branches is not None else None
        (icFlxSW, tSrf, q1, q2, tIc1, tIc2, sHeating, flxCndBt,
         icFlxAtm, icFrwAtm) = self.solve4temp(
            forc, iceMask, hIce, hSnow, tFrzOce, icFlxSW, tSrf, q1, q2,
            stats=stats)
        if stats is not None:
            br["melting surface"] = stats["melt"]
            br["iterations"] = stats["iterations"]
        icFrac0 = iceMask
        opFrac0 = 1.0 - icFrac0
        Qsw = torch.where(on, opFrac0 * Qsw - icFrac0 * icFlxSW, Qsw)

        # --- THSICE_STEP_FWD (thsice_step_fwd.F) ---
        dt = p.thSIce_deltaT
        ageFac = 1.0 - dt / p.snowAgTime
        snowFac = dt / (p.rhos * p.hNewSnowAge)
        snowAge = torch.where(on, dt + snowAge * ageFac, snowAge)
        snowAge = torch.where(on & (snowPrc > 0.0),
                              snowAge * torch.exp(-snowFac * snowPrc),
                              snowAge)
        icFlxAtm = torch.where(on, icFlxAtm - p.Lfresh * snowPrc + qPrcRnO,
                               icFlxAtm)

        # step_fwd part 2 recomputes tFrz UNMASKED (thsice_step_fwd.F:197)
        # so frzmlt is 0 on open water at the freezing point; the masked
        # one above is solve4temp's only
        tFrzAll = -p.mu_Tf * sOceMxL
        cphm = p.cpWater * p.rhosw * hOceMxL
        frzmltMxL = _div((tFrzAll - tOceMxL) * cphm, p.ocean_deltaT)
        icFrac = iceMask
        flx2oc = icFlxSW + qPrcRnO

        (icFrac, hIce, hSnow, tSrf, q1, q2, icFrwAtm, frzmltMxL, flx2oc,
         frw2oc, fsalt, frzSeaWat) = self.calc_thickn(
            iceMask, tFrzAll, tOceMxL, v2ocMxL, snowPrc, totPrc,
            sHeating, flxCndBt, icFrac, hIce, hSnow, tSrf, q1, q2,
            icFrwAtm, frzmltMxL, flx2oc, branches=branches)

        # net fluxes (step_fwd:263-306); the JAX step's icFlxAtm and
        # icFrwAtm blends are read by nothing and are not formed here
        Qnet = torch.where(on, -icFrac0 * flx2oc + opFrac0 * Qnet, Qnet)
        EmPmR = torch.where(on, -icFrac0 * frw2oc + opFrac0 * EmPmR, EmPmR)
        saltFlux = torch.where(on, -icFrac0 * fsalt,
                               torch.zeros_like(saltFlux))

        # --- THSICE_EXTEND (freeze open water) ---
        (icFrac, hIce, hSnow, tSrf, tIc1, tIc2, q1, q2, flx2oc_e,
         frw2oc_e, fsalt_e) = self.extend(
            frzmltMxL, tFrzAll, tOceMxL, icFrac, hIce, hSnow, tSrf,
            tIc1, tIc2, q1, q2, branches=branches)
        Qnet = Qnet - flx2oc_e
        EmPmR = EmPmR - frw2oc_e
        saltFlux = saltFlux - fsalt_e

        # final state bookkeeping (step_fwd:380-401)
        has = icFrac > 0.0
        iceMask = _where(has, icFrac, 0.0)
        snowAge = _where(has & (hSnow == 0.0), 0.0, snowAge)
        hIce = _where(has, hIce, 0.0)
        hSnow = _where(has, hSnow, 0.0)
        snowAge = _where(has, snowAge, 0.0)
        tSrf = torch.where(has, tSrf, tOceMxL)
        tIc1 = _where(has, tIc1, 0.0)
        tIc2 = _where(has, tIc2, 0.0)
        q1 = _where(has, q1, p.Lfresh)
        q2 = _where(has, q2, p.Lfresh)

        fl = self.fill
        th_out = dict(zip(TH_FIELDS, (fl(a) for a in (
            iceMask, hIce, hSnow, snowAge, tSrf, tIc1, tIc2, q1, q2))))
        upd = dict(zip(TH_FLUXES, (fl(a) for a in (Qnet, Qsw, EmPmR,
                                                   saltFlux))))
        return th_out, upd

    # ------------------------------------------------------------------
    def advance(self, th, forc, theta_ks, salt_ks, uVel_ks, vVel_ks,
                hFacC_ks, Qnet, Qsw, EmPmR, saltFlux, impl: str = None):
        """One step: kernel TH (one launch) on CUDA tensors, the twin
        `step` on CPU tensors or with impl="plain"; no fallback, and no
        gradient (kernel TH has no backward kernel)."""
        from mitgcm_tpu_torch.model import thsice_kernels

        args = (th, forc, theta_ks, salt_ks, uVel_ks, vVel_ks, hFacC_ks,
                Qnet, Qsw, EmPmR, saltFlux)
        thsice_kernels.refuse_grad(*args)
        if not kernels.use_kernel(th["thIceMask"], impl):
            global plain_calls
            plain_calls += 1
            return self.step(*args)
        return thsice_kernels.thsice_step(self, *args)

    # ------------------------------------------------------------------
    def monitor(self, th) -> Dict[str, torch.Tensor]:
        """thsice_monitor.F's %MON thSI_* statistics (mitgcm_tpu/model/
        thsice.py:monitor): volume weight rA*maskC*iceMask, latitude bands
        split at yC > 0, min and max over the interior cells of nonzero
        weight; Tic1/2 weighted by iceMask*iceHeight; TotEnerg_G =
        -rhos*Lfresh*Sum(w*hSnow) - rhoi/2*Sum(w*hIce*(Q1+Q2))."""
        g = self.grid
        cfg = self.cfg
        p = self.p
        oly, olx = cfg.oly, cfg.olx
        it = torch.zeros_like(g.rA)
        it[oly:oly + cfg.ny, olx:olx + cfg.nx] = 1.0
        base = g.rA * self.maskC0 * it
        north = _where(g.yC > 0.0, 1.0, 0.0, like=g.yC)
        south = 1.0 - north
        m = th["thIceMask"]

        def bands(fld, wmask):
            """(min_S, min_N, max_S, max_N, mean_G, mean_S, mean_N,
            vol_S, vol_N) with volume weight base*wmask."""
            w = base * wmask
            volS = torch.sum(w * south)
            volN = torch.sum(w * north)
            sumS = torch.sum(w * fld * south)
            sumN = torch.sum(w * fld * north)
            meanS = _where(volS > 0.0, sumS / _where(volS > 0, volS, 1.0),
                           0.0)
            meanN = _where(volN > 0.0, sumN / _where(volN > 0, volN, 1.0),
                           0.0)
            volG = volS + volN
            meanG = _where(volG > 0.0, (sumS + sumN)
                           / _where(volG > 0, volG, 1.0), 0.0)
            sel = (wmask != 0.0) & (it != 0.0)

            def mnmx(selh, volh):
                has = torch.any(selh)
                mn = torch.min(_where(selh, fld, 1e38))
                mx = torch.max(_where(selh, fld, -1e38))
                keep = has & (volh > 0.0)
                return _where(keep, mn, 0.0), _where(keep, mx, 0.0)
            mnS, mxS = mnmx(sel & (south != 0.0), volS)
            mnN, mxN = mnmx(sel & (north != 0.0), volN)
            return (mnS, mnN, mxS, mxN, meanG, meanS, meanN, volS, volN)

        out = {}
        (_, _, mxS, mxN, meanG, meanS, meanN, volS, volN) = bands(
            th["thIceH"], m)
        out["thSI_Ice_Area_G"] = volS + volN
        out["thSI_Ice_Area_S"] = volS
        out["thSI_Ice_Area_N"] = volN
        out["thSI_IceH_ave_G"] = meanG
        out["thSI_IceH_ave_S"] = meanS
        out["thSI_IceH_ave_N"] = meanN
        out["thSI_IceH_max_S"] = mxS
        out["thSI_IceH_max_N"] = mxN

        (_, _, mxS, mxN, meanG, meanS, meanN, volS, volN) = bands(
            th["thSnowH"], m)
        snow_sum = meanG * (volS + volN)
        out["thSI_SnwH_ave_G"] = meanG
        out["thSI_SnwH_ave_S"] = meanS
        out["thSI_SnwH_ave_N"] = meanN
        out["thSI_SnwH_max_S"] = mxS
        out["thSI_SnwH_max_N"] = mxN

        (mnS, mnN, mxS, mxN, meanG, meanS, meanN, _, _) = bands(
            th["thTsrf"], m)
        out["thSI_Tsrf_ave_G"] = meanG
        out["thSI_Tsrf_ave_S"] = meanS
        out["thSI_Tsrf_ave_N"] = meanN
        out["thSI_Tsrf_min_S"] = mnS
        out["thSI_Tsrf_min_N"] = mnN
        out["thSI_Tsrf_max_S"] = mxS
        out["thSI_Tsrf_max_N"] = mxN

        mh = m * th["thIceH"]
        for tnm, qfld in (("Tic1", th["thTice1"]), ("Tic2", th["thTice2"])):
            (mnS, mnN, mxS, mxN, meanG, meanS, meanN, _, _) = bands(
                qfld, mh)
            out[f"thSI_{tnm}_ave_G"] = meanG
            out[f"thSI_{tnm}_ave_S"] = meanS
            out[f"thSI_{tnm}_ave_N"] = meanN
            out[f"thSI_{tnm}_min_S"] = mnS
            out[f"thSI_{tnm}_min_N"] = mnN
            out[f"thSI_{tnm}_max_S"] = mxS
            out[f"thSI_{tnm}_max_N"] = mxN

        wmh = base * mh
        out["thSI_TotEnerg_G"] = (
            -p.rhos * p.Lfresh * snow_sum
            - p.rhoi * 0.5 * torch.sum(wmh * (th["thQice1"]
                                              + th["thQice2"])))
        return out

