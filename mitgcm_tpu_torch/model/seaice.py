"""Dynamic-thermodynamic sea ice (mitgcm_tpu/model/seaice.py; reference
pkg/seaice, C-grid): one step of SEAICE_MODEL with its dynamics (the
viscous-plastic LSR, Picard passes around a zebra line-SOR on per-tile
tridiagonal lines; or the elastic-viscous-plastic EVP subcycles, EVP*,
revised, adaptive or classic; or free drift; or none), the ice-ocean
stress (or Hibler and Bryan's under EVP), the multi-dimensional advection
of HEFF, AREA and HSNOW, and the 0-layer multi-category thermodynamics
(reg_ridge, growth with solve4temp per category).

Six hand-written CUDA kernels carry the step on the card
(kernels/csrc/seaice_lsr.cu, seaice_evp.cu, seaice_freedrift.cu,
seaice_advect.cu, seaice_thermo.cu), each beside its plain PyTorch twin
here, which runs for CPU tensors or with impl="plain":
  lsr_prep       seaice_lsr_visc + seaice_lsr_coeffs: one Picard pass's
                 strain rates, viscosities, ocean drag, right-hand sides
                 and tridiagonal coefficients (two launches, because the
                 Z-point viscosities read neighbours of computed values)
  lsr_iterate    seaice_lsr_tridiag_u/_v (one launch per half-sweep) and
                 seaice_lsr_check (the convergence test, the relaxation
                 freeze, the stops and the halo fill): the linear loop stays
                 on the device and the host reads its control words once
                 per BATCH iterations
  evp            seaice_evp_stress + seaice_evp_uv: one EVP subcycle in two
                 launches (sigma12 at a Z point reads zeta and alpha at four
                 C points), the whole loop enqueued with no host read
  freedrift      seaice_freedrift: one launch, both halo fills included
  advdiff        seaice_advect_x/_y: HEFF, AREA and HSNOW together
  thermo         seaice_thermo: reg_ridge, growth and solve4temp fused, one
                 thread per column
get_dynforcing, ocean_stress(_hb87), the clip, the no-dynamics drag, EVP's
per-step set-up, the strength and masses and the end-of-step fills stay
plain glue. `check_seaice` refuses by name every option this port does not
carry (SItracers, HB87 coupling without EVP, the legacy and OS7MP ice
advection, ...). Parameters come as dicts (the namelists' keys); the deck
reader is not ported.
"""
from __future__ import annotations

import math
import types
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import gad, seaice_kernels
from mitgcm_tpu_torch.ops.stencil import cyclic_fill_halo, shift as sh

@dataclass
class SeaiceParams:
    """The seaice_readparms.F defaults (mitgcm_tpu/model/seaice.py:45)."""
    deltaTtherm: float = 0.0       # set from deltaTClock
    deltaTdyn: float = 0.0
    useDYNAMICS: bool = True
    updateOceanStress: bool = True
    rhoIce: float = 910.0
    rhoSnow: float = 330.0
    rhoAir: float = 1.2
    OCEAN_drag: float = 1.0e-3
    drag: float = 1.0e-3
    drag_south: float = 1.0e-3
    waterDrag: float = 5.5404e-3 * 0.0 + 5.5404e-3  # overridden by nml
    waterDrag_south: float = 5.5404e-3
    dWatMin: float = 0.25
    basalDragK2: float = 0.0
    useTilt: bool = True
    strength: float = 2.75e4
    cStar: float = 20.0
    pressReplFac: float = 1.0
    tensilFac: float = 0.0
    etaZmethod: int = 3            # seaice_readparms.F:318 default
    zetaMaxFac: float = 2.5e8
    zetaMin: float = 0.0
    eccen: float = 2.0
    stressFactor: float = 1.0
    airTurnAngle: float = 0.0
    waterTurnAngle: float = 0.0
    useMetricTerms: bool = True
    no_slip: bool = False
    scaleSurfStress: bool = True   # seaice_readparms.F:262 default
    maskRHS: bool = False
    addSnowMass: bool = True
    LSRrelaxU: float = 0.95
    LSRrelaxV: float = 0.95
    LSR_ERROR: float = 1.0e-12     # readparms default; lab_sea sets 1e-4
    SOLV_NCHECK: int = 2
    nonLinIterMax: int = 2
    linearIterMax: int = 1500
    advHeff: bool = True
    advArea: bool = True
    advSnow: bool = True
    advScheme: int = 77
    # per-field schemes/diffusivities default UNSET (-1) and resolve via
    # the seaice_readparms.F:995-1019 cascade in params_from_namelists
    advSchArea: int = -1
    advSchHeff: int = -1
    advSchSnow: int = -1
    advSchSalt: int = -1
    diffKhArea: float = -1.0
    diffKhHeff: float = -1.0
    diffKhSnow: float = -1.0
    diffKhSalt: float = -1.0
    useFreeDrift: bool = False     # SEAICEuseFREEDRIFT (seaice_freedrift.F)
    restoreUnderIce: bool = False  # SEAICErestoreUnderIce
    LSR_mixIniGuess: int = -1      # LSR initial-guess mode (seaice_lsr.F)
    saltFrac: float = 0.0          # SEAICE_saltFrac (HSALT init/growth)
    # --- EVP (seaice_evp.F + readparms derivation :748-820) ---
    useEVP: bool = False           # derived from the three triggers
    deltaTevp: float = -1.0        # SEAICE_deltaTevp (UNSET=-1)
    evpAlpha: float = -1.0         # SEAICE_evpAlpha
    evpBeta: float = -1.0          # SEAICE_evpBeta
    elasticParm: float = 1.0 / 3.0  # SEAICE_elasticParm
    evpTauRelax: float = -1.0      # SEAICE_evpTauRelax
    nEVPstarSteps: int = -1        # SEAICEnEVPstarSteps
    useEVPstar: bool = True        # SEAICEuseEVPstar (readparms:254)
    useEVPrev: bool = True         # SEAICEuseEVPrev (readparms:255)
    aEVPcoeff: float = -1.0        # SEAICEaEVPcoeff (UNSET=-1 -> no aEVP)
    aEVPcStar: float = 4.0         # SEAICEaEVPcStar
    aEVPalphaMin: float = 5.0      # SEAICEaEVPalphaMin
    useHB87stressCoupling: bool = False
    # initial-condition files (seaice_init_varia.F:285-367)
    AreaFile: str = ""
    HeffFile: str = ""
    HsnowFile: str = ""
    uIceFile: str = ""
    vIceFile: str = ""
    useFluxForm: bool = True       # SEAICEuseFluxForm (advect.F / diffus.F)
    DIFF1: float = 0.0             # legacy harmonic+biharmonic diffusion
    lhEvap: float = 2.5e6
    lhFusion: float = 3.34e5
    mcPheePiston: float = 0.0      # derived: STANTON*USTAR if unset
    mcPheeTaper: float = 0.0
    mcPheeStepFunc: bool = False
    frazilFrac: float = 1.0
    tempFrz0: float = 0.0901
    dTempFrz_dS: float = -0.0575
    growMeltByConv: bool = False
    doOpenWaterGrowth: bool = True
    doOpenWaterMelt: bool = False
    useStrImpCpl: bool = False     # SEAICEuseStrImpCpl (LSR implicit cpl)
    clipVelocities: bool = False   # SEAICE_clipVelocities (cap at 0.4m/s)
    areaGainFormula: int = 1
    areaLossFormula: int = 1
    HO: float = 0.5
    HO_south: float = 0.5
    area_max: float = 1.0
    salt0: float = 0.0
    useFlooding: bool = True
    heatConsFix: bool = False
    multDim: int = 1
    useMultDimSnow: bool = False
    IMAX_TICE: int = 10
    postSolvTempIter: int = 2
    dryIceAlb: float = 0.75
    wetIceAlb: float = 0.66
    drySnowAlb: float = 0.84
    wetSnowAlb: float = 0.70
    dryIceAlb_south: float = 0.75
    wetIceAlb_south: float = 0.66
    drySnowAlb_south: float = 0.84
    wetSnowAlb_south: float = 0.70
    wetAlbTemp: float = -1.0e-3
    snow_emiss: float = 0.95
    ice_emiss: float = 0.95
    boltzmann: float = 5.67e-8
    cpAir: float = 1005.0
    dalton: float = 1.75e-3
    iceConduct: float = 2.1656
    snowConduct: float = 0.31
    snowThick: float = 0.15
    shortwave: float = 0.30
    useMaykutSatVapPoly: bool = False
    MIN_ATEMP: float = -50.0
    MIN_LWDOWN: float = 60.0
    MIN_TICE: float = -50.0
    deltaMin: float = 1.0e-10      # lab_sea echo (SEAICE_deltaMin)
    EPS: float = 1.0e-10
    area_reg: float = 1.0e-5
    hice_reg: float = 0.05
    area_floor: float = 1.0e-5
    SItrNumInUse: int = 0
    SItrName: tuple = ()
    SItrMate: tuple = ()
    SItrFromOcean0: tuple = ()
    SItrFromFlood0: tuple = ()
    SItrExpand0: tuple = ()
    # PDF over thickness categories
    pdf: tuple = ()

    @property
    def EPS_SQ(self):
        return self.EPS * self.EPS




_NML_MAP = {
    "seaice_no_slip": "no_slip", "seaice_salt0": "salt0",
    "seaiceadvscheme": "advScheme", "seaice_multdim": "multDim",
    "seaice_wetalbtemp": "wetAlbTemp", "seaice_mcpheetaper": "mcPheeTaper",
    "seaicescalesurfstress": "scaleSurfStress",
    "seaiceaddsnowmass": "addSnowMass",
    "seaice_usemultdimsnow": "useMultDimSnow",
    "seaiceetazmethod": "etaZmethod",
    "seaice_waterdrag": "waterDrag", "lsr_error": "LSR_ERROR",
    "seaice_strength": "strength", "seaice_drag": "drag",
    "ocean_drag": "OCEAN_drag", "seaice_deltamin": "deltaMin",
    "seaice_deltattherm": "deltaTtherm", "seaice_deltatdyn": "deltaTdyn",
    "seaice_rhoice": "rhoIce", "seaice_rhosnow": "rhoSnow",
    "seaicepressreplfac": "pressReplFac",
    "seaice_mcpheepiston": "mcPheePiston",
    "seaice_dryicealb": "dryIceAlb", "seaice_weticealb": "wetIceAlb",
    "seaice_drysnowalb": "drySnowAlb", "seaice_wetsnowalb": "wetSnowAlb",
    "seaice_tempfrz0": "tempFrz0", "seaice_dtempfrz_ds": "dTempFrz_dS",
    "seaice_area_max": "area_max", "seaice_area_reg": "area_reg",
    "seaice_hice_reg": "hice_reg", "seaicewritestate": None,
    "seaice_olx": None, "seaice_oly": None,
    "seaice_monfreq": None, "seaice_waterturnangle": "waterTurnAngle",
    "seaice_airturnangle": "airTurnAngle",
    "seaice_arealossformula": "areaLossFormula",
    "seaice_areagainformula": "areaGainFormula",
    "seaiceusestrimpcpl": "useStrImpCpl",
    "seaice_clipvelocities": "clipVelocities",
    "seaiceheatconsfix": "heatConsFix",
    "seaicedoopenwatergrowth": "doOpenWaterGrowth",
    "seaicedoopenwatermelt": "doOpenWaterMelt",
    "seaice_tempfrz_ds": "dTempFrz_dS",
    "seaiceusefreedrift": "useFreeDrift",
    "seaiceadvscharea": "advSchArea", "seaiceadvschheff": "advSchHeff",
    "seaiceadvschsnow": "advSchSnow", "seaiceadvschsalt": "advSchSalt",
    "seaicediffkharea": "diffKhArea", "seaicediffkhheff": "diffKhHeff",
    "seaicediffkhsnow": "diffKhSnow", "seaicediffkhsalt": "diffKhSalt",
    "seaice_frazilfrac": "frazilFrac",
    "seaice_deltatevp": "deltaTevp", "seaice_evpalpha": "evpAlpha",
    "seaice_evpbeta": "evpBeta", "seaice_elasticparm": "elasticParm",
    "seaice_evptaurelax": "evpTauRelax",
    "seaicenevpstarsteps": "nEVPstarSteps",
    "seaiceuseevpstar": "useEVPstar", "seaiceuseevprev": "useEVPrev",
    "seaiceaevpcoeff": "aEVPcoeff", "seaiceaevpcstar": "aEVPcStar",
    "seaiceaevpalphamin": "aEVPalphaMin",
    "usehb87stresscoupling": "useHB87stressCoupling",
    "seaiceusefluxform": "useFluxForm", "diff1": "DIFF1",
    "seaiceusedynamics": "useDYNAMICS",
    "seaicerestoreunderice": "restoreUnderIce",
    "seaicelinearitermax": "linearIterMax",
    "lsr_mixiniguess": "LSR_mixIniGuess",
    "seaice_area_floor": "area_floor",
    "seaice_saltfrac": "saltFrac",
    "areafile": "AreaFile", "hefffile": "HeffFile",
    "hsnowfile": "HsnowFile", "hsaltfile": None,
    "uicefile": "uIceFile", "vicefile": "vIceFile",
}


def params_from_namelists(cfg: Config, nml01: dict, nml03: dict = None
                          ) -> SeaiceParams:
    """data.seaice SEAICE_PARM01 + SEAICE_PARM03 -> SeaiceParams,
    with the derived defaults of seaice_readparms.F / seaice_check.F."""
    p = SeaiceParams()
    nml03 = nml03 or {}
    for k, v in nml01.items():
        kk = k.lower()
        if kk in _NML_MAP:
            tgt = _NML_MAP[kk]
            if tgt is None:
                continue
            cur = getattr(p, tgt)
            if isinstance(cur, bool):
                setattr(p, tgt, bool(v))
            elif isinstance(cur, int) and not isinstance(cur, bool):
                setattr(p, tgt, int(v))
            elif isinstance(cur, str):
                setattr(p, tgt, str(v).strip())
            else:
                setattr(p, tgt, float(v))
        # silently keep unknowns out: seaice_check.F validates; the
        # config-check slice will make this loud
    # advection-scheme / diffusivity cascade (seaice_readparms.F:995-1019)
    if p.advSchArea < 0:
        p.advSchArea = p.advSchHeff
    if p.advSchArea < 0:
        p.advSchArea = p.advScheme
    p.advScheme = p.advSchArea
    if p.advSchHeff < 0:
        p.advSchHeff = p.advSchArea
    if p.advSchSnow < 0:
        p.advSchSnow = p.advSchHeff
    if p.advSchSalt < 0:
        p.advSchSalt = p.advSchHeff
    if p.diffKhArea < 0:
        p.diffKhArea = p.diffKhHeff
    if p.diffKhArea < 0:
        p.diffKhArea = 0.0
    if p.diffKhHeff < 0:
        p.diffKhHeff = p.diffKhArea
    if p.diffKhSnow < 0:
        p.diffKhSnow = p.diffKhHeff
    if p.diffKhSalt < 0:
        p.diffKhSalt = p.diffKhHeff
    if p.deltaTtherm == 0.0:
        p.deltaTtherm = cfg.deltaTClock
    if p.deltaTdyn == 0.0:
        p.deltaTdyn = p.deltaTtherm
    if p.waterDrag_south == SeaiceParams.waterDrag_south:
        p.waterDrag_south = p.waterDrag
    if p.drag_south == SeaiceParams.drag_south:
        p.drag_south = p.drag
    # EVP triggers + derived parameters (seaice_readparms.F:748-820)
    p.useEVP = (p.deltaTevp > 0.0 or p.evpAlpha > 0.0 or p.evpBeta > 0.0
                or p.aEVPcoeff > 0.0)
    if p.useEVP:
        if p.evpTauRelax <= 0.0:
            p.evpTauRelax = p.deltaTdyn * p.elasticParm
        if p.nEVPstarSteps < 0:
            if p.deltaTevp <= 0.0:
                raise ValueError("SEAICEnEVPstarSteps or SEAICE_deltaTevp "
                                 "must be set for EVP")
            p.nEVPstarSteps = int(p.deltaTdyn / p.deltaTevp)
        if p.evpAlpha > 0.0 and p.evpBeta <= 0.0:
            p.evpBeta = p.evpAlpha
        if p.evpBeta > 0.0 and p.evpAlpha <= 0.0:
            p.evpAlpha = p.evpBeta
        if p.evpBeta <= 0.0:
            p.evpBeta = p.deltaTdyn / p.deltaTevp
        else:
            p.deltaTevp = p.deltaTdyn / p.evpBeta
        if p.evpAlpha <= 0.0:
            p.evpAlpha = 2.0 * p.evpTauRelax / p.deltaTevp
        else:
            p.evpTauRelax = 0.5 * p.evpAlpha * p.deltaTevp
        if p.aEVPcoeff > 0.0:
            # adaptive EVP: alpha/beta computed per-cell each subcycle
            p.evpAlpha = -1.0
            p.evpBeta = -1.0
    if p.useFreeDrift:
        p.useEVP = False
    if p.mcPheePiston == 0.0:
        # seaice_init_fixed.F:92-104: MCPHEE_TAPER_FAC*STANTON*USTAR
        # capped by dzSurf/deltaTtherm; dzSurf in meters (p-coords:
        # drF(kSrf)/(rhoConst*g), seaice_init_fixed.F:93-95)
        if cfg.usingPCoords:
            dzSurf = cfg.delR[cfg.nr - 1] / (cfg.rhoConst * cfg.gravity)
        else:
            dzSurf = cfg.delR[0]
        p.mcPheePiston = min(12.5 * 0.0056 * 0.0125,
                             dzSurf / p.deltaTtherm)
    if not p.pdf:
        p.pdf = tuple([1.0 / p.multDim] * p.multDim)
    # SEAICE_PARM03 tracers
    n = int(nml03.get("sitrnuminuse", 0))
    p.SItrNumInUse = n
    names, mates = [], []
    fo0, ff0, ex0 = [], [], []
    for i in range(1, n + 1):
        names.append(str(nml03.get(f"sitrname({i})", "")).strip())
        mates.append(str(nml03.get(f"sitrmate({i})", "HEFF")).strip()
                     or "HEFF")
        fo0.append(float(nml03.get(f"sitrfromocean0({i})", 0.0)))
        ff0.append(float(nml03.get(f"sitrfromflood0({i})", 0.0)))
        ex0.append(float(nml03.get(f"sitrexpand0({i})", 0.0)))
    p.SItrName, p.SItrMate = tuple(names), tuple(mates)
    # seaice_init_fixed.F:116-124: the 'one' tracer sources are 1
    for i, nm in enumerate(names):
        if nm == "one":
            fo0[i] = 1.0
            ff0[i] = 1.0
            ex0[i] = 1.0
    p.SItrFromOcean0, p.SItrFromFlood0 = tuple(fo0), tuple(ff0)
    p.SItrExpand0 = tuple(ex0)
    return p



class IceState(NamedTuple):
    """The prognostic sea-ice state (SEAICE.h), [nyp, nxp] fields and
    TICES [multDim, nyp, nxp]; SItracer is zero-size here, and sigma
    (the EVP stresses sigma1, sigma2, sigma12) is [3, nyp, nxp] under EVP
    and zero-size otherwise."""
    uIce: torch.Tensor
    vIce: torch.Tensor
    AREA: torch.Tensor
    HEFF: torch.Tensor
    HSNOW: torch.Tensor
    HSALT: torch.Tensor
    TICES: torch.Tensor
    SItracer: torch.Tensor
    sigma: torch.Tensor


# the ice advection schemes kernel seaice_advect's flux function carries
# (gad_advect.cuh:flux_h, shared with kernel M)
ADV_SCHEMES = (gad.ENUM_UPWIND_1RST, gad.ENUM_DST2, gad.ENUM_DST3,
               gad.ENUM_DST3_FLUX_LIMIT, gad.ENUM_FLUX_LIMIT)
# the thickness categories kernel seaice_thermo takes (its parameter
# struct holds the pdf)
MAX_CATEGORIES = 16
# LSR iterations the kernel path enqueues between two reads of its control
# words
BATCH = 8

# calls of the four twins (a run on the card reads it to show that its
# kernel path never made one)
plain_calls = 0


def check_seaice(cfg: Config, seaice: "SeaIce") -> None:
    """Raise NotImplementedError, naming each, for the sea-ice options
    this port does not carry: SItracers, ice advection schemes outside
    ADV_SCHEMES (OS7MP 7 and the legacy 2/3/4 included) or different per
    field, HB87 stress coupling without EVP (the JAX package raises there
    too: only EVP gives the stress divergence), EVP with no subcycle, the
    implicit stress coupling, LSR_mixIniGuess, no-slip ice, etaZmethod
    other than 3 (under LSR and EVP), tensile strength, basal drag, the
    growth branches the kernel does not take, p-coordinates, a
    non-Cartesian grid or the cubed sphere, and tiles that do not cover the
    grid. The dynamics run as LSR, EVP (EVP*, revised, adaptive or
    classic), free drift or not at all (useDYNAMICS=F), with or without
    clipVelocities."""
    p = seaice.p
    schemes = (p.advSchHeff, p.advSchArea, p.advSchSnow)
    evp = p.useDYNAMICS and p.useEVP and not p.useFreeDrift
    off = {
        "SItrNumInUse>0": p.SItrNumInUse > 0,
        f"SEAICEadvScheme={schemes}": (
            any(s not in ADV_SCHEMES for s in schemes)
            or len(set(schemes)) > 1),
        "useHB87stressCoupling without EVP": (p.useHB87stressCoupling
                                              and not evp),
        "SEAICEnEVPstarSteps<1": evp and p.nEVPstarSteps < 1,
        "useStrImpCpl": p.useStrImpCpl,
        "LSR_mixIniGuess": p.LSR_mixIniGuess >= 0,
        "SEAICE_no_slip": p.no_slip,
        f"etaZmethod={p.etaZmethod}": p.etaZmethod != 3,
        "tensilFac": p.tensilFac != 0.0,
        "basalDragK2": p.basalDragK2 != 0.0,
        "SEAICEheatConsFix": p.heatConsFix,
        "growMeltByConv": p.growMeltByConv,
        "useMaykutSatVapPoly": p.useMaykutSatVapPoly,
        "postSolvTempIter!=2": p.postSolvTempIter != 2,
        "SEAICE_saltFrac": p.saltFrac != 0.0,
        "SEAICE_snowThick<=0": p.snowThick <= 0.0,
        f"SEAICE_multDim>{MAX_CATEGORIES}": p.multDim > MAX_CATEGORIES,
        "p-coordinates": cfg.usingPCoords or not cfg.usingZCoords,
        "non-Cartesian grid or cubed sphere": (
            not cfg.usingCartesianGrid or cfg.usingSphericalPolarGrid
            or cfg.usingCurvilinearGrid or cfg.nFaces != 1),
        "tiles that do not cover the grid": (
            cfg.sNx <= 0 or cfg.sNy <= 0 or cfg.sNx * cfg.nSx != cfg.nx
            or cfg.sNy * cfg.nSy != cfg.ny),
    }
    bad = [name for name, is_off in off.items() if is_off]
    if bad:
        raise NotImplementedError(
            f"sea ice: not on the ported path: {', '.join(bad)}")


_div = gad._div
# the atmospheric and surface forcing that seaice_thermo reads
_THERMO_FORCING = ("atemp", "aqh", "precip", "swdown", "lwdown", "runoff",
                   "wspeed", "evap", "Qnet", "Qsw", "EmPmR", "saltFlux")


def _rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t as one IEEE division (PyTorch computes a Python number over a
    tensor as t.reciprocal() * c)."""
    return t.new_tensor(c) / t


def _max(a, b):
    """jnp.maximum with a Python number on either side (NaN propagates)."""
    if not isinstance(a, torch.Tensor):
        a = b.new_tensor(a)
    if not isinstance(b, torch.Tensor):
        b = a.new_tensor(b)
    return torch.maximum(a, b)


def _min(a, b):
    if not isinstance(a, torch.Tensor):
        a = b.new_tensor(a)
    if not isinstance(b, torch.Tensor):
        b = a.new_tensor(b)
    return torch.minimum(a, b)


def _where(c, a, b, like=None):
    """jnp.where with Python numbers on either side, in the dtype of the
    float tensors among a, b and like."""
    like = next(x for x in (a, b, like) if isinstance(x, torch.Tensor)
                and x.is_floating_point())
    a = a if isinstance(a, torch.Tensor) else like.new_tensor(a)
    b = b if isinstance(b, torch.Tensor) else like.new_tensor(b)
    return torch.where(c, a, b)


def _sgn(f):
    """sign(f) with 0 read as 1 (seaice_lsr.F)."""
    one = f.new_tensor(1.0)
    return torch.where(f < 0.0, -one, one)


class SeaIce:
    """The sea-ice package on a Cartesian grid (seaice.py:SeaIce): masks,
    the shortwave fraction, the LSR's tiles, and one step."""

    def __init__(self, cfg: Config, grid: Grid, p: SeaiceParams):
        self.cfg, self.grid, self.p = cfg, grid, p
        ol, ny, nx = cfg.olx, cfg.ny, cfg.nx
        self.ol, self.ny, self.nx = ol, ny, nx
        check_seaice(cfg, self)
        ks = cfg.ksurf0
        self.HEFFM = grid.maskC[ks].contiguous()
        self.SIMaskU = grid.maskW[ks].contiguous()
        self.SIMaskV = grid.maskS[ks].contiguous()
        hm = self.HEFFM
        one, zero = hm.new_tensor(1.0), hm.new_tensor(0.0)
        self.seaiceMaskU = torch.where(hm + sh(hm, di=-1) > 1.5, one, zero)
        self.seaiceMaskV = torch.where(hm + sh(hm, dj=-1) > 1.5, one, zero)
        it = torch.zeros_like(hm)
        it[ol:ol + ny, ol:ol + nx] = 1.0
        self.interior = it
        # SEAICE_SWFrac (seaice_init_fixed.F:71-87, swfrac.F jwtype=2)
        z2 = float(grid.rF[1])
        rfac, a1, a2 = 0.62, 0.6, 20.0
        self.SWFrac = (rfac * math.exp(z2 / a1)
                       + (1.0 - rfac) * math.exp(z2 / a2))
        self.maskInCx = self.fill(grid.maskInC)
        # the LSR's tiles (SIZE.h): tile t = ty * nSx + tx covers the padded
        # rows [ty sNy, ty sNy + sNy + 2 ol) and columns [tx sNx, ...)
        dev = hm.device
        ty = torch.arange(cfg.nSy, device=dev).repeat_interleave(cfg.nSx)
        tx = torch.arange(cfg.nSx, device=dev).repeat(cfg.nSy)
        self._trows = (ty[:, None] * cfg.sNy
                       + torch.arange(cfg.sNy + 2 * ol, device=dev)[None])
        self._tcols = (tx[:, None] * cfg.sNx
                       + torch.arange(cfg.sNx + 2 * ol, device=dev)[None])

    def fill(self, a, impl: str = None):
        return cyclic_fill_halo(a, self.cfg.oly, self.cfg.olx, impl=impl)

    def fill_uv(self, u, v, impl: str = None):
        return self.fill(u, impl), self.fill(v, impl)

    def init_state(self, dtype=None) -> IceState:
        """Ice-free start (seaice_init_varia.F): TICES at 273 K; sigma
        [3, nyp, nxp] zeros under EVP, zero-size otherwise."""
        like = self.HEFFM if dtype is None else self.HEFFM.to(dtype)
        z2 = torch.zeros_like(like)
        tice = torch.full((self.p.multDim,) + tuple(z2.shape), 273.0,
                          dtype=z2.dtype, device=z2.device)
        empty = z2.new_zeros((0,) + tuple(z2.shape))
        # the EVP stresses sigma1, sigma2, sigma12 (seaice.py:init_state)
        sigma = z2.new_zeros((3 if self.p.useEVP else 0,) + tuple(z2.shape))
        return IceState(uIce=z2, vIce=z2.clone(), AREA=z2.clone(),
                        HEFF=z2.clone(), HSNOW=z2.clone(), HSALT=z2.clone(),
                        TICES=tice, SItracer=empty, sigma=sigma)

    # ------------------------------------------------------------------
    # plain glue
    # ------------------------------------------------------------------
    def get_dynforcing(self, forc):
        """seaice_get_dynforcing.F without exf: the ocean's wind stress
        rescaled by SEAICE_drag / OCEAN_drag."""
        p, g = self.p, self.grid
        cdair = _where(g.yC < 0.0, p.drag_south / p.OCEAN_drag,
                       p.drag / p.OCEAN_drag, like=g.yC)
        return cdair * forc.fu * self.SIMaskU, cdair * forc.fv * self.SIMaskV

    def ocean_stress(self, ice: IceState, dwatn, uVel0, vVel0, fu, fv,
                     impl: str = None):
        """seaice_ocean_stress.F (without HB87): the ice-ocean drag blended
        into the ocean's surface stress by the ice fraction."""
        p, g = self.p, self.grid
        sinwat = math.sin(math.radians(p.waterTurnAngle))
        coswat = math.cos(math.radians(p.waterTurnAngle))
        sgn = _sgn(g.fCori)
        du = ice.uIce - uVel0
        dv = ice.vIce - vVel0
        fuIce = (0.5 * (dwatn + sh(dwatn, di=-1)) * coswat * du
                 - sgn * sinwat * 0.5
                 * (dwatn * 0.5 * (dv + sh(dv, dj=1))
                    + sh(dwatn, di=-1) * 0.5
                    * (sh(dv, di=-1) + sh(sh(dv, dj=1), di=-1))))
        fvIce = (0.5 * (dwatn + sh(dwatn, dj=-1)) * coswat * dv
                 + sgn * sinwat * 0.5
                 * (dwatn * 0.5 * (du + sh(du, di=1))
                    + sh(dwatn, dj=-1) * 0.5
                    * (sh(du, dj=-1) + sh(sh(du, di=1), dj=-1))))
        areaW = 0.5 * (ice.AREA + sh(ice.AREA, di=-1)) * p.stressFactor
        areaS = 0.5 * (ice.AREA + sh(ice.AREA, dj=-1)) * p.stressFactor
        fu_new = (1.0 - areaW) * fu + areaW * fuIce
        fv_new = (1.0 - areaS) * fv + areaS * fvIce
        return self.fill_uv(fu_new, fv_new, impl)

    def ocean_stress_hb87(self, ice: IceState, windTauX, windTauY,
                          stressDivX, stressDivY, fu, fv, impl: str = None):
        """seaice_ocean_stress.F:66-100 under useHB87stressCoupling
        (seaice.py:ocean_stress_hb87): the ocean's surface stress is the
        wind's over the ice fraction plus the divergence of the EVP
        stresses (Hibler and Bryan 1987)."""
        p = self.p
        areaW = 0.5 * (ice.AREA + sh(ice.AREA, di=-1)) * p.stressFactor
        areaS = 0.5 * (ice.AREA + sh(ice.AREA, dj=-1)) * p.stressFactor
        fu_new = ((1.0 - areaW) * fu + areaW * windTauX
                  + stressDivX * p.stressFactor)
        fv_new = ((1.0 - areaS) * fv + areaS * windTauY
                  + stressDivY * p.stressFactor)
        return self.fill_uv(fu_new, fv_new, impl)

    # ------------------------------------------------------------------
    # kernel seaice_lsr_prep's twin: one Picard pass's assembly
    # (seaice.py:912-972 with strainrates :513, viscosities :540,
    # oceandrag :593, _lsr_rhs_u/_v :609/:633, _lsr_coeffs :654). On the
    # Cartesian grid the metric factors k1/k2 are 0, and no-slip and the
    # implicit stress coupling are refused, so their terms are left out
    # (each added 0).
    # ------------------------------------------------------------------
    def _visc_plain(self, uC, vC, press0, zMax):
        """Launch 1: eta, zeta and press at C points."""
        p, g, hm = self.p, self.grid, self.HEFFM
        dudx = g.recip_dxF * (sh(uC, di=1) - uC)
        dvdy = g.recip_dyF * (sh(vC, dj=1) - vC)
        e11, e22 = dudx, dvdy
        dudy = (uC - sh(uC, dj=-1)) * g.recip_dyU
        dvdx = (vC - sh(vC, di=-1)) * g.recip_dxV
        hm4 = hm * sh(hm, di=-1) * sh(hm, dj=-1) * sh(sh(hm, di=-1), dj=-1)
        e12 = 0.5 * (dudy + dvdx) * hm4
        recip_e2 = 1.0 / (p.eccen * p.eccen)
        rze = g.rAz * (e12 * e12)
        e12Csq = 0.25 * g.recip_rA * (rze + sh(rze, di=1) + sh(rze, dj=1)
                                      + sh(sh(rze, di=1), dj=1))
        ep = e11 + e22
        em = e11 - e22
        shearDefSq = em * em + 4.0 * e12Csq
        deltaC = torch.sqrt(ep * ep + recip_e2 * shearDefSq)
        deltaCreg = _max(deltaC, p.deltaMin)
        tns = 0.0
        zeta = 0.5 * press0 * (1.0 + tns) / deltaCreg
        zeta = _min(zMax, zeta)
        zeta = _max(p.zetaMin, zeta)
        zeta = zeta * hm
        press = (press0 * (1.0 - p.pressReplFac)
                 + _div(2.0 * zeta * deltaC * p.pressReplFac, 1.0 + tns)
                 ) * (1.0 - tns)
        eta = zeta * recip_e2
        return eta, zeta, press

    def _etaZ(self, eta):
        hm = self.HEFFM
        sumNorm = hm + sh(hm, di=-1) + sh(hm, dj=-1) + sh(sh(hm, di=-1),
                                                          dj=-1)
        sumNorm = _where(sumNorm > 0.0,
                         _rdiv(1.0, _where(sumNorm > 0.0, sumNorm, 1.0)), 0.0)
        etaZ = sumNorm * (eta + sh(eta, di=-1) + sh(eta, dj=-1)
                          + sh(sh(eta, di=-1), dj=-1))
        maskZ = hm * sh(hm, di=-1) * sh(hm, dj=-1) * sh(sh(hm, di=-1), dj=-1)
        return etaZ * maskZ

    def oceandrag(self, uIceC, vIceC, uVel0, vVel0):
        """seaice_oceandrag_coeffs.F: the quadratic ice-ocean drag DWATN."""
        p, g = self.p, self.grid
        rho = self.cfg.rhoConst
        du = (uIceC - uVel0) * g.maskInW
        dv = (vIceC - vVel0) * g.maskInS
        a = du + sh(du, di=1)
        b = dv + sh(dv, dj=1)
        tempVar = 0.25 * (a * a + b * b)
        dragCoeff = _where(g.yC < 0.0, p.waterDrag_south * rho,
                           p.waterDrag * rho, like=g.yC)
        cw = _where(dragCoeff * dragCoeff * tempVar > p.dWatMin * p.dWatMin,
                    dragCoeff * torch.sqrt(tempVar), p.dWatMin)
        return cw * self.HEFFM

    def _coeffs_plain(self, eta, zeta, press, uIce, vIce, uIceC, vIceC,
                      uVel0, vVel0, fxTmp, fyTmp, areaW, areaS, massC, massU,
                      massV):
        """Launch 2: the ten coefficient fields, rhsU/V and dwatn."""
        p, g, hm = self.p, self.grid, self.HEFFM
        sinwat = math.sin(math.radians(p.waterTurnAngle))
        coswat = math.cos(math.radians(p.waterTurnAngle))
        recip_dt = 1.0 / p.deltaTdyn
        sgn = _sgn(g.fCori)
        etaZ = self._etaZ(eta)
        dwatn = self.oceandrag(uIceC, vIceC, uVel0, vVel0)
        epz = eta + zeta
        zme = zeta - eta
        dragSym = dwatn * coswat
        dvC = vVel0 - vIceC
        frcU = (fxTmp
                + (0.5 * (dwatn + sh(dwatn, di=-1)) * coswat * uVel0
                   - sgn * sinwat * 0.5
                   * (dwatn * 0.5 * (dvC + sh(dvC, dj=1))
                      + sh(dwatn, di=-1) * 0.5
                      * (sh(dvC, di=-1) + sh(sh(dvC, dj=1), di=-1)))
                   ) * areaW)
        duC = uVel0 - uIceC
        frcV = (fyTmp
                + (0.5 * (dwatn + sh(dwatn, dj=-1)) * coswat * vVel0
                   + sgn * sinwat * 0.5
                   * (dwatn * 0.5 * (duC + sh(duC, di=1))
                      + sh(dwatn, dj=-1) * 0.5
                      * (sh(duC, dj=-1) + sh(sh(duC, di=1), dj=-1)))
                   ) * areaS)
        mfv = massC * g.fCori * (0.5 * (vIceC + sh(vIceC, dj=1)))
        frcU = frcU + 0.5 * (mfv + sh(mfv, di=-1))
        mfu = massC * g.fCori * (0.5 * (uIceC + sh(uIceC, di=1)))
        frcV = frcV - 0.5 * (mfu + sh(mfu, dj=-1))
        mU, mV = self.seaiceMaskU, self.seaiceMaskV
        frcU = frcU * mU
        frcV = frcV * mV
        hm4 = hm * sh(hm, di=-1) * sh(hm, dj=-1) * sh(sh(hm, di=-1), dj=-1)
        # _lsr_rhs_u: the divergence of the stress of (uIceC, vIceC)
        sig11 = zme * (sh(vIceC, dj=1) - vIceC) * g.recip_dyF - 0.5 * press
        vs = vIceC + sh(vIceC, di=-1)
        sig12 = (etaZ * ((vIceC - sh(vIceC, di=-1)) * g.recip_dxV) * hm4
                 + etaZ * g.recip_dxV * vs * (mV - sh(mV, di=-1)) * 2.0)
        a11, a12 = g.dyF * sig11, g.dxV * sig12
        rhsU = frcU + g.recip_rAw * mU * (a11 - sh(a11, di=-1)
                                          + sh(a12, dj=1) - a12)
        sig22 = zme * (sh(uIceC, di=1) - uIceC) * g.recip_dxF - 0.5 * press
        us = uIceC + sh(uIceC, dj=-1)
        sig12 = (etaZ * ((uIceC - sh(uIceC, dj=-1)) * g.recip_dyU) * hm4
                 + etaZ * g.recip_dyU * us * (mU - sh(mU, dj=-1)) * 2.0)
        b12, b22 = g.dyU * sig12, g.dxF * sig22
        rhsV = frcV + g.recip_rAs * mV * (sh(b12, di=1) - b12 + b22
                                          - sh(b22, dj=-1))
        # _lsr_coeffs
        UXX = g.dyF * epz * g.recip_dxF
        UYY = g.dxV * etaZ * g.recip_dyU
        VXX = g.dyU * etaZ * g.recip_dxV
        VYY = g.dxF * epz * g.recip_dyF
        AU = -sh(UXX, di=-1) * mU
        CU = -UXX * mU
        BU = (1.0 - mU) + (sh(UXX, di=-1) + UXX + sh(UYY, dj=1) + UYY) * mU
        hFacMu, hFacPu = sh(mU, dj=-1), sh(mU, dj=1)
        BU = BU + mU * ((1.0 - hFacMu) * UYY + (1.0 - hFacPu) * sh(UYY, dj=1))
        uRt1 = UYY * hFacMu * g.recip_rAw
        uRt2 = sh(UYY, dj=1) * hFacPu * g.recip_rAw
        AU = AU * g.recip_rAw
        CU = CU * g.recip_rAw
        BU = (BU * g.recip_rAw
              + mU * (recip_dt * massU
                      + 0.5 * (dragSym + sh(dragSym, di=-1)) * areaW))
        AV = -sh(VYY, dj=-1) * mV
        CV = -VYY * mV
        BV = (1.0 - mV) + (VXX + sh(VXX, di=1) + VYY + sh(VYY, dj=-1)) * mV
        hFacMv, hFacPv = sh(mV, di=-1), sh(mV, di=1)
        BV = BV + mV * ((1.0 - hFacMv) * VXX + (1.0 - hFacPv) * sh(VXX, di=1))
        vRt1 = VXX * hFacMv * g.recip_rAs
        vRt2 = sh(VXX, di=1) * hFacPv * g.recip_rAs
        AV = AV * g.recip_rAs
        CV = CV * g.recip_rAs
        BV = (BV * g.recip_rAs
              + mV * (recip_dt * massV
                      + 0.5 * (dragSym + sh(dragSym, dj=-1)) * areaS))
        # the open-boundary / land closure (seaice_lsr.F:409-432) and the
        # zero-diagonal guard (:1558-1572)
        mIn = g.maskInC
        z, o = hm.new_tensor(0.0), hm.new_tensor(1.0)
        badU = mIn * sh(mIn, di=-1) == 0.0
        badV = mIn * sh(mIn, dj=-1) == 0.0
        out = {"AU": torch.where(badU, z, AU), "BU": torch.where(badU, o, BU),
               "CU": torch.where(badU, z, CU),
               "uRt1": torch.where(badU, z, uRt1),
               "uRt2": torch.where(badU, z, uRt2),
               "rhsU": torch.where(badU, uIce, rhsU),
               "AV": torch.where(badV, z, AV), "BV": torch.where(badV, o, BV),
               "CV": torch.where(badV, z, CV),
               "vRt1": torch.where(badV, z, vRt1),
               "vRt2": torch.where(badV, z, vRt2),
               "rhsV": torch.where(badV, vIce, rhsV), "dwatn": dwatn}
        if p.scaleSurfStress:
            out["BU"] = torch.where(out["BU"] == 0.0, o, out["BU"])
            out["BV"] = torch.where(out["BV"] == 0.0, o, out["BV"])
        return out

    def lsr_prep(self, uIce, vIce, uIceC, vIceC, uVel0, vVel0, press0, zMax,
                 fxTmp, fyTmp, areaW, areaS, massC, massU, massV,
                 impl: str = None) -> dict:
        """One Picard pass's assembly (seaice.py:912-972): the dict of AU,
        BU, CU, AV, BV, CV, uRt1, uRt2, vRt1, vRt2, rhsU, rhsV and dwatn;
        kernel seaice_lsr_prep (seaice_lsr_visc, then seaice_lsr_coeffs)
        on CUDA tensors, its twin on CPU tensors or with impl="plain"."""
        seaice_kernels.refuse_grad(
            "seaice_lsr_prep", uIce=uIce, vIce=vIce, uIceC=uIceC,
            vIceC=vIceC, uVel0=uVel0, vVel0=vVel0, press0=press0, zMax=zMax,
            fxTmp=fxTmp, fyTmp=fyTmp, areaW=areaW, areaS=areaS, massC=massC,
            massU=massU, massV=massV)
        if not kernels.use_kernel(uIce, impl):
            global plain_calls
            plain_calls += 1
            eta, zeta, press = self._visc_plain(uIceC, vIceC, press0, zMax)
            return self._coeffs_plain(eta, zeta, press, uIce, vIce, uIceC,
                                      vIceC, uVel0, vVel0, fxTmp, fyTmp,
                                      areaW, areaS, massC, massU, massV)
        return seaice_kernels.lsr_prep(
            self, uIce, vIce, uIceC, vIceC, uVel0, vVel0, press0, zMax,
            fxTmp, fyTmp, areaW, areaS, massC, massU, massV)

    # ------------------------------------------------------------------
    # kernel seaice_lsr_tridiag's twin: the zebra line solves
    # (seaice.py:713-874) and the linear loop (:991-1056)
    # ------------------------------------------------------------------
    def _tiles(self, a):
        """[nTiles, sNy + 2 ol, sNx + 2 ol] views of a padded field."""
        return a[self._trows[:, :, None], self._tcols[:, None, :]]

    def _untile(self, tiles, a):
        """a with its interior from the tiles' interiors (a new tensor)."""
        cfg, ol = self.cfg, self.ol
        t = tiles[:, ol:ol + cfg.sNy, ol:ol + cfg.sNx]
        inner = (t.reshape(cfg.nSy, cfg.nSx, cfg.sNy, cfg.sNx)
                 .permute(0, 2, 1, 3).reshape(self.ny, self.nx))
        out = a.clone()
        out[ol:ol + self.ny, ol:ol + self.nx] = inner
        return out

    @staticmethod
    def _tridiag_rows(A, B, C, rhs):
        """The Thomas solve along the last axis in seaice.py:_tridiag_rows'
        order: cuu = c / bet, urt = (r - a urt_m) / bet, x = urt - cuu x_p."""
        n = rhs.shape[-1]
        cuu = [C[..., 0] / B[..., 0]]
        urt = [rhs[..., 0] / B[..., 0]]
        for i in range(1, n):
            bet = B[..., i] - A[..., i] * cuu[-1]
            cuu.append(C[..., i] / bet)
            urt.append((rhs[..., i] - A[..., i] * urt[-1]) / bet)
        x = [urt[-1]]
        for i in range(n - 2, -1, -1):
            x.append(urt[i] - cuu[i] * x[-1])
        return torch.stack(x[::-1], dim=-1)

    def _half_sweep_plain(self, along_x: bool, k: int, c: dict, u, uTmp,
                          wfa):
        """One half-sweep of _tridiagU (along_x) or _tridiagV on the lines
        of parity k, in place on u's interior: each tile reads its own
        interior from u and its halo from uTmp (the values at the
        iteration's entry)."""
        cfg, ol = self.cfg, self.ol
        sNy, sNx = cfg.sNy, cfg.sNx
        sfx = "U" if along_x else "V"
        uT = self._tiles(uTmp)
        uT[:, ol:ol + sNy, ol:ol + sNx] = \
            self._tiles(u)[:, ol:ol + sNy, ol:ol + sNx]
        tT = self._tiles(uTmp)
        AT, BT, CT = (self._tiles(c[f"{n}{sfx}"]) for n in "ABC")
        r1T = self._tiles(c[f"{sfx.lower()}Rt1"])
        r2T = self._tiles(c[f"{sfx.lower()}Rt2"])
        rT = self._tiles(c[f"rhs{sfx}"])
        mT = self._tiles(self.seaiceMaskU if along_x else self.seaiceMaskV)
        if not along_x:      # lines along y: swap the tile axes
            uT, tT, AT, BT, CT, r1T, r2T, rT, mT = (
                a.transpose(1, 2) for a in (uT, tT, AT, BT, CT, r1T, r2T, rT,
                                            mT))
            sNy, sNx = sNx, sNy
        ii = slice(ol, ol + sNx)
        rows = slice(ol + k, ol + sNy, 2)
        jm1 = slice(ol + k - 1, ol + sNy - 1, 2)
        jp1 = slice(ol + k + 1, ol + sNy + 1, 2)
        urt = (rT[:, rows, ii] + r1T[:, rows, ii] * uT[:, jm1, ii]
               + r2T[:, rows, ii] * uT[:, jp1, ii])
        urt[:, :, 0] = urt[:, :, 0] + (-AT[:, rows, ol]) * uT[:, rows, ol - 1]
        cT = -CT[:, rows, ol + sNx - 1]
        urt[:, :, -1] = urt[:, :, -1] + cT * uT[:, rows, ol + sNx]
        urt = urt * mT[:, rows, ii]
        x = self._tridiag_rows(AT[:, rows, ii], BT[:, rows, ii],
                               CT[:, rows, ii], urt)
        uT[:, rows, ii] = tT[:, rows, ii] + wfa * (x - tT[:, rows, ii])
        if not along_x:
            uT = uT.transpose(1, 2)
        u.copy_(self._untile(uT, u))

    def lsr_sweep(self, along_x: bool, k: int, c: dict, u, uTmp, ctrl, wf,
                  ws, impl: str = None) -> None:
        """Half-sweep k of the U (along_x) or V line solves, in place on u;
        does nothing while the loop is done (ctrl[0]) or the component has
        stopped (ctrl[2] for U, ctrl[3] for V). ctrl: int32 [done, m, it4u,
        it4v, ICOUNT1, ICOUNT2]; wf: [WFAU, WFAV, S1A, S2A]; ws: the loop's
        seaice_kernels.Workspace on the card (None on the plain path)."""
        seaice_kernels.refuse_grad("seaice_lsr_tridiag", **c, u=u, uTmp=uTmp,
                                   wf=wf)
        if not kernels.use_kernel(u, impl):
            global plain_calls
            plain_calls += 1
            if int(ctrl[0]) or not int(ctrl[2 if along_x else 3]):
                return
            self._half_sweep_plain(along_x, k, c, u, uTmp,
                                   wf[0 if along_x else 1])
            return
        seaice_kernels.lsr_sweep(self, along_x, k, c, u, uTmp, ctrl, wf,
                                 ws.cuu)

    def _check_plain(self, u, v, uTmp, vTmp, ctrl, wf):
        p = self.p
        if int(ctrl[0]):
            return
        m = int(ctrl[1]) + 1
        it4u, it4v = bool(ctrl[2]), bool(ctrl[3])
        chk = m % p.SOLV_NCHECK == 0
        err = u.new_tensor(p.LSR_ERROR)
        for c, (x, xt, mk) in enumerate(((u, uTmp, self.seaiceMaskU),
                                         (v, vTmp, self.seaiceMaskV))):
            if not (chk and (it4u, it4v)[c]):
                continue
            s = torch.max(torch.abs((x - xt) * mk) * self.interior)
            if m > 1 and bool(s > wf[2 + c]):
                wf[c] = 0.0
            wf[2 + c] = s
            if bool(s < err):
                ctrl[4 + c] = m
                ctrl[2 + c] = 0
        ctrl[1] = m
        ctrl[0] = int(not (m < p.linearIterMax
                           and (bool(ctrl[2]) or bool(ctrl[3]))))
        u.copy_(self.fill(u, "plain"))
        v.copy_(self.fill(v, "plain"))
        uTmp.copy_(u)
        vTmp.copy_(v)

    def lsr_check(self, u, v, uTmp, vTmp, ctrl, wf, ws,
                  impl: str = None) -> None:
        """The end of one linear iteration (seaice.py:1020-1044), in place:
        m += 1; every SOLV_NCHECK iterations the masked interior max of
        |u - uTmp| (S1) and |v - vTmp| (S2) for each component still
        iterating, the WFAU/WFAV freeze when it grew, the stop under
        LSR_ERROR with ICOUNT1/2; done when m reaches linearIterMax or both
        stopped; then the halo fill of u and v, and uTmp, vTmp := u, v."""
        seaice_kernels.refuse_grad("seaice_lsr_check", u=u, v=v, uTmp=uTmp,
                                   vTmp=vTmp, wf=wf)
        if not kernels.use_kernel(u, impl):
            global plain_calls
            plain_calls += 1
            self._check_plain(u, v, uTmp, vTmp, ctrl, wf)
            return
        seaice_kernels.lsr_check(self, u, v, uTmp, vTmp, ctrl, wf, ws)

    def lsr_iterate(self, c: dict, uIce, vIce, impl: str = None):
        """The linear m-loop (seaice.py:_lsr_iterate): (u, v, (ICOUNT1,
        ICOUNT2), host syncs). On the kernel path the host enqueues BATCH
        iterations (four half-sweeps and a check each) and reads the
        control words once per batch; every launch after `done` returns at
        once, so the result and the counts are those of stopping at once.
        The plain path reads them every iteration, as JAX's loop tests its
        condition."""
        p = self.p
        u, v = uIce.clone(), vIce.clone()
        uTmp, vTmp = u.clone(), v.clone()
        ctrl = torch.tensor([0, 0, 1, 1, p.linearIterMax, p.linearIterMax],
                            dtype=torch.int32, device=u.device)
        wf = torch.tensor([p.LSRrelaxU, p.LSRrelaxV, 0.8, 0.8],
                          dtype=u.dtype, device=u.device)
        on_card = kernels.use_kernel(u, impl)
        ws = None
        if on_card:
            ws = seaice_kernels.Workspace(self, u)

        def iterate():
            for along_x, x, xt in ((True, u, uTmp), (False, v, vTmp)):
                for k in (0, 1):
                    self.lsr_sweep(along_x, k, c, x, xt, ctrl, wf, ws, impl)
            self.lsr_check(u, v, uTmp, vTmp, ctrl, wf, ws, impl)

        syncs = 0
        while True:
            for _ in range(BATCH if on_card else 1):
                iterate()
            state = ctrl.tolist()
            syncs += 1
            if state[0]:
                break
        return u, v, (state[4], state[5]), syncs

    def lsr(self, ice: IceState, uVel0, vVel0, press0, zMax, massC, massU,
            massV, forcex0, forcey0, impl: str = None):
        """SEAICE_LSR (seaice.py:876): the Picard passes around the linear
        loop. Returns (uIce, vIce, dwatn, [(ICOUNT1, ICOUNT2) per pass],
        [host syncs per pass])."""
        p = self.p
        recip_dt = 1.0 / p.deltaTdyn
        uIce, vIce = ice.uIce, ice.vIce
        uNm1, vNm1 = uIce, vIce
        fxTmp = forcex0 + massU * recip_dt * uNm1
        fyTmp = forcey0 + massV * recip_dt * vNm1
        if p.scaleSurfStress:
            areaW = 0.5 * (ice.AREA + sh(ice.AREA, di=-1))
            areaS = 0.5 * (ice.AREA + sh(ice.AREA, dj=-1))
        else:
            areaW = torch.ones_like(uIce)
            areaS = torch.ones_like(uIce)
        uIceC, vIceC = uIce, vIce
        counts, syncs = [], []
        for ipass in range(1, p.nonLinIterMax + 1):
            if ipass == 1:
                uIceC, vIceC = uIce, vIce
            elif ipass == 2 and p.nonLinIterMax <= 2:
                uIce = 0.5 * (uIce + uNm1)
                vIce = 0.5 * (vIce + vNm1)
                uIceC, vIceC = uIce, vIce
            else:
                uIceC = 0.5 * (uIce + uIceC)
                vIceC = 0.5 * (vIce + vIceC)
            c = self.lsr_prep(uIce, vIce, uIceC, vIceC, uVel0, vVel0, press0,
                              zMax, fxTmp, fyTmp, areaW, areaS, massC, massU,
                              massV, impl=impl)
            uIce, vIce, icount, n = self.lsr_iterate(c, uIce, vIce, impl)
            counts.append(icount)
            syncs.append(n)
        uIce, vIce = uIce * self.seaiceMaskU, vIce * self.seaiceMaskV
        if p.clipVelocities:
            uIce, vIce = self.clip(uIce, vIce)
        uIce, vIce = self.fill_uv(uIce, vIce, impl)
        return uIce, vIce, c["dwatn"], counts, syncs

    @staticmethod
    def clip(uIce, vIce):
        """SEAICE_clipVelocities (seaice_dynsolver.F:387-405): the ice
        velocity capped at 0.40 m/s against the CFL violations of thin
        drifting ice."""
        return uIce.clamp(-0.40, 0.40), vIce.clamp(-0.40, 0.40)

    # ------------------------------------------------------------------
    # kernel seaice_evp's twins: one EVP subcycle (seaice.py:1114-1227) in
    # two launches, because the Z-point stress sigma12 reads zeta and alpha
    # at four C points that one launch would be computing at the same time.
    # Every shifted read is the JAX code's zero-filled shift over the whole
    # padded array, and every division is tensor by tensor, so the kernels
    # can equal the twins bit for bit. On the Cartesian grid the metric
    # factors are 0 and no-slip is refused, so the strain rates' metric and
    # no-slip terms are left out (each added 0).
    # ------------------------------------------------------------------
    def _evp_factors(self):
        """The EVP variant's constants (seaice.py:1078-1093)."""
        p = self.p
        adaptive = p.aEVPcoeff > 0.0
        ecc2 = p.eccen * p.eccen
        recip_ecc2 = 1.0 / ecc2
        if p.useEVPrev:
            rev, star, recip_rev = 1.0, 1.0, recip_ecc2
        else:
            rev, recip_rev = 0.0, 1.0
            star = 1.0 if p.useEVPstar else 0.0
        cfac = (p.deltaTdyn * p.aEVPcStar * (p.aEVPcoeff * math.pi) ** 2
                if adaptive else 0.0)
        return types.SimpleNamespace(
            adaptive=adaptive, ecc2=ecc2, recip_ecc2=recip_ecc2, rev=rev,
            star=star, recip_rev=recip_rev, cfac=cfac,
            # the denominators alpha (revised or adaptive) or alpha + 1,
            # alpha + e^2 (seaice.py:1151-1164)
            rev_den=p.useEVPrev or adaptive)

    def evp_setup(self, ice: IceState, massU, massV) -> dict:
        """The per-step set-up of SeaIce.evp (seaice.py:1094-1112), plain
        glue: sumNorm at Z points, areaW/areaS and the masks of the cells
        that carry ice mass."""
        p, hm = self.p, self.HEFFM
        sumNorm = hm + sh(hm, di=-1) + sh(hm, dj=-1) + sh(sh(hm, di=-1),
                                                          dj=-1)
        sumNorm = _where(sumNorm > 0.0,
                         _rdiv(1.0, _where(sumNorm > 0.0, sumNorm, 1.0)), 0.0)
        if p.scaleSurfStress:
            areaW = 0.5 * (ice.AREA + sh(ice.AREA, di=-1))
            areaS = 0.5 * (ice.AREA + sh(ice.AREA, dj=-1))
        else:
            areaW = torch.ones_like(ice.uIce)
            areaS = torch.ones_like(ice.uIce)
        return {"sumNorm": sumNorm, "areaW": areaW, "areaS": areaS,
                "locMaskU": _where(massU != 0.0, 1.0, 0.0, like=massU),
                "locMaskV": _where(massV != 0.0, 1.0, 0.0, like=massV)}

    def _e12(self, u, v):
        """The shear strain rate at Z points (seaice.py:strainrates)."""
        g, hm = self.grid, self.HEFFM
        dudy = (u - sh(u, dj=-1)) * g.recip_dyU
        dvdx = (v - sh(v, di=-1)) * g.recip_dxV
        hm4 = hm * sh(hm, di=-1) * sh(hm, dj=-1) * sh(sh(hm, di=-1), dj=-1)
        return 0.5 * (dudy + dvdx) * hm4

    def _evp_stress_plain(self, u, v, s1, s2, press0, massC):
        """Launch (a): zeta, alpha and the new sigma1, sigma2 at C points
        (seaice.py:1116-1157): (s1, s2, zetaC, alphaC)."""
        p, g, hm = self.p, self.grid, self.HEFFM
        k = self._evp_factors()
        e11 = g.recip_dxF * (sh(u, di=1) - u)
        e22 = g.recip_dyF * (sh(v, dj=1) - v)
        e12 = self._e12(u, v)
        ep = e11 + e22
        em = e11 - e22
        rze = g.rAz * e12 * e12
        e12Csq = 0.25 * g.recip_rA * (rze + sh(rze, di=1) + sh(rze, dj=1)
                                      + sh(sh(rze, di=1), dj=1))
        deltaSq = ep * ep + k.recip_ecc2 * (em * em + 4.0 * e12Csq)
        deltaC = torch.sqrt(deltaSq)
        zetaC = 0.5 * press0 / _max(deltaC, p.deltaMin)
        if k.adaptive:
            alphaC = torch.sqrt(zetaC * k.cfac / _max(massC, 1.0e-4)
                                * g.recip_rA) * hm
            alphaC = _max(alphaC, p.aEVPalphaMin)
        else:
            alphaC = torch.full_like(press0, p.evpAlpha)
        pressC = (press0 * (1.0 - p.pressReplFac)
                  + 2.0 * zetaC * deltaC * p.pressReplFac)
        seaice_div = (2.0 * zetaC * ep - pressC) * hm
        seaice_tension = 2.0 * zetaC * em * hm
        den1 = alphaC if k.rev_den else alphaC + 1.0
        den2 = alphaC if k.rev_den else alphaC + k.ecc2
        s1 = (s1 * (alphaC - k.rev) + seaice_div) / den1 * hm
        s2 = (s2 * (alphaC - k.rev) + seaice_tension * k.recip_rev) / den2 * hm
        return s1, s2, zetaC, alphaC

    def _evp_uv_plain(self, u, v, s12, s1, s2, zetaC, alphaC, uNm1, vNm1,
                      uVel0, vVel0, forcex0, forcey0, massC, massU, massV,
                      setup: dict):
        """Launch (b): sigma12 at Z points, the stress divergence, the ocean
        drag, the forcing and the implicit velocity update with its halo
        fill (seaice.py:1158-1227): (u, v, s12, dwatn, divX, divY); divX
        and divY are the post-loop divergence (:1235-1242) when these are
        the last subcycle's stresses."""
        p, g, hm = self.p, self.grid, self.HEFFM
        k = self._evp_factors()
        recip_dt = 1.0 / p.deltaTdyn
        sinwat = math.sin(math.radians(p.waterTurnAngle))
        coswat = math.cos(math.radians(p.waterTurnAngle))
        areaW, areaS = setup["areaW"], setup["areaS"]
        zetaZ = setup["sumNorm"] * (zetaC + sh(zetaC, di=-1)
                                    + sh(zetaC, dj=-1)
                                    + sh(sh(zetaC, di=-1), dj=-1))
        seaice_shear = 2.0 * zetaZ * self._e12(u, v)
        alphaZ = 0.25 * (alphaC + sh(alphaC, di=-1) + sh(alphaC, dj=-1)
                         + sh(sh(alphaC, di=-1), dj=-1))
        den12 = alphaZ if k.rev_den else alphaZ + k.ecc2
        s12 = (s12 * (alphaZ - k.rev) + seaice_shear * k.recip_rev) / den12
        t11 = 0.5 * (s1 + s2) * g.dyF
        t12x = s12 * g.dxV
        divX = (t11 - sh(t11, di=-1) + sh(t12x, dj=1) - t12x) * g.recip_rAw
        t22 = 0.5 * (s1 - s2) * g.dxF
        t12y = s12 * g.dyU
        divY = (t22 - sh(t22, dj=-1) + sh(t12y, di=1) - t12y) * g.recip_rAs
        dwatn = self.oceandrag(u, v, uVel0, vVel0)
        dwU = 0.5 * (dwatn + sh(dwatn, di=-1))
        dwV = 0.5 * (dwatn + sh(dwatn, dj=-1))
        sgn = _sgn(g.fCori)
        dv = vVel0 - v
        frcU = forcex0 + (
            dwU * coswat * uVel0
            - sgn * sinwat * 0.5
            * (dwatn * 0.5 * (dv + sh(dv, dj=1))
               + sh(dwatn, di=-1) * 0.5
               * (sh(dv, di=-1) + sh(sh(dv, dj=1), di=-1)))
            * setup["locMaskU"]) * areaW
        du = uVel0 - u
        frcV = forcey0 + (
            dwV * coswat * vVel0
            + sgn * sinwat * 0.5
            * (dwatn * 0.5 * (du + sh(du, di=1))
               + sh(dwatn, dj=-1) * 0.5
               * (sh(du, dj=-1) + sh(sh(du, di=1), dj=-1)))
            * setup["locMaskV"]) * areaS
        mfv = massC * g.fCori * 0.5 * (v + sh(v, dj=1))
        frcU = frcU + 0.5 * (mfv + sh(mfv, di=-1))
        mfu = massC * g.fCori * 0.5 * (u + sh(u, di=1))
        frcV = frcV - 0.5 * (mfu + sh(mfu, dj=-1))
        if k.adaptive:
            betaU = 0.5 * (alphaC + sh(alphaC, di=-1))
            betaV = 0.5 * (alphaC + sh(alphaC, dj=-1))
        else:
            betaU = betaV = torch.full_like(alphaC, p.evpBeta)
        betaFacU = betaU * recip_dt
        betaFacV = betaV * recip_dt
        denomU = massU * (betaFacU + k.star * recip_dt) + dwU * coswat * areaW
        denomV = massV * (betaFacV + k.star * recip_dt) + dwV * coswat * areaS
        denomU = _where(denomU == 0.0, 1.0, denomU)
        denomV = _where(denomV == 0.0, 1.0, denomV)
        u_new = self.seaiceMaskU * (
            massU * betaFacU * u + massU * recip_dt * k.star * uNm1
            + frcU + divX) / denomU
        v_new = self.seaiceMaskV * (
            massV * betaFacV * v + massV * recip_dt * k.star * vNm1
            + frcV + divY) / denomV
        u_new, v_new = self.fill_uv(u_new, v_new, "plain")
        return u_new, v_new, s12, dwatn, divX, divY

    def evp(self, ice: IceState, uVel0, vVel0, press0, massC, massU, massV,
            forcex0, forcey0, impl: str = None):
        """SEAICE_EVP (seaice.py:evp, :1059): nEVPstarSteps subcycles of
        the (adaptive) elastic-viscous-plastic stresses and the explicit
        velocity update, from ice.sigma. Returns (uIce, vIce, dwatn, sigma
        [3, nyp, nxp], stressDivX, stressDivY). On the card the whole loop
        is enqueued at once, kernel seaice_evp's two launches a subcycle,
        with no host read (seaice_kernels.evp_loop); for CPU tensors or
        with impl="plain" the twins of the two launches run the loop."""
        setup = self.evp_setup(ice, massU, massV)
        sig = ice.sigma
        if sig.shape[0] != 3:
            sig = ice.uIce.new_zeros((3,) + tuple(ice.uIce.shape))
        u, v, s1, s2, s12 = ice.uIce, ice.vIce, sig[0], sig[1], sig[2]
        fixed = dict(uNm1=ice.uIce, vNm1=ice.vIce, uVel0=uVel0, vVel0=vVel0,
                     forcex0=forcex0, forcey0=forcey0, massC=massC,
                     massU=massU, massV=massV)
        seaice_kernels.refuse_grad("seaice_evp", **fixed, press0=press0,
                                   sigma=sig, **setup)
        args = (u, v, s1, s2, s12, press0, fixed, setup,
                self.p.nEVPstarSteps)
        if kernels.use_kernel(u, impl):
            return seaice_kernels.evp_loop(self, *args)
        return self._evp_loop_plain(*args)

    def _evp_loop_plain(self, u, v, s1, s2, s12, press0, fixed: dict,
                        setup: dict, n: int):
        """The twin of seaice_kernels.evp_loop (its arguments but the
        SeaIce): n subcycles of the two launches' twins."""
        global plain_calls
        plain_calls += 1
        for _ in range(n):
            s1, s2, zetaC, alphaC = self._evp_stress_plain(
                u, v, s1, s2, press0, fixed["massC"])
            u, v, s12, dwatn, divX, divY = self._evp_uv_plain(
                u, v, s12, s1, s2, zetaC, alphaC, *fixed.values(), setup)
        return u, v, dwatn, torch.stack([s1, s2, s12]), divX, divY

    # ------------------------------------------------------------------
    # kernel seaice_freedrift's twin (seaice.py:1246-1286)
    # ------------------------------------------------------------------
    def _freedrift_plain(self, heff, uVel0, vVel0, forcex0, forcey0):
        p, g = self.p, self.grid
        taux_c = 0.5 * (forcex0 + sh(forcex0, di=1))
        tauy_c = 0.5 * (forcey0 + sh(forcey0, dj=1))
        mIceCor = p.rhoIce * heff * g.fCori
        u_c = 0.5 * (uVel0 + sh(uVel0, di=1))
        v_c = 0.5 * (vVel0 + sh(vVel0, dj=1))
        rhs_x = -taux_c - mIceCor * v_c
        rhs_y = -tauy_c + mIceCor * u_c
        nsq = rhs_x * rhs_x + rhs_y * rhs_y
        pos = nsq > 0.0
        rhs_n = _where(pos, torch.sqrt(_where(pos, nsq, 1.0)), 0.0)
        rhs_a = _where(pos, torch.atan2(rhs_y, rhs_x), 0.0)
        rhoConst = self.cfg.rhoConst
        wDrag = _where(g.yC < 0.0, p.waterDrag_south, p.waterDrag, like=heff)
        inv = _rdiv(1.0, rhoConst * wDrag)
        t2 = (inv * inv) * mIceCor * mIceCor
        t3 = (inv * inv) * rhs_n * rhs_n
        t4 = t2 * t2 + 4.0 * t3
        pos3 = t3 > 0.0
        sol_n = _where(pos3, torch.sqrt(
            0.5 * (torch.sqrt(_where(pos3, t4, 1.0)) - t2)), 0.0)
        c1 = wDrag * rhoConst
        s2 = c1 * sol_n * sol_n
        s3 = mIceCor * sol_n
        s4 = s2 * s2 + s3 * s3
        sol_a = _where(s4 > 0.0, rhs_a - torch.atan2(s3, s2), 0.0)
        uic = u_c - sol_n * torch.cos(sol_a)
        vic = v_c - sol_n * torch.sin(sol_a)
        uic, vic = self.fill_uv(uic, vic, "plain")
        uFD = 0.5 * (sh(uic, di=-1) + uic) * self.SIMaskU
        vFD = 0.5 * (sh(vic, dj=-1) + vic) * self.SIMaskV
        return self.fill_uv(uFD, vFD, "plain")

    def freedrift(self, ice: IceState, uVel0, vVel0, forcex0, forcey0,
                  impl: str = None):
        """seaice_freedrift.F (seaice.py:freedrift): the free-drift ice
        velocity (uIce, vIce), surface stress and Coriolis against the
        quadratic ocean drag, solved at C points and averaged to the
        velocity points, both fills included; kernel seaice_freedrift (one
        launch) on CUDA tensors, its twin on CPU tensors or with
        impl="plain"."""
        ins = dict(heff=ice.HEFF, uVel0=uVel0, vVel0=vVel0, forcex0=forcex0,
                   forcey0=forcey0)
        seaice_kernels.refuse_grad("seaice_freedrift", **ins)
        if not kernels.use_kernel(ice.HEFF, impl):
            global plain_calls
            plain_calls += 1
            return self._freedrift_plain(*ins.values())
        return seaice_kernels.freedrift(self, *ins.values())

    # ------------------------------------------------------------------
    # kernel seaice_advect's twin, its X and its Y launch: seaice_advdiff.F,
    # multidim, Cartesian (seaice.py:1474-1556 with _advect_field :1330 and
    # _diffuse_field :1350)
    # ------------------------------------------------------------------
    def _advect_x_plain(self, ice: IceState, flds):
        """Launch X: the X-updated fields (seaice.py:1340-1343)."""
        g, dt = self.grid, self.p.deltaTtherm
        uTrans = ice.uIce * (g.dyG * self.SIMaskU)
        out = []
        for fld in flds:
            af = gad.adv_flux_x(g, self.p.advSchHeff, uTrans, ice.uIce, fld,
                                dt, self.SIMaskU)
            out.append(fld - dt * self.maskInCx * g.recip_rA
                       * (sh(af, di=1) - af))
        return out

    def _advect_y_plain(self, ice: IceState, flds, localTs):
        """Launch Y: the Y update, the diffusion and the interior-only
        write (seaice.py:1344-1348, :1350-1357, :1510-1554)."""
        p, g = self.p, self.grid
        dt = p.deltaTtherm
        xA = g.dyG * self.SIMaskU
        yA = g.dxG * self.SIMaskV
        vTrans = ice.vIce * yA
        hm, mIn = self.HEFFM, self.maskInCx
        out = []
        for fld, localT, kh in zip(flds, localTs, (p.diffKhHeff, p.diffKhArea,
                                                   p.diffKhSnow)):
            af = gad.adv_flux_y(g, p.advSchHeff, vTrans, ice.vIce, localT,
                                dt, self.SIMaskV)
            localT = localT - dt * mIn * g.recip_rA * (sh(af, dj=1) - af)
            gFld = _div(localT - fld, dt)
            if kh > 0.0:
                fZon = -kh * xA * g.recip_dxC * (fld - sh(fld, di=-1))
                fMer = -kh * yA * g.recip_dyC * (fld - sh(fld, dj=-1))
                gFld = gFld + (-hm) * g.recip_rA * (
                    (sh(fZon, di=1) - fZon) + (sh(fMer, dj=1) - fMer))
            new = hm * (fld + dt * gFld)
            out.append(torch.where(self.interior > 0, new, fld))
        return out

    def advdiff(self, ice: IceState, impl: str = None) -> IceState:
        """HEFF, AREA and HSNOW advected (and diffused where diffKh > 0) by
        the ice velocity, interior cells only; kernel seaice_advect (an X
        and a Y launch, the three fields together) on CUDA tensors."""
        seaice_kernels.refuse_grad("seaice_advect", uIce=ice.uIce,
                                   vIce=ice.vIce, HEFF=ice.HEFF,
                                   AREA=ice.AREA, HSNOW=ice.HSNOW)
        if not kernels.use_kernel(ice.HEFF, impl):
            global plain_calls
            plain_calls += 1
            flds = (ice.HEFF, ice.AREA, ice.HSNOW)
            heff, area, hsnow = self._advect_y_plain(
                ice, flds, self._advect_x_plain(ice, flds))
        else:
            heff, area, hsnow = seaice_kernels.advect(self, ice)
        return ice._replace(HEFF=heff, AREA=area, HSNOW=hsnow)

    # ------------------------------------------------------------------
    # kernel seaice_thermo's twin: reg_ridge (seaice.py:1559), growth
    # (:1681) and solve4temp (:1592) for each category
    # ------------------------------------------------------------------
    def reg_ridge(self, ice: IceState):
        """seaice_reg_ridge.F: (ice', d_HEFFbyNEG, d_HSNWbyNEG)."""
        p, interior = self.p, self.interior
        inside = interior > 0
        heff, hsnow, area, tices = ice.HEFF, ice.HSNOW, ice.AREA, ice.TICES
        dHn = _max(-heff, 0.0) * interior
        heff = heff + dHn
        dSn = _max(-hsnow, 0.0) * interior
        hsnow = hsnow + dSn
        area = torch.where(inside, _max(area, 0.0), area)
        tiny = (heff <= 1.0e-5) & inside
        t1 = _where(tiny, -heff, 0.0)
        t2 = _where(tiny, -hsnow, 0.0)
        tices = _where(tiny[None], self.cfg.celsius2K, tices)
        heff = heff + t1
        hsnow = hsnow + t2
        dHn = dHn + t1
        dSn = dSn + t2
        area = _where((heff == 0.0) & (hsnow == 0.0) & inside, 0.0, area)
        some = ((heff > 0.0) | (hsnow > 0.0)) & inside
        area = torch.where(some, _max(area, p.area_floor), area)
        area = torch.where(inside, _min(area, p.area_max), area)
        return (ice._replace(HEFF=heff, HSNOW=hsnow, AREA=area,
                             TICES=tices), dHn, dSn)

    def solve4temp(self, UG, hice, hsnow, tsurf_in, forc, salt0):
        """seaice_solve4temp.F for one category: (tsurf, F_ia, IcePenetSW,
        FWsublim), 10 Newton iterations (IMAX_TICE) and the fluxes at the
        final temperature."""
        p, g = self.p, self.grid
        c2k = self.cfg.celsius2K
        lnTEN = math.log(10.0)
        aa1, aa2 = 2663.5, 12.537
        bb1 = 0.622
        bb2 = 1.0 - bb1
        Ppascals = 100000.0
        cc0 = math.exp(aa2 * lnTEN)
        cc1 = cc0 * aa1 * bb1 * Ppascals * lnTEN
        cc2 = cc0 * bb2
        D1 = p.dalton * p.cpAir * p.rhoAir
        lhSublim = p.lhEvap + p.lhFusion
        D1I = p.dalton * lhSublim * p.rhoAir
        TMELT = c2k
        XKI, XKS = p.iceConduct, p.snowConduct
        HCUT = p.snowThick
        recip_HCUT = 1.0 / HCUT
        SurfMeltTemp = TMELT + p.wetAlbTemp
        iceOrNot = hice > 0.0
        lwdownLoc = _max(p.MIN_LWDOWN, forc.lwdown)
        atempLoc = _max(c2k + p.MIN_ATEMP, forc.atemp)
        tempFrz = p.dTempFrz_dS * salt0 + p.tempFrz0 + c2k
        snowy = hsnow > 0.0
        emiss = _where(snowy, p.snow_emiss, p.ice_emiss, like=hsnow)
        D3 = emiss * p.boltzmann
        lwdownLoc = emiss * lwdownLoc
        south = g.yC < 0.0
        melt = tsurf_in >= SurfMeltTemp
        alb_ice = torch.where(
            south,
            _where(melt, p.wetIceAlb_south, p.dryIceAlb_south, like=hice),
            _where(melt, p.wetIceAlb, p.dryIceAlb, like=hice))
        alb_snow = torch.where(
            south, _where(melt, p.wetSnowAlb_south, p.drySnowAlb_south,
                          like=hice),
            _where(melt, p.wetSnowAlb, p.drySnowAlb, like=hice))
        alb = _min(alb_ice + hsnow * recip_HCUT * (alb_snow - alb_ice),
                   alb_snow)
        alb = torch.where(hsnow > HCUT, alb_snow, alb)
        penet = _where(snowy, 0.0, p.shortwave * torch.exp(-1.5 * hice))
        IcePenetSW = -(1.0 - alb) * penet * forc.swdown
        absorbedSW = (1.0 - alb) * (1.0 - penet) * forc.swdown
        effConduct = _where(iceOrNot, _rdiv(XKI * XKS, _max(
            XKS * hice + XKI * hsnow, 1e-30)), 0.0)

        def flux_terms(t1):
            t2 = t1 * t1
            t3 = t2 * t1
            t4 = t2 * t2
            mm_pi = torch.exp((_rdiv(-aa1, t1) + aa2) * lnTEN)
            qhice = bb1 * mm_pi / (Ppascals - (1.0 - bb1) * mm_pi)
            cc3t = torch.exp(_rdiv(aa1, t1) * lnTEN)
            d = cc2 - cc3t * Ppascals
            dqh_dTs = cc1 * cc3t / (d * d * t2)
            F_c = effConduct * (tempFrz - t1)
            F_lh = D1I * UG * (qhice - forc.aqh)
            F_lwu = t4 * D3
            F_sens = D1 * UG * (t1 - atempLoc)
            F_ia = -lwdownLoc - absorbedSW + F_lwu + F_sens + F_lh
            dFia_dTs = 4.0 * D3 * t3 + D1 * UG + D1I * UG * dqh_dTs
            return F_c, F_ia, F_lh, dFia_dTs

        tsurf = tsurf_in
        for _ in range(p.IMAX_TICE):
            F_c, F_ia, _F_lh, dFia = flux_terms(tsurf)
            delta = (F_c - F_ia) / (effConduct + dFia)
            tsurf = torch.where(iceOrNot, tsurf + delta, tsurf)
            tsurf = _min(tsurf, TMELT)
        F_c, F_ia, F_lh, _ = flux_terms(tsurf)
        tsurf_out = torch.where(iceOrNot, tsurf, tsurf_in)
        FWsublim = _where(iceOrNot, _div(F_lh, lhSublim), 0.0)
        F_ia = _where(iceOrNot, F_ia, 0.0)
        IcePenetSW = _where(iceOrNot, IcePenetSW, 0.0)
        return tsurf_out, F_ia, IcePenetSW, FWsublim

    def growth(self, ice: IceState, forc, theta0, salt0, dHn, dSn):
        """seaice_growth.F (0-layer, multDim categories, external fluxes):
        (ice', {Qnet, Qsw, EmPmR, saltFlux}), interior cells only."""
        p, cfg, g = self.p, self.cfg, self.grid
        c2k = cfg.celsius2K
        inside = self.interior > 0
        hm = self.HEFFM
        dzSurf = float(cfg.delR[0])
        recip_dtT = 1.0 / p.deltaTtherm
        ICE2SNOW = p.rhoIce / p.rhoSnow
        SNOW2ICE = 1.0 / ICE2SNOW
        QI = p.rhoIce * p.lhFusion
        recip_QI = 1.0 / QI
        area_reg_sq = p.area_reg ** 2
        hice_reg_sq = p.hice_reg ** 2
        convertQ2HI = p.deltaTtherm / QI
        convertHI2Q = 1.0 / convertQ2HI
        convertPRECIP2HI = p.deltaTtherm * cfg.rhoConstFresh / p.rhoIce
        convertHI2PRECIP = 1.0 / convertPRECIP2HI
        denom = 2.0 * sum((it + 1) * p.pdf[it] for it in range(p.multDim)) \
            - 1.0
        recip_denom = 1.0 / denom
        areaPDFfac = denom / p.multDim

        heff, hsnow, area, tices = ice.HEFF, ice.HSNOW, ice.AREA, ice.TICES
        HEFFpre, HSNWpre, AREApre = heff, hsnow, area
        pos = HEFFpre > 0.0
        t1 = torch.sqrt(AREApre * AREApre + area_reg_sq)
        t2 = HEFFpre / t1
        heffActual = _where(pos, torch.sqrt(t2 * t2 + hice_reg_sq), 0.0)
        hsnowActual = _where(pos, HSNWpre / t1, 0.0)
        recip_heffActual = _where(
            pos, AREApre / torch.sqrt(HEFFpre * HEFFpre + hice_reg_sq), 0.0)
        UG = _max(p.EPS, forc.wspeed)
        a_QbyATM_open = forc.Qnet
        a_QSWbyATM_open = forc.Qsw
        a_QbyATM_cover = torch.zeros_like(heff)
        a_QSWbyATM_cover = torch.zeros_like(heff)
        a_FWbySublim = torch.zeros_like(heff)
        new_tices = []
        for it in range(p.multDim):
            pFac = (2.0 * (it + 1) - 1.0) * recip_denom
            pFacSnow = pFac if p.useMultDimSnow else 1.0
            ts, fia, pensw, fwsub = self.solve4temp(
                UG, heffActual * pFac, hsnowActual * pFacSnow, tices[it],
                forc, salt0)
            new_tices.append(ts)
            a_QbyATM_cover = a_QbyATM_cover + fia * p.pdf[it]
            a_QSWbyATM_cover = a_QSWbyATM_cover + pensw * p.pdf[it]
            a_FWbySublim = a_FWbySublim + fwsub * p.pdf[it]
        tices = torch.stack(new_tices)

        a_QbyATM_cover = a_QbyATM_cover * convertQ2HI * AREApre
        a_QSWbyATM_cover = a_QSWbyATM_cover * convertQ2HI * AREApre
        a_QbyATM_open = a_QbyATM_open * convertQ2HI * (1.0 - AREApre)
        a_QSWbyATM_open = a_QSWbyATM_open * convertQ2HI * (1.0 - AREApre)
        r_QbyATM_cover = a_QbyATM_cover
        r_QbyATM_open = a_QbyATM_open
        a_FWbySublim = (p.deltaTtherm / p.rhoIce) * a_FWbySublim * AREApre
        r_FWbySublim = a_FWbySublim

        tempFrz = p.tempFrz0 + p.dTempFrz_dS * salt0
        fac = _where(theta0 >= tempFrz, p.mcPheePiston,
                     p.frazilFrac * dzSurf / p.deltaTtherm, like=theta0)
        mltf = _where(AREApre > 0.0,
                      (1.0 - p.mcPheeTaper * AREApre) if not p.mcPheeStepFunc
                      else (1.0 - p.mcPheeTaper), 1.0, like=AREApre)
        turb = (-(cfg.HeatCapacity_Cp * cfg.rhoConst * recip_QI)
                * (theta0 - tempFrz) * p.deltaTtherm * hm)
        r_QbyOCN = fac * turb * mltf

        # sublimation of snow, then of ice
        t2_ = _max(_min(r_FWbySublim, hsnow * SNOW2ICE), 0.0)
        hsnow = hsnow - t2_ * ICE2SNOW
        r_FWbySublim = r_FWbySublim - t2_
        t2_ = _max(_min(r_FWbySublim, heff), 0.0)
        d_HEFFbySublim = -t2_
        heff = heff - t2_
        r_FWbySublim = r_FWbySublim - t2_
        a_QbyATM_cover = a_QbyATM_cover - r_FWbySublim
        r_QbyATM_cover = r_QbyATM_cover - r_FWbySublim
        # ice-ocean
        d_HEFFbyOCNonICE = _max(r_QbyOCN, -heff)
        r_QbyOCN = r_QbyOCN - d_HEFFbyOCNonICE
        heff = heff + d_HEFFbyOCNonICE
        # snow melt by the atmosphere
        t2_ = _min(_max(r_QbyATM_cover, -hsnow * SNOW2ICE), 0.0)
        d_HSNWbyATMonSNW = t2_ * ICE2SNOW
        hsnow = hsnow + t2_ * ICE2SNOW
        r_QbyATM_cover = r_QbyATM_cover - t2_
        # ice melt and growth by the atmosphere over ice
        t2_ = _max(-heff, r_QbyATM_cover + AREApre * r_QbyOCN)
        d_HEFFbyATMonOCN_cover = t2_
        d_HEFFbyATMonOCN = t2_
        r_QbyATM_cover = r_QbyATM_cover - t2_
        heff = heff + t2_
        # precipitation: snow, or fresh water
        snows = a_QbyATM_cover >= 0.0
        d_HSNWbyRAIN = _where(
            snows, convertPRECIP2HI * ICE2SNOW * forc.precip * AREApre, 0.0)
        d_HFRWbyRAIN = _where(
            snows, 0.0, -convertPRECIP2HI * forc.precip * AREApre)
        hsnow = hsnow + d_HSNWbyRAIN
        # snow melt by the ocean
        d_HSNWbyOCNonSNW = _min(_max(r_QbyOCN * ICE2SNOW, -hsnow), 0.0)
        r_QbyOCN = r_QbyOCN - d_HSNWbyOCNonSNW * SNOW2ICE
        hsnow = hsnow + d_HSNWbyOCNonSNW
        # open-water growth
        facOpenGrow = 1.0 if p.doOpenWaterGrowth else 0.0
        facOpenMelt = 1.0 if p.doOpenWaterMelt else 0.0
        t1_ = r_QbyATM_open + r_QbyOCN * (1.0 - AREApre)
        t2_ = self.SWFrac * a_QSWbyATM_open
        t3_ = facOpenGrow * _max(t1_ - t2_, -heff * facOpenMelt) * hm
        d_HEFFbyATMonOCN_open = t3_
        d_HEFFbyATMonOCN = d_HEFFbyATMonOCN + t3_
        r_QbyATM_open = r_QbyATM_open - t3_
        heff = heff + t3_
        # flooding
        if p.useFlooding:
            t0_ = _div(hsnow * p.rhoSnow + heff * p.rhoIce, cfg.rhoConst)
            d_HEFFbyFLOODING = _max(0.0, t0_ - heff)
            heff = heff + d_HEFFbyFLOODING
            hsnow = hsnow - d_HEFFbyFLOODING * ICE2SNOW
        else:
            d_HEFFbyFLOODING = torch.zeros_like(heff)
        # area
        recip_HO = _where(g.yC < 0.0, 1.0 / p.HO_south, 1.0 / p.HO, like=g.yC)
        if p.areaGainFormula == 1:
            gain = _max(0.0, d_HEFFbyATMonOCN_open)
        else:
            gain = _max(0.0, a_QbyATM_open)
        if p.areaLossFormula == 1:
            loss = (_min(0.0, d_HEFFbyATMonOCN_cover)
                    + _min(0.0, d_HEFFbyATMonOCN_open)
                    + _min(0.0, d_HEFFbyOCNonICE))
        else:
            loss = _min(0.0, d_HEFFbyATMonOCN_cover + d_HEFFbyATMonOCN_open
                        + d_HEFFbyOCNonICE)
        some = (heff > 0.0) | (hsnow > 0.0)
        area = _where(some, _max(0.0, _min(
            p.area_max, area + recip_HO * gain
            + 0.5 * recip_heffActual * loss * areaPDFfac)), 0.0)
        # salt flux
        t1_ = (dHn + d_HEFFbyOCNonICE + d_HEFFbyATMonOCN + d_HEFFbyFLOODING
               + d_HEFFbySublim)
        t3_ = _max(0.0, _min(p.salt0, salt0))
        saltFlux = t1_ * t3_ * hm * recip_dtT * p.rhoIce
        # the ocean's forcing
        qnet = (r_QbyATM_cover + r_QbyATM_open + a_QSWbyATM_cover
                - (d_HEFFbyOCNonICE + d_HSNWbyOCNonSNW * SNOW2ICE
                   + dHn + dSn * SNOW2ICE) * hm)
        qsw = a_QSWbyATM_cover + a_QSWbyATM_open
        qnet = qnet * convertHI2Q
        qsw = qsw * convertHI2Q
        empmr = hm * (
            (forc.evap - forc.precip) * (1.0 - AREApre) - forc.runoff
            + (d_HSNWbyATMonSNW * SNOW2ICE + d_HFRWbyRAIN
               + d_HSNWbyOCNonSNW * SNOW2ICE + d_HEFFbyOCNonICE
               + d_HEFFbyATMonOCN + dHn + dSn * SNOW2ICE
               + r_FWbySublim) * convertHI2PRECIP) * cfg.rhoConstFresh

        def m(a, b):
            return torch.where(inside, a, b)

        ice2 = ice._replace(HEFF=m(heff, ice.HEFF), HSNOW=m(hsnow, ice.HSNOW),
                            AREA=m(area, ice.AREA),
                            TICES=torch.where(inside[None], tices, ice.TICES))
        return ice2, {"Qnet": m(qnet, forc.Qnet), "Qsw": m(qsw, forc.Qsw),
                      "EmPmR": m(empmr, forc.EmPmR),
                      "saltFlux": m(saltFlux, forc.saltFlux)}

    def thermo(self, ice: IceState, forc, theta0, salt0, impl: str = None):
        """reg_ridge then growth: (ice', {Qnet, Qsw, EmPmR, saltFlux});
        kernel seaice_thermo (one launch, one thread per column) on CUDA
        tensors, the twin on CPU tensors or with impl="plain"."""
        seaice_kernels.refuse_grad(
            "seaice_thermo", theta0=theta0, salt0=salt0,
            **{k: getattr(ice, k) for k in ("HEFF", "HSNOW", "AREA",
                                            "TICES")},
            **{k: getattr(forc, k) for k in _THERMO_FORCING})
        if not kernels.use_kernel(ice.HEFF, impl):
            global plain_calls
            plain_calls += 1
            ice, dHn, dSn = self.reg_ridge(ice)
            return self.growth(ice, forc, theta0, salt0, dHn, dSn)
        return seaice_kernels.thermo(self, ice, forc, theta0, salt0)

    # ------------------------------------------------------------------
    def step(self, ice: IceState, forc, uVel0, vVel0, etaN, theta0, salt0,
             fu, fv, impl: str = None):
        """SEAICE_MODEL (seaice.py:step, :1983): one sea-ice step. Returns
        (ice', forcing updates fu, fv, Qnet, Qsw, EmPmR, saltFlux,
        {"lsr_iters": [(ICOUNT1, ICOUNT2) per Picard pass],
        "lsr_host_syncs": [per pass]}); the lists are empty unless the
        dynamics run the LSR."""
        p, g = self.p, self.grid
        press0 = (p.strength * ice.HEFF
                  * torch.exp(-p.cStar * (1.0 - ice.AREA))) * self.HEFFM
        zMax = p.zetaMaxFac * press0
        taux, tauy = self.get_dynforcing(forc)
        massC = p.rhoIce * ice.HEFF
        massU = p.rhoIce * 0.5 * (ice.HEFF + sh(ice.HEFF, di=-1))
        massV = p.rhoIce * 0.5 * (ice.HEFF + sh(ice.HEFF, dj=-1))
        if p.addSnowMass:
            massC = massC + p.rhoSnow * ice.HSNOW
            massU = massU + p.rhoSnow * 0.5 * (ice.HSNOW
                                               + sh(ice.HSNOW, di=-1))
            massV = massV + p.rhoSnow * 0.5 * (ice.HSNOW
                                               + sh(ice.HSNOW, dj=-1))
        phiSurf = g.Bo_surf * etaN
        if p.scaleSurfStress:
            forcex0 = taux * 0.5 * (ice.AREA + sh(ice.AREA, di=-1))
            forcey0 = tauy * 0.5 * (ice.AREA + sh(ice.AREA, dj=-1))
        else:
            forcex0, forcey0 = taux, tauy
        if p.useTilt:
            forcex0 = forcex0 - massU * g.recip_dxC * (
                phiSurf - sh(phiSurf, di=-1))
            forcey0 = forcey0 - massV * g.recip_dyC * (
                phiSurf - sh(phiSurf, dj=-1))
        # the dynamics (seaice.py:2027-2047): free drift, EVP, LSR or none
        counts, syncs = [], []
        evp = p.useDYNAMICS and p.useEVP and not p.useFreeDrift
        if p.useDYNAMICS and p.useFreeDrift:
            uIce, vIce = self.freedrift(ice, uVel0, vVel0, forcex0, forcey0,
                                        impl)
            ice = ice._replace(uIce=uIce, vIce=vIce)
            # nothing on the free-drift path updates DWATN: the ocean
            # stress sees the initial zeros (a fault of the reference,
            # copied: seaice.py:2029-2035)
            dwatn = torch.zeros_like(press0)
        elif evp:
            (uIce, vIce, dwatn, sigma, stressDivX,
             stressDivY) = self.evp(ice, uVel0, vVel0, press0, massC, massU,
                                    massV, forcex0, forcey0, impl=impl)
            ice = ice._replace(uIce=uIce, vIce=vIce, sigma=sigma)
        elif p.useDYNAMICS:
            uIce, vIce, dwatn, counts, syncs = self.lsr(
                ice, uVel0, vVel0, press0, zMax, massC, massU, massV,
                forcex0, forcey0, impl=impl)
            ice = ice._replace(uIce=uIce, vIce=vIce)
        else:
            dwatn = self.oceandrag(ice.uIce, ice.vIce, uVel0, vVel0)
        upd = {}
        if p.updateOceanStress:
            if p.useHB87stressCoupling:     # EVP only (check_seaice)
                upd["fu"], upd["fv"] = self.ocean_stress_hb87(
                    ice, taux, tauy, stressDivX, stressDivY, fu, fv, impl)
            else:
                upd["fu"], upd["fv"] = self.ocean_stress(ice, dwatn, uVel0,
                                                         vVel0, fu, fv, impl)
        if p.useDYNAMICS and p.useEVP and p.clipVelocities:
            # after the ocean stress whenever EVP is set, under free drift
            # too (seaice.py:2063-2066); the LSR clips before its fill
            # (SeaIce.lsr)
            uIce, vIce = self.clip(ice.uIce, ice.vIce)
            ice = ice._replace(uIce=uIce, vIce=vIce)
        ice = self.advdiff(ice, impl=impl)
        ice, forc_upd = self.thermo(ice, forc, theta0, salt0, impl=impl)
        # the end-of-step exchanges (seaice_model.F:1411-1420)
        ice = ice._replace(HEFF=self.fill(ice.HEFF, impl),
                           AREA=self.fill(ice.AREA, impl),
                           HSNOW=self.fill(ice.HSNOW, impl),
                           TICES=self.fill(ice.TICES, impl))
        for k, v in forc_upd.items():
            upd[k] = self.fill(v, impl)
        return ice, upd, {"lsr_iters": counts, "lsr_host_syncs": syncs}
