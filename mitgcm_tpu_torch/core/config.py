"""Runtime configuration: the model parameter set.

The port's own copy of mitgcm_tpu/core/config.py:Config (:27-595): the
reference's PARM01-05 runtime parameters (declared in model/inc/PARAMS.h,
defaults in model/src/set_defaults.F, derived values in
model/src/set_parms.F) as a plain dataclass with the same fields, defaults
and `finalize()`, so that a configuration built by either package holds the
same values. Unknown namelist entries are kept in `extra`. The deck loader
(`load_experiment`) is not copied: the port builds its configurations in
code (utils/synthetic.py).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

UNSET = None


@dataclass
class Config:
    # --- domain size (SIZE.h analog) ---
    nx: int = 0
    ny: int = 0
    nr: int = 1
    olx: int = 2
    oly: int = 2

    # --- PARM01: continuous equation ---
    viscAh: float = 0.0
    viscA4: float = 0.0
    # horizontal viscosity for wVel (ini_parms.F:510-511: default viscAhD
    # which itself defaults to viscAh)
    viscAhW: float = UNSET
    viscA4W: float = UNSET
    viscAz: float = UNSET          # vertical viscosity (m2/s), z-coords
    viscAr: float = 0.0
    diffKhT: float = 0.0
    diffK4T: float = 0.0
    diffKzT: float = UNSET
    diffKrT: float = 0.0
    diffKhS: float = 0.0
    diffK4S: float = 0.0
    diffKzS: float = UNSET
    diffKrS: float = 0.0
    # Bryan & Lewis 1979 depth-dependent background diffusivity
    # (set_defaults.F:159-162; profile formula calc_3d_diffusivity.F:85)
    diffKrBL79surf: float = 0.0
    diffKrBL79deep: float = 0.0
    diffKrBL79scl: float = 200.0
    diffKrBL79Ho: float = -2000.0
    f0: float = 1.0e-4        # set_defaults.F:111
    beta: float = 0.0
    fPrime: float = 0.0
    omega: float = UNSET           # default 2pi/86164 s (set_parms)
    rotationPeriod: float = 86164.0
    rhoConst: float = UNSET        # defaults to rhoNil (ini_parms.F:476)
    rhoNil: float = 999.8
    gravity: float = 9.81
    sIceLoadFac: float = 1.0       # scale of sea-ice mass loading (PARM01)
    gBaro: float = UNSET           # defaults to gravity
    rigidLid: bool = False
    implicitFreeSurface: bool = True
    eosType: str = "LINEAR"
    tAlpha: float = 2.0e-4
    sBeta: float = 7.4e-4
    tRef: Tuple[float, ...] = ()
    sRef: Tuple[float, ...] = ()
    tRefFile: str = ""
    sRefFile: str = ""
    no_slip_sides: bool = True
    no_slip_bottom: bool = True
    sideDragFactor: float = 2.0
    bottomDragLinear: float = 0.0
    bottomDragQuadratic: float = 0.0
    selectBotDragQuadr: int = -1
    momViscosity: bool = True
    momAdvection: bool = True
    momForcing: bool = True
    momStepping: bool = True
    momPressureForcing: bool = True
    metricTerms: bool = True
    selectMetricTerms: int = UNSET
    useNHMTerms: bool = False
    implicitDiffusion: bool = False
    implicitViscosity: bool = False
    tempStepping: bool = True
    saltStepping: bool = True
    tempAdvection: bool = True
    saltAdvection: bool = True
    tempForcing: bool = True
    saltForcing: bool = True
    vectorInvariantMomentum: bool = False
    staggerTimeStep: bool = False
    useRealFreshWaterFlux: bool = False
    exactConserv: bool = False
    nonlinFreeSurf: int = 0
    select_rStar: int = 0
    implicSurfPress: float = 1.0
    implicDiv2Dflow: float = 1.0
    hFacMin: float = 1.0
    hFacMinDr: float = 0.0
    hFacInf: float = 0.2
    hFacSup: float = 2.0
    useMin4hFacEdges: bool = False
    selectCoriScheme: int = UNSET
    useJamartWetPoints: bool = False
    useEnergyConservingCoriolis: bool = False
    selectKEscheme: int = 0
    selectVortScheme: int = UNSET
    useAbsVorticity: bool = False
    upwindVorticity: bool = False
    highOrderVorticity: bool = False
    selectAddFluid: int = 0
    uniformLin_PhiSurf: bool = True
    linFSConserveTr: bool = False
    convertFW2Salt: float = UNSET
    temp_EvPrRn: float = UNSET
    salt_EvPrRn: float = 0.0
    readBinaryPrec: int = 32
    writeBinaryPrec: int = 32
    writeStatePrec: int = 64
    globalFiles: bool = True
    debugLevel: int = 1
    ivdc_kappa: float = 0.0
    cAdjFreq: float = 0.0
    hMixCriteria: float = -0.8
    rSphere: float = 6.37e6
    cosPower: float = 0.0          # cos(lat)^n anisotropic visc/diff scaling
    tempAdvScheme: int = 2
    saltAdvScheme: int = 2
    tempVertAdvScheme: int = UNSET
    saltVertAdvScheme: int = UNSET
    multiDimAdvection: bool = True
    tempImplVertAdv: bool = False
    saltImplVertAdv: bool = False
    viscAhGrid: float = 0.0
    viscA4Grid: float = 0.0
    viscAhMax: float = 1.0e21
    viscA4Max: float = 1.0e21
    viscAhGridMax: float = 1.0e21  # coeff on the L2/(4dt) CFL cap
    viscAhGridMin: float = 0.0
    viscA4GridMax: float = 1.0e21  # factor applied as coeff*rA^2/dt caps
    viscA4GridMin: float = 0.0
    # grid-Reynolds-number viscosity floors (mom_calc_visc.F:103-112)
    viscAhReMax: float = 0.0
    viscA4ReMax: float = 0.0
    # background viscosities split by location: Div (C) / vort (Z) points
    # (ini_parms.F: default to viscAh/viscA4 when unset)
    viscAhD: float = UNSET
    viscAhZ: float = UNSET
    viscA4D: float = UNSET
    viscA4Z: float = UNSET
    useAreaViscLength: bool = False
    viscC2LeithQG: float = 0.0
    viscC2leith: float = 0.0
    viscC2leithD: float = 0.0
    viscC4leith: float = 0.0
    viscC4leithD: float = 0.0
    viscC2smag: float = 0.0
    viscC4smag: float = 0.0
    useFullLeith: bool = False
    useSmag3D: bool = False
    useStrainTensionVisc: bool = False
    quasiHydrostatic: bool = False
    nonHydrostatic: bool = False
    use3dCoriolis: bool = True
    select3dCoriScheme: int = UNSET
    rhoConstFresh: float = UNSET
    allowFreezing: bool = False
    shortwaveHeating: bool = False   # CPP SHORTWAVE_HEATING
    # CPP ALLOW_3D_DIFFKR: one 3-D vertical diffusivity for all tracers,
    # initialised from the diffKrNrS profile (ini_mixing.F:45)
    allow3dDiffKr: bool = False
    # deck-override ptracers_forcing_surf.F applying surfaceForcingS to
    # every passive tracer (tutorial_tracer_adjsens code_ad)
    ptracersForcingLikeSalt: bool = False
    buoyancyRelation: str = "OCEANIC"
    atm_Rq: float = 0.0
    top_Pres: float = 0.0
    usingPCoords: bool = False
    usingZCoords: bool = True
    fluidIsAir: bool = False
    fluidIsWater: bool = True
    nFaces: int = 1                # 6 for the cubed sphere
    # distributed cubed sphere: this process holds ONE face of a cube
    # (mitgcm_tpu/parallel/dist.py DistCSModel) — nFaces==1 locally, but
    # the cube-corner code paths (FILL_CS_CORNER_*, no-wrap vorticity
    # stencils) must still run on the local face block
    csLocalFace: bool = False

    @property
    def onCubeFace(self) -> bool:
        """True when the arrays contain cubed-sphere face block(s) — the
        full stacked cube (nFaces==6) or one distributed face."""
        return self.nFaces > 1 or self.csLocalFace
    gadMultiDimCompressible: bool = False  # GAD_MULTIDIM_COMPRESSIBLE
    # exch2 global-file IO layout (pkg/exch2/w2_readparms.F:64 default -1):
    # -1/0 = global 2-D map, faces side by side along x ([n, 6n]);
    #  1   = compact, faces stacked along y ([6n, n])
    W2_mapIO: int = -1
    custom_forcing_uv: object = None   # f(cfg,grid,state)->(gu,gv) 3-D adds
    custom_forcing_t: object = None    # f(cfg,grid,state)->gT 3-D add
    useSHAP_FILT: bool = False
    shap: object = None                # ShapParams (data.shap)
    zonfilt: object = None             # ZonFiltParams (data.zonfilt)
    aim: object = None                 # AimParams (data.aimphys)
    grid_dir: str = ""                 # where tile*.mitgrid / input .bin
                                       # files live when not in run_dir
                                       # (verification prepare_run links)
    selectP_inEOS_Zc: int = UNSET      # set_parms.F:268 (2 for JMD95P etc)
    integr_GeoPot: int = 2             # set_defaults.F:136 (1=FV, 2=FD)
    selectFindRoSurf: int = 0          # 1: Po_surf from analytic theta
    geoPotAnomFile: str = ""           # phi0surf input (ini_linear_phisurf.F)
    surf_pRef: float = 101325.0        # set_defaults.F:103
    eosRefP0: float = 101325.0         # ini_eos.F:82
    celsius2K: float = 273.15
    atm_Cp: float = 1004.0
    atm_Rd: float = UNSET
    alph_AB: float = UNSET         # set -> Adams-Bashforth-3 time stepping
    beta_AB: float = UNSET
    useAB3: bool = False
    atm_kappa: float = 2.0 / 7.0
    atm_Po: float = 1.0e5
    thetaConst: float = UNSET
    HeatCapacity_Cp: float = 3994.0
    gravitySign: float = -1.0
    rkSign: float = -1.0

    # --- PARM02: elliptic solver ---
    cg2dMaxIters: int = 150
    # replicate the reference's sequential per-tile dot-product summation
    # order inside cg2d (bit-exact digit matching on solver-amplified
    # configs); tree-reduction jnp.sum otherwise (the TPU-fast default)
    cg2dExactSums: bool = False
    cg2dTargetResidual: float = 1.0e-7
    cg2dTargetResWunit: float = -1.0
    cg2dpcOffDFac: float = 0.51
    cg2dUseMinResSol: int = UNSET
    cg2dPreCondFreq: int = 1
    printResidualFreq: int = 0
    useSRCGSolver: bool = False
    cg3dMaxIters: int = 150
    cg3dTargetResidual: float = 1.0e-7
    cg3dTargetResWunit: float = -1.0
    # non-hydrostatic parameters (PARM01; set_defaults.F:214-220)
    nh_Am2: float = 1.0
    implicitNHPress: float = UNSET   # defaults to implicSurfPress
    selectNHfreeSurf: int = 0
    implicitIntGravWave: bool = False

    # --- PARM03: time stepping ---
    tauCD: float = 0.0
    rCD: float = -1.0
    epsAB_CD: float = UNSET
    useCDscheme: bool = False
    nIter0: int = 0
    nTimeSteps: int = 0
    deltaT: float = 0.0
    deltaTMom: float = 0.0
    deltaTTracer: float = 0.0
    deltaTFreeSurf: float = 0.0
    deltaTClock: float = 0.0
    abEps: float = 0.01
    momForcingOutAB: int = UNSET
    tracForcingOutAB: int = UNSET
    momDissip_In_AB: bool = True
    doAB_onGtGs: bool = True
    forcing_In_AB: bool = True
    baseTime: float = 0.0
    startTime: float = UNSET
    endTime: float = UNSET
    pChkptFreq: float = 0.0
    chkptFreq: float = 0.0
    dumpFreq: float = 0.0
    monitorFreq: float = UNSET
    monitorSelect: int = UNSET
    # Emit monitor stats with the pre-2009 formulas (MON_STATS_RL del2 =
    # 0.25*sum|masked laplacian|/nPts without sqrt; W_hf CFL on recip_drC).
    # Some committed verification outputs (e.g. aim.5l_LatLon) predate the
    # 2009/12/21 switch to MON_CALC_STATS_RL and can only be digit-matched
    # with the old formulas. Not a namelist parameter: set per-experiment.
    # hs94.cs-32x32x5's output sits between the two monitor revisions:
    # legacy del2 but the modern recip_drF W_hf — hence two flags.
    monitorLegacyStats: bool = False
    monitorLegacyWhf: bool = UNSET   # defaults to monitorLegacyStats
    externForcingPeriod: float = 0.0
    externForcingCycle: float = 0.0
    periodicExternalForcing: bool = False
    pickupStrictlyMatch: bool = True
    pickupSuff: str = ""
    startFromPickup: bool = False   # sets AB history validity (startAB=1)
    tauThetaClimRelax: float = 0.0
    tauSaltClimRelax: float = 0.0

    # --- PARM04: gridding ---
    usingCartesianGrid: bool = False
    usingSphericalPolarGrid: bool = False
    usingCylindricalGrid: bool = False
    usingCurvilinearGrid: bool = False
    dxSpacing: float = UNSET
    dySpacing: float = UNSET
    delX: Tuple[float, ...] = ()
    delY: Tuple[float, ...] = ()
    delR: Tuple[float, ...] = ()
    delRc: Tuple[float, ...] = ()
    delRFile: str = ""
    delXfile: str = ""
    delYfile: str = ""
    xgOrigin: float = 0.0
    ygOrigin: float = 0.0
    rSphereC: float = UNSET
    phiMin: float = 0.0
    thetaMin: float = 0.0
    deepAtmosphere: bool = False
    seaLev_Z: float = 0.0
    horizGridFile: str = ""
    radius_fromHorizGrid: float = UNSET

    # --- PARM05: input files ---
    bathyFile: str = ""
    topoFile: str = ""
    hydrogThetaFile: str = ""
    hydrogSaltFile: str = ""
    zonalWindFile: str = ""
    meridWindFile: str = ""
    thetaClimFile: str = ""
    saltClimFile: str = ""
    surfQFile: str = ""
    surfQnetFile: str = ""
    surfQswFile: str = ""
    EmPmRFile: str = ""
    saltFluxFile: str = ""
    pLoadFile: str = ""
    uVelInitFile: str = ""
    vVelInitFile: str = ""
    pSurfInitFile: str = ""
    checkIniTemp: bool = True
    checkIniSalt: bool = True

    # --- packages on/off (data.pkg analog) ---
    useMONITOR: bool = True
    useMNC: bool = False
    useGMRedi: bool = False
    useEXF: bool = False
    useCAL: bool = False
    exf_climtempfreeze: object = None  # set by model/exf.py when useEXF
    exf_useBulk: bool = False          # exf bulk-formulae mode (atemp set)
    exf_bulk: object = None            # bulk constants dict (EXF_NML_01)
    exf_useAtmWind: bool = True        # ALLOW_ATM_WIND / useAtmWind
    exf_ly04: bool = False             # ALLOW_BULK_LARGEYEAGER04
    exf_stressCgrid: bool = False      # readStressOnCgrid
    exf_runoftemp: bool = False        # runoftempfile present
    # reference tile decomposition (SIZE.h): the seaice LSR tridiagonal
    # sweeps are per-tile, so digit-matching needs the tile shape
    sNx: int = 0
    sNy: int = 0
    nSx: int = 1
    nSy: int = 1
    seaice: object = None              # SeaiceParams when useSEAICE
    poly3: object = None               # POLY3.COEFFS (refT,refS,sig0,C)
    useKPP: bool = False
    useGGL90: bool = False
    usePP81: bool = False
    useMY82: bool = False
    useOPPS: bool = False
    useSEAICE: bool = False
    useEXF: bool = False
    useCAL: bool = False
    useOBCS: bool = False
    usePTRACERS: bool = False
    useRBCS: bool = False
    useDiagnostics: bool = False
    useAIM: bool = False
    useLand: bool = False
    useThSIce: bool = False
    useZONAL_FILT: bool = False
    useOffLine: bool = False
    useGCHEM: bool = False
    # pkg/grdchk: finite-difference gradient checks (driven offline by
    # ad/grdchk.py, not inside the step)
    useGrdchk: bool = False
    # PARM02 useNSACGSolver selects cg2d_nsa.F (fixed-iteration, AD-safe
    # "no solver assumptions" CG). Our cg2d is already AD-safe via its
    # custom implicit-function VJP (solver/cg2d.py), so the flag only
    # records the deck's intent.
    useNSACGSolver: bool = False

    # package parameter groups (loaded from data.<pkg>)
    gmredi: Any = None
    ptracers: Any = None
    offline: Any = None                # OfflineParams when useOffLine
    gchem: Any = None                  # data.gchem GCHEM_PARM01 dict
    obcs: Any = None                   # OBCSParams when useOBCS
    custom_obcs_calc: Any = None       # analytic obcs_calc.F override hook

    # run-directory context + overflow storage
    run_dir: str = "."
    extra: Dict[str, Any] = field(default_factory=dict)

    # ---------------- derived (filled by finalize) ----------------
    mass2rUnit: float = 0.0
    rUnit2mass: float = 0.0
    freeSurfFac: float = 1.0
    recip_rhoConst: float = 0.0

    @property
    def ksurf0(self) -> int:
        """0-based surface-level index (kSurface in
        external_forcing_surf.F:103-109: Nr under p-coords, 1 else)."""
        return self.nr - 1 if self.usingPCoords else 0

    def find_code_file(self, fname: str) -> str:
        """Resolve a compile-options header: <deck>/../code/<fname> for
        the run dir and every grid_dir search entry (linked decks share
        the parent experiment's code/)."""
        cands = [self.run_dir] + (self.grid_dir.split(os.pathsep)
                                  if self.grid_dir else [])
        # AD decks (input_ad/input_tap) build from code_ad/code_tap,
        # which themselves fall back to the forward code/ dir
        subs = ["code"]
        base = os.path.basename(os.path.abspath(self.run_dir))
        if base.startswith("input_ad"):
            subs = ["code_ad", "code"]
        elif base.startswith("input_tap"):
            subs = ["code_tap", "code_ad", "code"]
        for d in cands:
            for sub in subs:
                p = os.path.join(os.path.dirname(os.path.abspath(d)),
                                 sub, fname)
                if os.path.exists(p):
                    return p
        return ""

    def find_file(self, fname: str) -> str:
        """Resolve an input file: run_dir first, then grid_dir (the
        reference's prepare_run symlinks files from sibling decks;
        grid_dir may hold several os.pathsep-separated directories)."""
        p1 = os.path.join(self.run_dir, fname)
        if os.path.exists(p1) or not self.grid_dir:
            return p1
        for d in self.grid_dir.split(os.pathsep):
            p2 = os.path.join(d, fname)
            if os.path.exists(p2):
                return p2
        return p1

    def finalize(self) -> "Config":
        """Resolve UNSET/derived parameters (ini_parms.F / set_parms.F)."""
        c = self
        # buoyancy relation -> coordinate system (set_parms.F)
        br = (c.buoyancyRelation or "OCEANIC").upper()
        if br == "ATMOSPHERIC":
            c.fluidIsAir = True
            c.fluidIsWater = False
            c.usingPCoords = True
            c.usingZCoords = False
            c.gravitySign = 1.0
        elif br == "OCEANICP":
            c.usingPCoords = True
            c.usingZCoords = False
            c.gravitySign = 1.0
        if c.usingCurvilinearGrid:
            c.nFaces = 6
        if c.gBaro is UNSET:
            c.gBaro = c.gravity
        if c.alph_AB is not UNSET:
            c.useAB3 = True
            if c.beta_AB is UNSET:
                c.beta_AB = 5.0 / 12.0    # set_defaults.F:319
        if c.atm_Rd is UNSET:
            c.atm_Rd = c.atm_Cp * c.atm_kappa     # ini_parms.F:490
        else:
            c.atm_kappa = c.atm_Rd / c.atm_Cp
        if c.omega is UNSET:
            c.omega = 2.0 * math.pi / c.rotationPeriod if c.rotationPeriod else 0.0
        # deltaT family (ini_parms.F:1013-1016): deltaT defaults from
        # deltaTClock FIRST, then deltaTtracer, deltaTMom, deltaTFreeSurf
        dt = (c.deltaT or c.deltaTClock or c.deltaTTracer or c.deltaTMom
              or c.deltaTFreeSurf)
        c.deltaT = c.deltaT or dt
        c.deltaTMom = c.deltaTMom or dt
        c.deltaTTracer = c.deltaTTracer or dt
        c.deltaTFreeSurf = c.deltaTFreeSurf or c.deltaTMom
        c.deltaTClock = c.deltaTClock or dt
        if c.startTime is UNSET and c.nIter0 is not None:
            # ini_parms.F: startTime = baseTime + nIter0*deltaTClock
            c.startTime = c.baseTime + c.nIter0 * (c.deltaTClock or 0.0)
        if (c.nTimeSteps == 0 and c.endTime is not UNSET and c.endTime
                and c.deltaTClock):
            # ini_parms.F:1112: NINT((endTime-startTime)/deltaTClock)
            c.nTimeSteps = int(round((c.endTime - c.startTime)
                                     / c.deltaTClock))
        # vertical mixing coefficient aliases (z-coords)
        if c.viscAz is not UNSET:
            c.viscAr = c.viscAz
        if c.diffKzT is not UNSET:
            c.diffKrT = c.diffKzT
        if c.diffKzS is not UNSET:
            c.diffKrS = c.diffKzS
        # Div/vort-point background viscosities (ini_parms.F:505-508)
        if c.viscAhD is UNSET:
            c.viscAhD = c.viscAh
        if c.viscAhZ is UNSET:
            c.viscAhZ = c.viscAh
        if c.viscA4D is UNSET:
            c.viscA4D = c.viscA4
        if c.viscA4Z is UNSET:
            c.viscA4Z = c.viscA4
        # wVel viscosities (ini_parms.F:510-511, viscAhD/viscA4D chain)
        if c.viscAhW is UNSET:
            c.viscAhW = c.viscAhD
        if c.viscA4W is UNSET:
            c.viscA4W = c.viscA4D
        if c.implicitNHPress is UNSET:
            c.implicitNHPress = c.implicSurfPress
        # freeSurfFac (ini_parms.F:473)
        c.freeSurfFac = 0.0 if c.rigidLid else 1.0
        # rhoConst defaults to rhoNil (ini_parms.F:476)
        if c.rhoConst is UNSET:
            c.rhoConst = c.rhoNil
        # mass <-> r-unit conversion (ini_parms.F:1542-1545)
        c.recip_rhoConst = 1.0 / c.rhoConst
        if c.usingPCoords:
            c.mass2rUnit = c.gravity
        else:
            c.mass2rUnit = c.recip_rhoConst
        c.rUnit2mass = 1.0 / c.mass2rUnit
        # AB forcing placement (ini_parms.F:1065)
        if c.momForcingOutAB is UNSET:
            c.momForcingOutAB = 0 if c.forcing_In_AB else 1
        if c.tracForcingOutAB is UNSET:
            c.tracForcingOutAB = 0 if c.forcing_In_AB else 1
        # Coriolis scheme (ini_parms.F:648)
        if c.selectCoriScheme is UNSET:
            s = 0
            if c.useJamartWetPoints:
                s = 1
            if c.useEnergyConservingCoriolis and not c.vectorInvariantMomentum:
                s += 2
            c.selectCoriScheme = s
        if c.select3dCoriScheme is UNSET:
            # vintage default (matches the committed verification
            # outputs): on only for quasi/non-hydrostatic runs
            c.select3dCoriScheme = (
                1 if (c.quasiHydrostatic or c.nonHydrostatic) else 0)
        if c.selectP_inEOS_Zc is UNSET:
            c.selectP_inEOS_Zc = (
                2 if c.eosType.upper() in ("JMD95P", "UNESCO", "MDJWF",
                                           "TEOS10") else 0)
        if c.selectMetricTerms is UNSET:
            c.selectMetricTerms = 1 if c.metricTerms else 0
        # cg2d min-residual solution (ini_parms.F:1557)
        if c.cg2dUseMinResSol is UNSET:
            c.cg2dUseMinResSol = (
                1 if (not c.topoFile and not c.bathyFile and c.usingCartesianGrid)
                else 0
            )
        if c.monitorFreq is UNSET:
            c.monitorFreq = c.deltaTClock
        if c.monitorSelect is UNSET:
            # ini_parms.F:1170: default 2, but 3 for water
            c.monitorSelect = 3 if not c.fluidIsAir else 2
        # reference profiles
        if not c.tRef:
            c.tRef = tuple([20.0] * c.nr)
        elif len(c.tRef) < c.nr:
            c.tRef = tuple(list(c.tRef) + [c.tRef[-1]] * (c.nr - len(c.tRef)))
        if not c.sRef:
            c.sRef = tuple([30.0] * c.nr)
        elif len(c.sRef) < c.nr:
            c.sRef = tuple(list(c.sRef) + [c.sRef[-1]] * (c.nr - len(c.sRef)))
        if c.convertFW2Salt is UNSET:
            c.convertFW2Salt = -1.0 if c.useRealFreshWaterFlux else 35.0
        if c.rhoConstFresh is UNSET:
            c.rhoConstFresh = c.rhoConst
        if c.epsAB_CD is UNSET:
            c.epsAB_CD = c.abEps
        if c.useCDscheme and c.tauCD == 0.0:
            c.tauCD = c.deltaTMom
        # dxSpacing/dySpacing: uniform grid spacing shorthands
        # (ini_parms.F:940-950, override delX/delY)
        for key, tgt in (("dxspacing", "delX"), ("dyspacing", "delY")):
            for k, v in list(c.extra.items()):
                if k.lower() == key:
                    n = c.nx if tgt == "delX" else c.ny
                    setattr(c, tgt, tuple([float(v)] * max(n, 1)))
        return c

