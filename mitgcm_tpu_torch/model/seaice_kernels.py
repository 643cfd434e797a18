"""The card side of model/seaice.py: the wrappers that check their inputs
and launch the sea ice's CUDA kernels (kernels/csrc/seaice_lsr.cu,
seaice_advect.cu, seaice_thermo.cu, seaice_evp.cu, seaice_freedrift.cu).
model/seaice.py calls them for CUDA tensors; each mirrors a plain twin
there, bit for bit. None of these kernels has a backward kernel: every
wrapper, and every dispatcher in model/seaice.py that would run a twin,
refuses an input that requires grad (`refuse_grad`), so a gradient never
silently drops the ice."""

from __future__ import annotations

import math

import torch

from mitgcm_tpu_torch import kernels

# the coefficient fields of a pass, in the order of the U and V sweeps'
# tables (A, B, C, Rt1, Rt2, rhs; the mask is added by the sweep)
_SWEEP = {True: ("AU", "BU", "CU", "uRt1", "uRt2", "rhsU"),
          False: ("AV", "BV", "CV", "vRt1", "vRt2", "rhsV")}
_PREP_OUT = ("AU", "BU", "CU", "AV", "BV", "CV", "uRt1", "uRt2", "vRt1",
             "vRt2", "rhsU", "rhsV", "dwatn")


def refuse_grad(kernel: str, **tensors) -> None:
    """Raise ValueError naming the inputs of `kernel` that require grad:
    the sea ice's kernels write through ctypes into fresh outputs and have
    no backward kernel."""
    grads = [n for n, t in tensors.items()
             if isinstance(t, torch.Tensor) and t.requires_grad]
    if grads:
        raise ValueError(f"{kernel}: {grads} require grad; kernel H-seaice "
                         "has no backward kernel yet")


def lsr_prep(si, uIce, vIce, uIceC, vIceC, uVel0, vVel0, press0, zMax,
             fxTmp, fyTmp, areaW, areaS, massC, massU, massV) -> dict:
    """seaice_lsr_visc, then seaice_lsr_coeffs (model/seaice.py:lsr_prep)."""
    eta, zeta, press = lsr_visc(si, uIceC, vIceC, press0, zMax)
    return lsr_coeffs(si, eta, zeta, press, uIce, vIce, uIceC, vIceC, uVel0,
                      vVel0, fxTmp, fyTmp, areaW, areaS, massC, massU, massV)


def lsr_visc(si, uIceC, vIceC, press0, zMax):
    """seaice_lsr_visc (model/seaice.py:_visc_plain): (eta, zeta, press)."""
    p, g = si.p, si.grid
    dtype, shape = uIceC.dtype, tuple(uIceC.shape)
    nyp, nxp = shape
    eta, zeta, press = (torch.empty_like(uIceC) for _ in range(3))
    visc_in = dict(uC=uIceC, vC=vIceC, press0=press0, zMax=zMax,
                   heffm=si.HEFFM, recip_dxF=g.recip_dxF,
                   recip_dyF=g.recip_dyF, recip_dyU=g.recip_dyU,
                   recip_dxV=g.recip_dxV, rAz=g.rAz, recip_rA=g.recip_rA)
    refuse_grad("seaice_lsr_visc", **visc_in)
    visc_out = dict(eta=eta, zeta=zeta, press=press)
    kernels.check_fields(dtype, shape, **visc_in, **visc_out)
    table = kernels.pointer_table(list(visc_in.values())
                                  + list(visc_out.values()))
    recip_e2 = 1.0 / (p.eccen * p.eccen)
    params = kernels.doubles([p.zetaMin, p.deltaMin, recip_e2,
                              p.pressReplFac, 0.0])
    kernels.launch("seaice_lsr_visc", dtype, table, len(table), params,
                   len(params), nyp, nxp)
    return eta, zeta, press


def lsr_coeffs(si, eta, zeta, press, uIce, vIce, uIceC, vIceC, uVel0, vVel0,
               fxTmp, fyTmp, areaW, areaS, massC, massU, massV) -> dict:
    """seaice_lsr_coeffs (model/seaice.py:_coeffs_plain): the dict of the
    ten coefficient fields, rhsU, rhsV and dwatn."""
    p, g = si.p, si.grid
    dtype, shape = uIce.dtype, tuple(uIce.shape)
    nyp, nxp = shape

    out = {k: torch.empty_like(uIce) for k in _PREP_OUT}
    co_in = dict(eta=eta, zeta=zeta, press=press, uIce=uIce, vIce=vIce,
                 uC=uIceC, vC=vIceC, uVel0=uVel0, vVel0=vVel0, fxTmp=fxTmp,
                 fyTmp=fyTmp, areaW=areaW, areaS=areaS, massC=massC,
                 massU=massU, massV=massV, fCori=g.fCori, yC=g.yC,
                 heffm=si.HEFFM, maskInC=g.maskInC, maskInW=g.maskInW,
                 maskInS=g.maskInS, maskU=si.seaiceMaskU,
                 maskV=si.seaiceMaskV, recip_dxF=g.recip_dxF,
                 recip_dyF=g.recip_dyF, recip_dxV=g.recip_dxV,
                 recip_dyU=g.recip_dyU, dxF=g.dxF, dyF=g.dyF, dxV=g.dxV,
                 dyU=g.dyU, recip_rAw=g.recip_rAw, recip_rAs=g.recip_rAs)
    refuse_grad("seaice_lsr_coeffs", **co_in)
    kernels.check_fields(dtype, shape, **co_in, **out)
    table = kernels.pointer_table(list(co_in.values()) + list(out.values()))
    rho = si.cfg.rhoConst
    params = kernels.doubles([
        math.cos(math.radians(p.waterTurnAngle)),
        math.sin(math.radians(p.waterTurnAngle)), 1.0 / p.deltaTdyn,
        p.waterDrag * rho, p.waterDrag_south * rho, p.dWatMin,
        p.dWatMin * p.dWatMin, 1.0 if p.scaleSurfStress else 0.0])
    kernels.launch("seaice_lsr_coeffs", dtype, table, len(table), params,
                   len(params), nyp, nxp)
    return out


def _check_ctrl(ctrl, wf, dtype):
    if not (ctrl.is_cuda and ctrl.dtype == torch.int32
            and ctrl.is_contiguous() and tuple(ctrl.shape) == (6,)):
        raise ValueError("ctrl: need a contiguous int32 CUDA tensor of "
                         "shape (6,)")
    kernels.check_tensors(dtype, wf=wf)
    kernels.check_shape("wf", wf, (4,))


def lsr_sweep(si, along_x: bool, k: int, c: dict, u, uTmp, ctrl, wf,
              cuu) -> None:
    """seaice_lsr_tridiag_u (along_x) or _v, half-sweep k, in place on u
    (model/seaice.py:lsr_sweep); cuu: the recursion's scratch [nyp, nxp]."""
    cfg = si.cfg
    dtype, shape = u.dtype, tuple(u.shape)
    mask = si.seaiceMaskU if along_x else si.seaiceMaskV
    ins = {n: c[n] for n in _SWEEP[along_x]}
    refuse_grad("seaice_lsr_tridiag", **ins, u=u, uTmp=uTmp, wf=wf)
    kernels.check_fields(dtype, shape, **ins, mask=mask, u=u, uTmp=uTmp,
                         cuu=cuu)
    _check_ctrl(ctrl, wf, dtype)
    table = kernels.pointer_table(list(ins.values()) + [mask])
    kernels.launch(f"seaice_lsr_tridiag_{'u' if along_x else 'v'}", dtype,
                   table, len(table), u.data_ptr(), uTmp.data_ptr(),
                   cuu.data_ptr(), ctrl.data_ptr(), wf.data_ptr(),
                   shape[1], cfg.olx, cfg.sNy, cfg.sNx, cfg.nSy, cfg.nSx,
                   int(k))


class Workspace:
    """The LSR loop's scratch on the card: the sweeps' recursion field and
    the check's two partial maxima per block with its last-block
    counter."""

    def __init__(self, si, like):
        nyp, nxp = like.shape
        blocks = -(-nxp // 32) * -(-nyp // 8)
        self.cuu = torch.empty_like(like)
        self.partials = torch.empty(2 * blocks, dtype=like.dtype,
                                    device=like.device)
        self.counter = torch.zeros(1, dtype=torch.int32, device=like.device)


def lsr_check(si, u, v, uTmp, vTmp, ctrl, wf, ws: Workspace) -> None:
    """seaice_lsr_check (model/seaice.py:lsr_check), in place."""
    cfg, p = si.cfg, si.p
    dtype, shape = u.dtype, tuple(u.shape)
    refuse_grad("seaice_lsr_check", u=u, v=v, uTmp=uTmp, vTmp=vTmp, wf=wf)
    kernels.check_fields(dtype, shape, u=u, v=v, uTmp=uTmp, vTmp=vTmp,
                         maskU=si.seaiceMaskU, maskV=si.seaiceMaskV)
    _check_ctrl(ctrl, wf, dtype)
    kernels.launch("seaice_lsr_check", dtype, u.data_ptr(), v.data_ptr(),
                   uTmp.data_ptr(), vTmp.data_ptr(),
                   si.seaiceMaskU.data_ptr(), si.seaiceMaskV.data_ptr(),
                   ctrl.data_ptr(), wf.data_ptr(), ws.partials.data_ptr(),
                   ws.counter.data_ptr(), cfg.ny, cfg.nx, cfg.olx,
                   int(p.SOLV_NCHECK), int(p.linearIterMax),
                   float(p.LSR_ERROR))


def _adv_table(si, ice):
    g = si.grid
    return dict(uIce=ice.uIce, vIce=ice.vIce, maskW=si.SIMaskU,
                maskS=si.SIMaskV, maskInC=si.maskInCx, recip_rA=g.recip_rA,
                recip_dxC=g.recip_dxC, recip_dyC=g.recip_dyC, dxG=g.dxG,
                dyG=g.dyG, heffm=si.HEFFM)


def advect_x(si, ice, src, dst) -> None:
    """seaice_advect_x: dst = the X-updated HEFF, AREA, HSNOW ([3, nyp,
    nxp] each)."""
    p = si.p
    ins = _adv_table(si, ice)
    dtype, shape = src.dtype, tuple(ice.HEFF.shape)
    refuse_grad("seaice_advect_x", **ins, src=src)
    kernels.check_fields(dtype, shape, **ins)
    kernels.check_fields(dtype, (3,) + shape, src=src, dst=dst)
    table = kernels.pointer_table(list(ins.values()))
    kernels.launch("seaice_advect_x", dtype, table, len(table),
                   src.data_ptr(), dst.data_ptr(), shape[0], shape[1],
                   si.cfg.olx, int(p.advSchHeff), float(p.deltaTtherm))


def advect_y(si, ice, fld, localT, dst) -> None:
    """seaice_advect_y: dst = HEFFM (fld + dt g) on the interior, fld on
    the halo."""
    p = si.p
    ins = _adv_table(si, ice)
    dtype, shape = fld.dtype, tuple(ice.HEFF.shape)
    refuse_grad("seaice_advect_y", **ins, fld=fld, localT=localT)
    kernels.check_fields(dtype, shape, **ins)
    kernels.check_fields(dtype, (3,) + shape, fld=fld, localT=localT, dst=dst)
    table = kernels.pointer_table(list(ins.values()))
    kernels.launch("seaice_advect_y", dtype, table, len(table),
                   fld.data_ptr(), localT.data_ptr(), dst.data_ptr(),
                   shape[0], shape[1], si.cfg.olx, int(p.advSchHeff),
                   float(p.deltaTtherm), float(p.diffKhHeff),
                   float(p.diffKhArea), float(p.diffKhSnow))


def advect(si, ice):
    """seaice_advect's two launches (model/seaice.py:advdiff): (HEFF, AREA,
    HSNOW)."""
    fld = torch.stack([ice.HEFF, ice.AREA, ice.HSNOW])
    localT = torch.empty_like(fld)
    out = torch.empty_like(fld)
    advect_x(si, ice, fld, localT)
    advect_y(si, ice, fld, localT, out)
    return out.unbind(0)


def thermo_params(si) -> list:
    """seaice_thermo.cu:ThermoParams, folded in double as the JAX code
    folds its Python constants."""
    p, cfg = si.p, si.cfg
    c2k = cfg.celsius2K
    lnTEN = math.log(10.0)
    aa1, aa2, bb1, Ppascals = 2663.5, 12.537, 0.622, 100000.0
    cc0 = math.exp(aa2 * lnTEN)
    QI = p.rhoIce * p.lhFusion
    convertQ2HI = p.deltaTtherm / QI
    convertPRECIP2HI = p.deltaTtherm * cfg.rhoConstFresh / p.rhoIce
    ICE2SNOW = p.rhoIce / p.rhoSnow
    denom = 2.0 * sum((it + 1) * p.pdf[it] for it in range(p.multDim)) - 1.0
    lhSublim = p.lhEvap + p.lhFusion
    pdf = list(p.pdf) + [0.0] * (16 - p.multDim)
    vals = [
        c2k, p.MIN_LWDOWN, p.MIN_ATEMP, p.dTempFrz_dS, p.tempFrz0,
        p.snow_emiss, p.ice_emiss, p.boltzmann, c2k + p.wetAlbTemp,
        p.wetIceAlb_south, p.dryIceAlb_south, p.wetIceAlb, p.dryIceAlb,
        p.wetSnowAlb_south, p.drySnowAlb_south, p.wetSnowAlb, p.drySnowAlb,
        1.0 / p.snowThick, p.snowThick, p.shortwave,
        p.iceConduct * p.snowConduct, p.snowConduct, p.iceConduct, -aa1,
        aa2, lnTEN, bb1, Ppascals, 1.0 - bb1, aa1,
        cc0 * aa1 * bb1 * Ppascals * lnTEN, cc0 * (1.0 - bb1),
        p.dalton * lhSublim * p.rhoAir, p.dalton * p.cpAir * p.rhoAir, c2k,
        lhSublim, p.EPS, p.area_reg ** 2, p.hice_reg ** 2, 1.0 / denom,
        convertQ2HI, p.deltaTtherm / p.rhoIce, p.mcPheePiston,
        p.frazilFrac * float(cfg.delR[0]) / p.deltaTtherm, p.mcPheeTaper,
        1.0 if p.mcPheeStepFunc else 0.0,
        -(cfg.HeatCapacity_Cp * cfg.rhoConst * (1.0 / QI)), p.deltaTtherm,
        1.0 / ICE2SNOW, ICE2SNOW, convertPRECIP2HI, -convertPRECIP2HI,
        1.0 if p.doOpenWaterGrowth else 0.0,
        1.0 if p.doOpenWaterMelt else 0.0, si.SWFrac, p.rhoSnow, p.rhoIce,
        cfg.rhoConst, 1.0 if p.useFlooding else 0.0, 1.0 / p.HO_south,
        1.0 / p.HO, float(p.areaGainFormula), float(p.areaLossFormula),
        p.area_max, denom / p.multDim, p.salt0, 1.0 / p.deltaTtherm,
        1.0 / convertQ2HI, 1.0 / convertPRECIP2HI, cfg.rhoConstFresh,
        p.area_floor, 1.0 if p.useMultDimSnow else 0.0] + pdf
    return vals


def thermo(si, ice, forc, theta0, salt0):
    """seaice_thermo (model/seaice.py:thermo): (ice', {Qnet, Qsw, EmPmR,
    saltFlux})."""
    p, g = si.p, si.grid
    dtype, shape = ice.HEFF.dtype, tuple(ice.HEFF.shape)
    ins = dict(heff=ice.HEFF, hsnow=ice.HSNOW, area=ice.AREA,
               tices=ice.TICES, atemp=forc.atemp, aqh=forc.aqh,
               precip=forc.precip, swdown=forc.swdown, lwdown=forc.lwdown,
               runoff=forc.runoff, wspeed=forc.wspeed, evap=forc.evap,
               qnet=forc.Qnet, qsw=forc.Qsw, empmr=forc.EmPmR,
               saltflux=forc.saltFlux, theta0=theta0, salt0=salt0,
               heffm=si.HEFFM, yC=g.yC)
    outs = dict(heff_o=torch.empty_like(ice.HEFF),
                hsnow_o=torch.empty_like(ice.HEFF),
                area_o=torch.empty_like(ice.HEFF),
                tices_o=torch.empty_like(ice.TICES),
                qnet_o=torch.empty_like(ice.HEFF),
                qsw_o=torch.empty_like(ice.HEFF),
                empmr_o=torch.empty_like(ice.HEFF),
                saltflux_o=torch.empty_like(ice.HEFF))
    refuse_grad("seaice_thermo", **ins)
    kernels.check_tensors(dtype, **ins, **outs)
    for name, t in {**ins, **outs}.items():
        want = (p.multDim,) + shape if name.startswith("tices") else shape
        kernels.check_shape(name, t, want)
    table = kernels.pointer_table(list(ins.values()) + list(outs.values()))
    params = kernels.doubles(thermo_params(si))
    kernels.launch("seaice_thermo", dtype, table, len(table), params,
                   len(params), shape[0], shape[1], si.cfg.olx,
                   int(p.multDim), int(p.IMAX_TICE))
    ice = ice._replace(HEFF=outs["heff_o"], HSNOW=outs["hsnow_o"],
                       AREA=outs["area_o"], TICES=outs["tices_o"])
    return ice, {"Qnet": outs["qnet_o"], "Qsw": outs["qsw_o"],
                 "EmPmR": outs["empmr_o"], "saltFlux": outs["saltflux_o"]}


# ---------------------------------------------------------------------
# seaice_evp_stress, seaice_evp_uv: an EVP subcycle in two launches,
# the whole loop enqueued by evp_loop
# ---------------------------------------------------------------------
def _evp_variant(si):
    """The template flags (adaptive, revised-or-adaptive denominators) and
    the parameter arrays of the two launches (seaice_evp.cu:
    EvpStressParams, EvpUvParams)."""
    p, k = si.p, si._evp_factors()
    rho = si.cfg.rhoConst
    stress = kernels.doubles([
        k.recip_ecc2, p.deltaMin, p.pressReplFac, 1.0 - p.pressReplFac,
        k.cfac, p.aEVPalphaMin, p.evpAlpha, k.rev, k.recip_rev, k.ecc2])
    recip_dt = 1.0 / p.deltaTdyn
    uv = kernels.doubles([
        k.rev, k.recip_rev, k.ecc2, p.evpBeta, recip_dt, k.star,
        k.star * recip_dt, math.cos(math.radians(p.waterTurnAngle)),
        math.sin(math.radians(p.waterTurnAngle)), p.waterDrag * rho,
        p.waterDrag_south * rho, p.dWatMin, p.dWatMin * p.dWatMin])
    return int(k.adaptive), int(k.rev_den), stress, uv


def _stress_ins(si, u, v, s1, s2, press0, massC) -> dict:
    g = si.grid
    return dict(u=u, v=v, s1=s1, s2=s2, press0=press0, massC=massC,
                heffm=si.HEFFM, recip_dxF=g.recip_dxF, recip_dyF=g.recip_dyF,
                recip_dyU=g.recip_dyU, recip_dxV=g.recip_dxV, rAz=g.rAz,
                recip_rA=g.recip_rA)


def _uv_ins(si, u, v, s12, s1, s2, zetaC, alphaC, fixed: dict,
            setup: dict) -> dict:
    g = si.grid
    return dict(u=u, v=v, uNm1=fixed["uNm1"], vNm1=fixed["vNm1"], s12=s12,
                s1=s1, s2=s2, zeta=zetaC, alpha=alphaC,
                **{k: fixed[k] for k in ("uVel0", "vVel0", "forcex0",
                                         "forcey0", "massC", "massU",
                                         "massV")},
                **{k: setup[k] for k in ("areaW", "areaS", "locMaskU",
                                         "locMaskV", "sumNorm")},
                fCori=g.fCori, yC=g.yC, maskInW=g.maskInW, maskInS=g.maskInS,
                heffm=si.HEFFM, maskU=si.seaiceMaskU, maskV=si.seaiceMaskV,
                recip_dyU=g.recip_dyU, recip_dxV=g.recip_dxV, dxV=g.dxV,
                dyU=g.dyU, dyF=g.dyF, dxF=g.dxF, recip_rAw=g.recip_rAw,
                recip_rAs=g.recip_rAs)


def evp_loop(si, u, v, s1, s2, s12, press0, fixed: dict, setup: dict,
             n: int):
    """SeaIce.evp's n subcycles on the card (model/seaice.py:evp; twin
    SeaIce._evp_loop_plain, with the same arguments but `si`): the
    inputs are checked and both launches' pointer tables built once, then
    all 2 n launches are enqueued with no host read, the stresses and
    velocities ping-ponging between two sets of buffers; the last launch
    writes dwatn and the divergence. Returns (uIce, vIce, dwatn, sigma
    [3, nyp, nxp], stressDivX, stressDivY)."""
    dtype, shape = u.dtype, tuple(u.shape)
    ins_a = _stress_ins(si, u, v, s1, s2, press0, fixed["massC"])
    ins_b = _uv_ins(si, u, v, s12, s1, s2, u, u, fixed, setup)
    refuse_grad("seaice_evp", **{**ins_a, **ins_b})
    kernels.check_fields(dtype, shape, **{**ins_a, **ins_b})
    adaptive, rev_den, params_a, params_b = _evp_variant(si)
    uv = torch.empty((2, 2) + shape, dtype=dtype, device=u.device)
    sig = torch.empty((2, 3) + shape, dtype=dtype, device=u.device)
    zeta, alpha, dwatn, divX, divY = torch.empty((5,) + shape, dtype=dtype,
                                                 device=u.device).unbind(0)
    kernels.check_fields(dtype, (2, 2) + shape, uv=uv)
    kernels.check_fields(dtype, (2, 3) + shape, sig=sig)

    def tables(src, dst):
        """The two launches' tables from the state `src` (u, v, s1, s2,
        s12) into the buffers of set `dst`."""
        a = {**ins_a, "u": src[0], "v": src[1], "s1": src[2], "s2": src[3]}
        out_a = [sig[dst, 0], sig[dst, 1], zeta, alpha]
        b = {**ins_b, "u": src[0], "v": src[1], "s12": src[4],
             "s1": sig[dst, 0], "s2": sig[dst, 1], "zeta": zeta,
             "alpha": alpha}
        out_b = [uv[dst, 0], uv[dst, 1], sig[dst, 2], dwatn, divX, divY]
        return (kernels.pointer_table(list(a.values()) + out_a),
                kernels.pointer_table(list(b.values()) + out_b))

    def state(k):
        return (uv[k, 0], uv[k, 1], sig[k, 0], sig[k, 1], sig[k, 2])

    # subcycle 0 reads the inputs into set 0; then set 0 -> 1, 1 -> 0, ...
    plan = [tables((u, v, s1, s2, s12), 0), tables(state(0), 1),
            tables(state(1), 0)]
    cfg = si.cfg
    nyp, nxp = shape
    for it in range(n):
        ta, tb = plan[0 if it == 0 else 1 + (it - 1) % 2]
        kernels.launch("seaice_evp_stress", dtype, ta, len(ta), params_a,
                       len(params_a), nyp, nxp, adaptive, rev_den)
        kernels.launch("seaice_evp_uv", dtype, tb, len(tb), params_b,
                       len(params_b), cfg.ny, cfg.nx, cfg.olx, adaptive,
                       rev_den, int(it == n - 1))
    k = (n - 1) % 2
    return uv[k, 0], uv[k, 1], dwatn, sig[k], divX, divY


def freedrift(si, heff, uVel0, vVel0, forcex0, forcey0):
    """seaice_freedrift (model/seaice.py:_freedrift_plain): (uIce, vIce)
    with both halo fills."""
    g, p, cfg = si.grid, si.p, si.cfg
    ins = dict(heff=heff, uVel0=uVel0, vVel0=vVel0, forcex0=forcex0,
               forcey0=forcey0, fCori=g.fCori, yC=g.yC, maskU=si.SIMaskU,
               maskV=si.SIMaskV)
    refuse_grad("seaice_freedrift", **ins)
    outs = [torch.empty_like(heff) for _ in range(2)]
    kernels.check_fields(heff.dtype, tuple(heff.shape), **ins, uo=outs[0],
                         vo=outs[1])
    params = kernels.doubles([p.rhoIce, cfg.rhoConst, p.waterDrag,
                              p.waterDrag_south])
    table = kernels.pointer_table(list(ins.values()) + outs)
    kernels.launch("seaice_freedrift", heff.dtype, table, len(table), params,
                   len(params), cfg.ny, cfg.nx, cfg.olx)
    return tuple(outs)
