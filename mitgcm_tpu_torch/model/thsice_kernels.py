"""The card side of model/thsice.py: the wrapper that checks its inputs and
launches kernel TH (kernels/csrc/thsice.cu), one thsice step in one
launch. model/thsice.py:ThSIce.advance calls it for CUDA tensors; it
mirrors the twin ThSIce.step bit for bit. Kernel TH has no backward
kernel, so the step refuses an input that requires grad (`refuse_grad`)
on either path."""

from __future__ import annotations

import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.model.thsice import (EXF_BULK as B, TH_FIELDS,
                                           TH_FLUXES, TH_FORCING)

# the th* fields that kernel TH reads, in the order of thsice.cu:ThArgs
# (the layer temperatures and the salt flux are written, not read)
_TH_IN = ("thIceMask", "thIceH", "thSnowH", "thSnowAge", "thTsrf",
          "thQice1", "thQice2")


def refuse_grad(th, forc, *tensors) -> None:
    """Raise ValueError naming the inputs of a thsice step that require
    grad: kernel TH writes through ctypes into fresh outputs and has no
    backward kernel."""
    named = {**th, **{k: getattr(forc, k) for k in TH_FORCING},
             **{f"arg{i}": t for i, t in enumerate(tensors)}}
    grads = [n for n, t in named.items()
             if isinstance(t, torch.Tensor) and t.requires_grad]
    if grads:
        raise ValueError(f"thsice_step: {grads} require grad; kernel TH "
                         "has no backward kernel yet")


def th_params(ts) -> list:
    """thsice.cu:ThParams, folded in double as the JAX code folds its
    Python constants (mitgcm_tpu/model/thsice.py; model/thsice.py's
    twin)."""
    p, cfg = ts.p, ts.cfg
    dtT, dt = p.thSIce_dtTemp, p.thSIce_deltaT
    lath = B["flamb"] + B["flami"]
    powerLaw = 5
    rec_pLaw = 1.0 / powerLaw
    c1Mlt = p.fracEnMelt ** rec_pLaw
    c2Mlt = (1.0 - p.fracEnMelt) ** rec_pLaw
    aMlt = (c1Mlt + c2Mlt) / (p.hThickIce - p.hThinIce)
    c1Frz = p.fracEnFreez ** rec_pLaw
    c2Frz = (1.0 - p.fracEnFreez) ** rec_pLaw
    aFrz = (c1Frz + c2Frz) / (p.hThickIce - p.hThinIce)
    tEv = cfg.temp_EvPrRn
    vals = dict(
        # albedo
        albIceMax=p.albIceMax, albIceMin_m_Max=p.albIceMin - p.albIceMax,
        hAlbIce=p.hAlbIce, snowAlbCold=1.0 if p.tempSnowAlb < 0.0 else 0.0,
        tempSnowAlb=p.tempSnowAlb, albColdSnow=p.albColdSnow,
        albWarm_m_Cold=p.albWarmSnow - p.albColdSnow,
        albOldSnow=p.albOldSnow, hAlbSnow=p.hAlbSnow,
        # get_exf
        cen2kel=B["cen2kel"], cvapor_fac_ice=B["cvapor_fac_ice"],
        neg_cvapor_exp_ice=-B["cvapor_exp_ice"],
        cvapor_exp_ice=B["cvapor_exp_ice"], atmrho=B["atmrho"],
        gamma_ht=B["gamma_blk"] * B["ht"],
        stefanBoltzmann=B["stefanBoltzmann"],
        tau_c=B["atmrho"] * B["exf_iceCe"], neg_lath=-lath,
        hs_c=B["atmcp"] * B["atmrho"] * B["exf_iceCh"],
        dfshdT_c=-B["atmcp"] * B["atmrho"] * B["exf_iceCh"],
        snow_emiss=B["snow_emissivity"], ice_emiss=B["ice_emissivity"],
        # solve4temp
        hIceMin=p.hIceMin,
        recip_dhSnowLin=1.0 / p.dhSnowLin if p.dhSnowLin > 0.0 else 0.0,
        dhSnowLin=p.dhSnowLin, i0swFrac=p.i0swFrac, neg_ksolar=-p.ksolar,
        k12_num=4.0 * p.kIce * p.kSnow, kSnow=p.kSnow,
        four_kIce=4.0 * p.kIce, two_kIce=2.0 * p.kIce,
        b1_c=(p.cpWater - p.cpIce) * p.Tmlt1, Lfresh=p.Lfresh,
        four_a1c1=4.0 * p.cpIce * (p.Lfresh * p.Tmlt1), cpIce=p.cpIce,
        rci=p.rhoi * p.cpIce, two_dt=2.0 * dtT, four_dt=4.0 * dtT,
        six_dt=6.0 * dtT, rhoiLfTm=p.rhoi * p.Lfresh * p.Tmlt1,
        rhoiLf=p.rhoi * p.Lfresh, Tmlt1=p.Tmlt1, Terrmax=p.Terrmax,
        q1_c=-p.cpWater * p.Tmlt1, neg_cpIce=-p.cpIce,
        # step
        rhofw=cfg.rhoConstFresh or cfg.rhoConst, c2k=cfg.celsius2K,
        useEvPrRn=0.0 if tEv is None else 1.0,
        temp_EvPrRn=0.0 if tEv is None else tEv,
        HeatCapacity_Cp=cfg.HeatCapacity_Cp, neg_mu_Tf=-p.mu_Tf, dt=dt,
        ageFac=1.0 - dt / p.snowAgTime,
        neg_snowFac=-(dt / (p.rhos * p.hNewSnowAge)),
        cpWater_rhosw=p.cpWater * p.rhosw, ocean_deltaT=p.ocean_deltaT,
        drF_ks=ts.drF_ks,
        # calc_thickn
        cpchr=p.cpWater * p.rhosw * p.bMeltCoef,
        lowIcFrac1=p.iceMaskMin * 1.01,
        lowIcFrac_den=p.iceMaskMin * 1.10 - p.iceMaskMin, aMlt=aMlt,
        hMlt=p.hThinIce + c2Mlt / aMlt, aFrz=aFrz,
        hFrz=p.hThinIce + c2Frz / aFrz, fracEnMelt=p.fracEnMelt,
        fracEnFreez=p.fracEnFreez, iceMaskMax=p.iceMaskMax, rhos=p.rhos,
        rhoi=p.rhoi, saltIce=p.saltIce, rq_snow=p.rhos * p.qsnow,
        floodFac=p.floodFac, rhosw=p.rhosw, hsMax=p.hsMax, hiMax=p.hiMax,
        rhoi_half=p.rhoi * 0.5, iceMaskMin=p.iceMaskMin,
        meltFrac=0.0 if p.fracEnMelt == 0.0 else 1.0,
        # extend
        hIceMin_maskMin=p.hIceMin * p.iceMaskMin, hThinIce=p.hThinIce,
        hNewIceMax=p.hNewIceMax, hiMax_maskMax=p.hiMax * p.iceMaskMax,
        neg_rhoi=-p.rhoi, neg_rhoi_saltIce=-(p.rhoi * p.saltIce))
    return list(vals.values())


def thsice_step(ts, th, forc, theta_ks, salt_ks, uVel_ks, vVel_ks,
                hFacC_ks, Qnet, Qsw, EmPmR, saltFlux):
    """Kernel TH (model/thsice.py:ThSIce.step): (th', {Qnet, Qsw, EmPmR,
    saltFlux}), every field written on every padded cell, the halo cells
    as the fill makes them."""
    cfg = ts.cfg
    like = th["thIceMask"]
    dtype, shape = like.dtype, tuple(like.shape)
    ins = {**{k: th[k] for k in _TH_IN},
           **{k: getattr(forc, k) for k in TH_FORCING},
           "Qnet": Qnet, "Qsw": Qsw, "EmPmR": EmPmR, "theta": theta_ks,
           "salt": salt_ks, "uVel": uVel_ks, "vVel": vVel_ks,
           "hFacC": hFacC_ks}
    outs = {f"{k}_o": torch.empty_like(like)
            for k in TH_FIELDS + TH_FLUXES}
    kernels.check_fields(dtype, shape, **ins, **outs)
    # the step overwrites the salt flux without reading it
    kernels.check_shape("saltFlux", saltFlux, shape)
    table = kernels.pointer_table(list(ins.values()) + list(outs.values()))
    params = kernels.doubles(th_params(ts))
    kernels.launch("thsice_step", dtype, table, len(table), params,
                   len(params), shape[0], shape[1], cfg.oly, cfg.olx,
                   int(ts.p.nitMaxTsf))
    return ({k: outs[f"{k}_o"] for k in TH_FIELDS},
            {k: outs[f"{k}_o"] for k in TH_FLUXES})
