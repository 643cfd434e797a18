// Kernel TH, thsice_step: one step of Winton's three-layer thermodynamic
// sea ice (pkg/thsice), one cell a thread (in a header of its own for the
// tests' host check; thsice.cu holds the entry points).
//
// Replaces: mitgcm_tpu/model/thsice.py:ThSIce.step (:779-911) with albedo
// (:259), get_exf (:276), solve4temp (:317, nitMaxTsf masked iterations),
// calc_thickn (:442) and extend (:719), which XLA fused into pointwise
// passes over the 2-D fields on the TPU, and the 13 cyclic_fill_halo
// calls that end the step (:903-910).
//
// One launch a step, one thread for every padded cell, registers only: the
// thread of cell (j, i) computes the step of its interior source cell
// ((j - oly) mod ny + oly, (i - olx) mod nx + olx), so that the halo cells
// come out as the fill would make them and no fill is launched. The
// ocean's mixed-layer speed reads u at i + 1 and v at j + 1 of the source
// cell, inside the padded array for every interior cell. The surface
// temperature solve stops a cell's iterations at its first inactive one
// (|dTsrf| < Terrmax): under the JAX code's masks nothing of an inactive
// cell's carry changes again, so the break gives the same bits.
//
// Bound: a cell reads 22 fields and writes 13, 140 B in float32; it
// evaluates 2 exp for the albedo, 2 for the fluxes at 0 degC and 1 a live
// iteration, with about 90 other flops an iteration and 400 outside the
// loop, so the bytes bound it unless most cells iterate many times.
// Design: the order of every expression is the JAX code's, which the twin
// (model/thsice.py:ThSIce.step) replays: a Python-number constant folded
// on the host in double and cast to T as a Python number is, divisions
// kept as divisions, the power law's fifth power multiplied out as
// integer_pow does, no contraction (--fmad=false).

#pragma once

#include <cstring>

#include "gad_advect.cuh"

namespace mitgcm {

// the constants, folded on the host in double as the JAX code folds them
// (model/thsice_kernels.py:th_params)
struct ThParams {
  // albedo
  double albIceMax, albIceMin_m_Max, hAlbIce, snowAlbCold, tempSnowAlb,
      albColdSnow, albWarm_m_Cold, albOldSnow, hAlbSnow;
  // get_exf
  double cen2kel, cvapor_fac_ice, neg_cvapor_exp_ice, cvapor_exp_ice,
      atmrho, gamma_ht, stefanBoltzmann, tau_c, neg_lath, hs_c, dfshdT_c,
      snow_emiss, ice_emiss;
  // solve4temp
  double hIceMin, recip_dhSnowLin, dhSnowLin, i0swFrac, neg_ksolar, k12_num,
      kSnow, four_kIce, two_kIce, b1_c, Lfresh, four_a1c1, cpIce, rci,
      two_dt, four_dt, six_dt, rhoiLfTm, rhoiLf, Tmlt1, Terrmax, q1_c,
      neg_cpIce;
  // step
  double rhofw, c2k, useEvPrRn, temp_EvPrRn, HeatCapacity_Cp, neg_mu_Tf,
      dt, ageFac, neg_snowFac, cpWater_rhosw, ocean_deltaT, drF_ks;
  // calc_thickn
  double cpchr, lowIcFrac1, lowIcFrac_den, aMlt, hMlt, aFrz, hFrz,
      fracEnMelt, fracEnFreez, iceMaskMax, rhos, rhoi, saltIce, rq_snow,
      floodFac, rhosw, hsMax, hiMax, rhoi_half, iceMaskMin, meltFrac;
  // extend
  double hIceMin_maskMin, hThinIce, hNewIceMax, hiMax_maskMax, neg_rhoi,
      neg_rhoi_saltIce;
};

template <typename T>
struct ThArgs {
  // in, [nyp, nxp]: the th* fields that a step reads (the layer
  // temperatures and the ocean's salt flux are written, not read), the
  // atmosphere, the ocean's Qnet, Qsw and EmPmR, the surface level's
  // theta, salt, u, v and hFacC
  const T *iceMask, *hIce, *hSnow, *snowAge, *tSrf, *qIce1, *qIce2, *atemp,
      *aqh, *lwdown, *swdown, *precip, *runoff, *wspeed, *qnet, *qsw, *empmr,
      *theta, *salt, *uVel, *vVel, *hFacC;
  // out, [nyp, nxp]
  T *iceMask_o, *hIce_o, *hSnow_o, *snowAge_o, *tSrf_o, *tIce1_o, *tIce2_o,
      *qIce1_o, *qIce2_o, *qnet_o, *qsw_o, *empmr_o, *saltflux_o;
};
constexpr int kThPointers = 35;
constexpr int kThParams = 84;

// get_exf's four fluxes over ice at surface temperature tsfCel
template <typename T>
struct ExfFlux {
  T flx, dFdT, evap, dEdT;
};

template <typename T>
__device__ __forceinline__ ExfFlux<T> th_get_exf(const ThParams& q,
                                                 bool ok, T hSnow, T atemp,
                                                 T aqh, T lwdown, T wsm,
                                                 T tsfCel) {
  const T emiss = hSnow > T(0.3) ? T(q.snow_emiss) : T(q.ice_emiss);
  const T Tsf = tsfCel + T(q.cen2kel);
  const T Ts2 = Tsf * Tsf;
  const T ssq =
      (T(q.cvapor_fac_ice) * exp(T(q.neg_cvapor_exp_ice) / Tsf)) /
      T(q.atmrho);
  const T deltap = (atemp + T(q.gamma_ht)) - Tsf;
  const T delq = aqh - ssq;
  const T dEvdT0 = (ssq * T(q.cvapor_exp_ice)) / Ts2;
  const T flwup = ((emiss * T(q.stefanBoltzmann)) * Ts2) * Ts2;
  const T dflwupdT = (((T(4.0) * emiss) * T(q.stefanBoltzmann)) * Ts2) * Tsf;
  const T flwNet_dwn = emiss * lwdown - flwup;
  const T tau = T(q.tau_c) * wsm;
  const T evapLoc = -tau * delq;
  const T hl = T(q.neg_lath) * evapLoc;
  const T hs = (T(q.hs_c) * wsm) * deltap;
  const T dEvdT = tau * dEvdT0;
  const T dflhdT = T(q.neg_lath) * dEvdT;
  const T dfshdT = T(q.dfshdT_c) * wsm;
  const T flxExcSw = (flwNet_dwn + hs) + hl;
  const T dFlxdT = (-dflwupdT + dfshdT) + dflhdT;
  const T z = T(0);
  return {ok ? flxExcSw : z, ok ? dFlxdT : z, ok ? evapLoc : z,
          ok ? dEvdT : z};
}

template <typename T>
__global__ void thsice_step_kernel(const ThArgs<T> a, const ThParams q,
                                   int nyp, int nxp, int oly, int olx,
                                   int nitMaxTsf) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const int ny = nyp - 2 * oly, nx = nxp - 2 * olx;
  // the interior source cell of the fill (ops/stencil.py:_gather)
  const int js = ((j - oly) % ny + ny) % ny + oly;
  const int is = ((i - olx) % nx + nx) % nx + olx;
  const size_t p = static_cast<size_t>(j) * nxp + i;
  const size_t s = static_cast<size_t>(js) * nxp + is;
  const T zero = T(0), one = T(1);

  const T iceMask = a.iceMask[s];
  T hIce = a.hIce[s], hSnow = a.hSnow[s], snowAge = a.snowAge[s];
  T tSrf = a.tSrf[s];
  T q1 = a.qIce1[s], q2 = a.qIce2[s];
  const T atemp = a.atemp[s], aqh = a.aqh[s], lwdown = a.lwdown[s];
  const T swdown = a.swdown[s], precip = a.precip[s], runoff = a.runoff[s];
  const T wsm = a.wspeed[s];
  T Qnet = a.qnet[s], Qsw = a.qsw[s], EmPmR = a.empmr[s];

  // --- THSICE_GET_OCEAN ---
  const T hOceMxL = T(q.drF_ks) * a.hFacC[s];
  const T tOce = a.theta[s], sOce = a.salt[s];
  const T u = a.uVel[s], ue = a.uVel[s + 1];
  const T v = a.vVel[s], vn = a.vVel[s + nxp];
  const T u2 = u * u + ue * ue;
  const T v2 = v * v + vn * vn;
  const T v2oc = (u2 + v2) * T(0.5);

  // --- THSICE_MAP_EXF ---
  const T totPrc = (precip + runoff) * T(q.rhofw);
  const bool on = iceMask > zero;
  const T snowPrc = (on && atemp <= T(q.c2k)) ? precip * T(q.rhofw) : zero;
  T qPrcRnO = zero;
  if (q.useEvPrRn != 0.0) {
    qPrcRnO = (T(q.HeatCapacity_Cp) *
               ((atemp - T(q.c2k)) - T(q.temp_EvPrRn))) *
                  (precip * T(q.rhofw) - snowPrc) +
              ((T(q.HeatCapacity_Cp) * (tOce - T(q.temp_EvPrRn))) * runoff) *
                  T(q.rhofw);
  }

  // --- THSICE_STEP_TEMP: albedo ---
  T alb;
  {
    const T albice = T(q.albIceMax) +
                     T(q.albIceMin_m_Max) * exp(-hIce / T(q.hAlbIce));
    T albNewSnow;
    if (q.snowAlbCold != 0.0) {
      albNewSnow =
          T(q.albColdSnow) +
          T(q.albWarm_m_Cold) *
              nmin(nmax(one - tSrf / T(q.tempSnowAlb), zero), one);
    } else {
      albNewSnow = T(q.albColdSnow);
    }
    const T albsno =
        T(q.albOldSnow) + (albNewSnow - T(q.albOldSnow)) *
                              exp((T(-0.2) * snowAge) / T(86400.0));
    const T albedo =
        albsno + (albice - albsno) * exp(-hSnow / T(q.hAlbSnow));
    alb = on ? albedo : zero;
  }
  T icFlxSW = on ? swdown * (one - alb) : swdown;
  const T tFrzOce = on ? T(q.neg_mu_Tf) * sOce : zero;


  // --- solve4temp ---
  T tIc1, tIc2, sHeat, flxCnB, evpAtm;
  {
    const T flxSW = icFlxSW;
    const T hIceS = on ? nmax(hIce, T(q.hIceMin)) : one;
    const T icm = on ? iceMask : one;
    const T frsnow_r = (hSnow * T(q.recip_dhSnowLin)) / icm;
    const T frsnow =
        hSnow > icm * T(q.dhSnowLin) ? one : sqrt(nmax(frsnow_r, zero));
    const T fswpen = (flxSW * (one - frsnow)) * T(q.i0swFrac);
    const T fswocn = fswpen * exp(T(q.neg_ksolar) * hIceS);
    const T fswint = fswpen - fswocn;
    sHeat = flxSW - fswpen;
    const T k12 =
        T(q.k12_num) / (T(q.kSnow) * hIceS + T(q.four_kIce) * hSnow);
    const T k32 = T(q.two_kIce) / hIceS;
    const T b1 = (q1 + T(q.b1_c)) - T(q.Lfresh);
    const T disc = sqrt(nmax(b1 * b1 - T(q.four_a1c1), zero));
    tIc1 = on ? (T(0.5) * (-b1 - disc)) / T(q.cpIce) : zero;
    tIc2 = on ? (T(q.Lfresh) - q2) / T(q.cpIce) : zero;
    const T tIc1s = on ? nmin(tIc1, T(-1.0e-10)) : T(-1.0);
    const T rciH = T(q.rci) * hIceS;
    const T den6 = T(q.six_dt) * k32 + rciH;
    const T a10 =
        rciH / T(q.two_dt) + (k32 * (T(q.four_dt) * k32 + rciH)) / den6;
    const T b10 =
        ((-hIceS) * (T(q.rci) * tIc1 + T(q.rhoiLfTm) / tIc1s)) /
            T(q.two_dt) -
        (k32 * ((T(q.four_dt) * k32) * tFrzOce + rciH * tIc2)) / den6 -
        fswint;
    const T c10 = ((T(q.rhoiLf) * hIceS) * T(q.Tmlt1)) / T(q.two_dt);
    const bool ok = on && atemp > zero;
    const ExfFlux<T> f0 =
        th_get_exf(q, ok, hSnow, atemp, aqh, lwdown, wsm, zero);

    // the masked fixed-iteration solve, each cell to its freeze-out
    T tSrf_c = tSrf, tIc1_c = tIc1, dTsrf_c = T(q.Terrmax);
    T flxT_c = zero, evapT_c = zero, dFdT_c = zero, dEdT_c = zero;
    bool active = on;
    for (int it = 0; it < nitMaxTsf && active; ++it) {
      const ExfFlux<T> f =
          th_get_exf(q, ok, hSnow, atemp, aqh, lwdown, wsm, tSrf_c);
      const T flxNet = sHeat + f.flx;
      const T den = k12 - f.dFdT;
      const T a1i = a10 - (k12 * f.dFdT) / den;
      const T b1i = b10 - (k12 * (flxNet - f.dFdT * tSrf_c)) / den;
      const T disc_i = sqrt(nmax(b1i * b1i - (T(4.0) * a1i) * c10, zero));
      const T t1 = (-(b1i + disc_i)) / (T(2.0) * a1i);
      const T dTs = (flxNet + k12 * (t1 - tSrf_c)) / den;
      const T TsfTmp = tSrf_c + dTs;
      // the melting-surface branch: the surface held at 0 degC
      const T a1m = a10 + k12;
      const T disc_m = sqrt(nmax(b10 * b10 - (T(4.0) * a1m) * c10, zero));
      const T t1m = (-b10 - disc_m) / (T(2.0) * a1m);
      const bool melt = TsfTmp > zero;
      tIc1_c = melt ? t1m : t1;
      tSrf_c = melt ? zero : TsfTmp;
      flxT_c = melt ? f0.flx : f.flx;
      evapT_c = melt ? f0.evap : f.evap;
      dTsrf_c = melt ? zero : dTs;
      dFdT_c = f.dFdT;
      dEdT_c = f.dEdT;
      active = fabs(dTsrf_c) >= T(q.Terrmax);
    }
    tSrf = tSrf_c;
    tIc1 = tIc1_c;
    if (on)
      tIc2 = ((T(q.two_dt) * k32) * (tIc1 + T(2.0) * tFrzOce) +
              rciH * tIc2) /
             den6;
    const T fct = k12 * (tSrf - tIc1);
    flxCnB = on ? (T(q.four_kIce) * (tIc2 - tFrzOce)) / hIceS : zero;
    const T flxNet = (sHeat + flxT_c) + dFdT_c * dTsrf_c;
    evpAtm = on ? evapT_c + dEdT_c * dTsrf_c : zero;
    sHeat = on ? flxNet - fct : zero;
    const T tIc1s2 = on ? nmin(tIc1, T(-1.0e-10)) : T(-1.0);
    if (on) {
      q1 = (T(q.q1_c) + T(q.cpIce) * (T(q.Tmlt1) - tIc1)) +
           T(q.Lfresh) * (one - T(q.Tmlt1) / tIc1s2);
      q2 = T(q.neg_cpIce) * tIc2 + T(q.Lfresh);
    }
    icFlxSW = on ? fswocn : flxSW;
  }
  const T opFrac0 = one - iceMask;
  if (on) Qsw = opFrac0 * Qsw - iceMask * icFlxSW;

  // --- THSICE_STEP_FWD ---
  const T dt = T(q.dt);
  if (on) snowAge = dt + snowAge * T(q.ageFac);
  if (on && snowPrc > zero)
    snowAge = snowAge * exp(T(q.neg_snowFac) * snowPrc);
  // the unmasked freezing point (thsice_step_fwd.F:197)
  const T tFrz = T(q.neg_mu_Tf) * sOce;
  const T cphm = T(q.cpWater_rhosw) * hOceMxL;
  T fzMlOc = ((tFrz - tOce) * cphm) / T(q.ocean_deltaT);
  T icFrac = iceMask;
  T flx2oc = icFlxSW + qPrcRnO;
  T frw2oc = zero, fsalt = zero;

  // --- calc_thickn ---
  {
    T evapLoc = on ? evpAtm : zero;
    const T xM = T(q.aMlt) * (hIce - T(q.hMlt));
    const T xM2 = xM * xM;
    const T xxMlt = xM * (xM2 * xM2);
    const T xF = T(q.aFrz) * (hIce - T(q.hFrz));
    const T xF2 = xF * xF;
    const T xxFrz = xF * (xF2 * xF2);
    const T enFrcMlt = nmin(nmax(T(q.fracEnMelt) - xxMlt, zero), one);
    const T enFrcFrz = nmin(nmax(T(q.fracEnFreez) - xxFrz, zero), one);
    // Fbot: the ocean's heat flux to the ice base
    const bool frz = fzMlOc >= zero;
    const T fb_frz = icFrac < T(q.iceMaskMax) ? enFrcFrz * fzMlOc : fzMlOc;
    const T ustar = nmax(T(5.0e-3), sqrt(T(0.00536) * v2oc));
    const T fb_mlt =
        nmin(nmax((T(q.cpchr) * (tFrz - tOce)) * ustar, fzMlOc), zero);
    const T Fbot = on ? (frz ? fb_frz : fb_mlt) : zero;
    const T mwater0 = T(q.rhos) * hSnow + T(q.rhoi) * hIce;
    const T msalt0 = (T(q.rhoi) * hIce) * T(q.saltIce);
    // the lateral melt's energy fraction
    T frace = zero;
    if (q.meltFrac != 0.0) {
      frace = (icFrac - T(q.lowIcFrac1)) / T(q.lowIcFrac_den);
      frace = nmin(enFrcMlt, nmax(zero, frace));
    }
    const bool pos = sHeat > zero;
    T etop = (on && pos) ? ((one - frace) * sHeat) * dt : zero;
    const T etope = (on && pos) ? (frace * sHeat) * dt : zero;
    T esurp = (on && !pos) ? sHeat * dt : zero;
    T ebot = on ? (flxCnB - Fbot) * dt : zero;
    const T ebote = ebot > zero ? frace * ebot : zero;
    ebot = ebot - ebote;

    // top melt: snow, then layer 1, then layer 2
    T h1 = hIce * T(0.5), h2 = hIce * T(0.5);
    const T rqS = T(q.rq_snow);
    if (on && etop > zero && hSnow > zero) {
      const T rqh = rqS * hSnow;
      const bool less = etop < rqh;
      hSnow = less ? hSnow - etop / rqS : zero;
      etop = less ? zero : etop - rqh;
    }
    auto melt_top = [&](T& h, T qq) {
      if (on && etop > zero) {
        const T rq = T(q.rhoi) * (qq > zero ? qq : one);
        const T rqh = rq * h;
        const bool less = etop < rqh;
        h = less ? h - etop / rq : zero;
        etop = less ? zero : etop - rqh;
      } else if (on) {
        etop = zero;
      }
    };
    melt_top(h1, q1);
    melt_top(h2, q2);

    // bottom growth
    const T qbot = T(q.neg_cpIce) * tFrz + T(q.Lfresh);
    if (on && ebot < zero) {
      const T dhi = -ebot / (qbot * T(q.rhoi));
      const T hsum = h2 + dhi;
      q2 = (h2 * q2 + dhi * qbot) / (hsum > zero ? hsum : one);
      h2 = h2 + dhi;
      ebot = zero;
    }
    // bottom melt: layer 2, then layer 1, then snow
    auto melt_bot = [&](T& h, T qq) {
      if (on && ebot > zero && h > zero) {
        const T rq = T(q.rhoi) * (qq > zero ? qq : one);
        const T rqh = rq * h;
        const bool less = ebot < rqh;
        h = less ? h - ebot / rq : zero;
        ebot = less ? zero : ebot - rqh;
      }
    };
    melt_bot(h2, q2);
    melt_bot(h1, q1);
    if (on && ebot > zero && hSnow > zero) {
      const T rqh = rqS * hSnow;
      const bool less = ebot < rqh;
      hSnow = less ? hSnow - ebot / rqS : zero;
      ebot = less ? zero : ebot - rqh;
    }

    // the whole ice melts below hIceMin
    auto melt_all = [&]() {
      esurp = ((esurp - rqS * hSnow) - (T(q.rhoi) * q1) * h1) -
              (T(q.rhoi) * q2) * h2;
      hIce = zero;
      h1 = zero;
      h2 = zero;
      hSnow = zero;
      tSrf = zero;
      icFrac = zero;
      q1 = zero;
      q2 = zero;
    };
    if (on) hIce = h1 + h2;
    if (on && hIce < T(q.hIceMin) && (hIce + hSnow) > zero) melt_all();

    // the mass budget; the snowfall goes to the ocean where the ice went
    if (on)
      frw2oc = (mwater0 - (T(q.rhos) * hSnow + T(q.rhoi) * hIce)) / dt;
    if (on && hIce <= zero) {
      frw2oc = frw2oc + snowPrc;
      flx2oc = flx2oc - snowPrc * T(q.Lfresh);
    }
    // snowfall and snow sublimation
    const bool has_ice = on && hIce > zero;
    if (has_ice) hSnow = hSnow + (dt * snowPrc) / T(q.rhos);
    if (has_ice && hSnow > zero) {
      const T es = (evapLoc / T(q.rhos)) * dt;
      const bool subl_all = es > hSnow;
      const T evap_new =
          subl_all ? evapLoc - (hSnow * T(q.rhos)) / dt : zero;
      hSnow = subl_all ? zero : hSnow - es;
      evapLoc = evap_new;
    }
    // ice sublimation, layer 1 then layer 2
    auto subl = [&](T& h, T& qq) {
      if (on && hIce > zero && evapLoc > zero) {
        const T dhi = (evapLoc / T(q.rhoi)) * dt;
        const bool all_ = dhi >= h;
        if (all_) esurp = esurp - (h * T(q.rhoi)) * (qq - T(q.Lfresh));
        const T evap_n = all_ ? evapLoc - (h * T(q.rhoi)) / dt : zero;
        const T hq = h * qq - dhi * T(q.Lfresh);
        const T h_n = all_ ? zero : h - dhi;
        qq = all_ ? qq : hq / (h_n > zero ? h_n : one);
        h = h_n;
        evapLoc = evap_n;
      }
    };
    subl(h1, q1);
    subl(h2, q2);
    const bool was_ice = on && hIce > zero;
    if (was_ice) hIce = h1 + h2;
    if (was_ice && hIce > zero && hIce < T(q.hIceMin)) {
      frw2oc = frw2oc + (T(q.rhos) * hSnow + T(q.rhoi) * hIce) / dt;
      melt_all();
    }

    // snow-to-ice flooding
    const bool alive = on && hIce > zero;
    if (alive &&
        (hSnow > hIce * T(q.floodFac) || hSnow > T(q.hsMax))) {
      T dhs = ((hSnow - hIce * T(q.floodFac)) * T(q.rhoi)) / T(q.rhosw);
      dhs = nmax(hSnow - T(q.hsMax), dhs);
      const T dhi = (dhs * T(q.rhos)) / T(q.rhoi);
      const T rqh = (T(q.rhoi) * q1) * h1 + rqS * dhs;
      const T h1f = h1 + dhi;
      q1 = rqh / (T(q.rhoi) * (h1f > zero ? h1f : one));
      h1 = h1f;
      hIce = hIce + dhi;
      hSnow = hSnow - dhs;
    }
    // the hiMax cap
    if (alive && hIce > T(q.hiMax)) {
      const T chi = hIce - T(q.hiMax);
      h1 = h1 - chi * T(0.5);
      h2 = h2 - chi * T(0.5);
      frw2oc = frw2oc + (chi * T(q.rhoi)) / dt;
    }
    if (alive) hIce = h1 + h2;
    // Winton's reshaping into two equal layers
    if (alive && hIce > zero) {
      const T hlyr = hIce * T(0.5);
      const T hl_s = hlyr > zero ? hlyr : one;
      if (h1 > h2) {
        const T f1a = (h1 - hlyr) / hl_s;
        const T q2tmp = f1a * q1 + (one - f1a) * q2;
        const T qh2 = hlyr * q2;
        const T qhtot = h1 * q1 + h2 * q2;
        const T q1_keep = (qhtot - qh2) / hl_s;
        if (q2tmp > T(q.Lfresh))
          q2 = q2tmp;
        else
          q1 = q1_keep;
      } else {
        const T f1b = h1 / hl_s;
        q1 = f1b * q1 + (one - f1b) * q2;
      }
    }

    // the ocean's fluxes
    if (on && hIce <= zero) icFrac = zero;
    if (on) {
      flx2oc = (flx2oc + Fbot) + ((esurp + etop) + ebot) / dt;
      frw2oc = frw2oc - evapLoc;
      flx2oc = flx2oc + evapLoc * T(q.Lfresh);
      fsalt = (msalt0 - (T(q.rhoi) * hIce) * T(q.saltIce)) / dt;
      frw2oc = frw2oc + (totPrc - snowPrc);
    }
    // lateral melt
    const T extend = etope + ebote;
    const bool lat = on && icFrac > zero && extend > zero;
    if (lat) {
      const T rq = T(q.rhoi_half) * (q1 + q2);
      const T rqh = rq * hIce + rqS * hSnow;
      const T rqh_s = rqh > zero ? rqh : one;
      const T freshe = (T(q.rhos) * hSnow + T(q.rhoi) * hIce) / dt;
      const T salte = ((T(q.rhoi) * hIce) * T(q.saltIce)) / dt;
      const T icFrac_m = (one - extend / rqh_s) * icFrac;
      if (extend < rqh && icFrac_m >= T(q.iceMaskMin)) {
        frw2oc = frw2oc + (extend / rqh_s) * freshe;
        fsalt = fsalt + (extend / rqh_s) * salte;
        icFrac = icFrac_m;
      } else {
        frw2oc = frw2oc + freshe;
        fsalt = fsalt + salte;
        flx2oc = flx2oc + (extend - rqh) / dt;
        icFrac = zero;
        hIce = zero;
        hSnow = zero;
      }
    }
    if (on && icFrac <= zero && !lat && extend > zero)
      flx2oc = flx2oc + extend / dt;
    if (on) fzMlOc = fzMlOc - Fbot * iceMask;
  }

  // the net fluxes to the ocean
  if (on) {
    Qnet = (-iceMask) * flx2oc + opFrac0 * Qnet;
    EmPmR = (-iceMask) * frw2oc + opFrac0 * EmPmR;
  }
  T saltFlux = on ? (-iceMask) * fsalt : zero;

  // --- THSICE_EXTEND: freeze open water, make or extend ice ---
  {
    const bool act = fzMlOc > zero;
    const bool no_ice = icFrac <= zero;
    const T q1n = (T(q.q1_c) + T(q.cpIce) * (T(q.Tmlt1) - tFrz)) +
                  T(q.Lfresh) *
                      (one - T(q.Tmlt1) / (tFrz < zero ? tFrz : T(-1.0e-10)));
    const T q2n = T(q.neg_cpIce) * tFrz + T(q.Lfresh);
    const T eq1 = (act && no_ice) ? q1n : q1;
    const T eq2 = (act && no_ice) ? q2n : q2;
    const T qicAv = (T(q.rhoi) * (eq1 + eq2)) * T(0.5);
    const T newIce = act ? (fzMlOc * dt) / (qicAv > zero ? qicAv : one) : zero;
    const T iceVol = icFrac * hIce;
    const bool mk = act && no_ice && newIce > T(q.hIceMin_maskMin);
    T th1 = nmin(T(q.hThinIce), newIce / T(q.iceMaskMin));
    th1 = nmax(th1, newIce / T(q.iceMaskMax));
    const T fr1 = newIce / (th1 > zero ? th1 : one);
    const bool mk2 = act && !no_ice && iceVol < T(q.hiMax_maskMax);
    const T hNewIce =
        nmin(hIce > zero ? hIce : T(q.hNewIceMax), T(q.hNewIceMax));
    const T fr2 = nmin(icFrac + newIce / (hNewIce > zero ? hNewIce : one),
                       T(q.iceMaskMax));
    const T fr2s = fr2 > zero ? fr2 : one;
    const T th2 = nmin(T(q.hiMax), (iceVol + newIce) / fr2s);
    const T formed2 = th2 * fr2 - iceVol;
    const T hSnow2 = (hSnow * icFrac) / fr2s;
    const T newFrac = mk ? fr1 : (mk2 ? fr2 : icFrac);
    const T newThick = mk ? th1 : (mk2 ? th2 : hIce);
    const T formed = mk ? newIce : (mk2 ? formed2 : zero);
    if (mk2) hSnow = hSnow2;
    const T flx2oc_e = act ? (qicAv * formed) / dt : zero;
    const T frw2oc_e = act ? (T(q.neg_rhoi) * formed) / dt : zero;
    const T fsalt_e = act ? (T(q.neg_rhoi_saltIce) * formed) / dt : zero;
    if (act && newFrac > zero && no_ice) {
      tSrf = tFrz;
      tIc1 = tFrz;
      tIc2 = tFrz;
    }
    if (act) {
      q1 = eq1;
      q2 = eq2;
      icFrac = newFrac;
      hIce = newThick;
    }
    Qnet = Qnet - flx2oc_e;
    EmPmR = EmPmR - frw2oc_e;
    saltFlux = saltFlux - fsalt_e;
  }

  // the state's bookkeeping (thsice_step_fwd.F:380-401)
  const bool has = icFrac > zero;
  if (has && hSnow == zero) snowAge = zero;
  if (!has) {
    hIce = zero;
    hSnow = zero;
    snowAge = zero;
    tSrf = tOce;
    tIc1 = zero;
    tIc2 = zero;
    q1 = T(q.Lfresh);
    q2 = T(q.Lfresh);
  }
  a.iceMask_o[p] = has ? icFrac : zero;
  a.hIce_o[p] = hIce;
  a.hSnow_o[p] = hSnow;
  a.snowAge_o[p] = snowAge;
  a.tSrf_o[p] = tSrf;
  a.tIce1_o[p] = tIc1;
  a.tIce2_o[p] = tIc2;
  a.qIce1_o[p] = q1;
  a.qIce2_o[p] = q2;
  a.qnet_o[p] = Qnet;
  a.qsw_o[p] = Qsw;
  a.empmr_o[p] = EmPmR;
  a.saltflux_o[p] = saltFlux;
}

template <typename T, typename Start>
int launch_thsice_step(const void* const* table, int n,
                       const double* params, int np, int nyp, int nxp,
                       int oly, int olx, int nitMaxTsf, Start start) {
  static_assert(sizeof(ThArgs<T>) == kThPointers * sizeof(void*),
                "ThArgs must be a plain table of pointers");
  static_assert(sizeof(ThParams) == kThParams * sizeof(double),
                "ThParams must be a plain array of doubles");
  ThArgs<T> a;
  if (!unpack(&a, table, n, kThPointers) || np != kThParams || oly < 1 ||
      olx < 1 || nyp <= 2 * oly || nxp <= 2 * olx || nitMaxTsf < 0)
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < kThPointers; ++t)
    if (table[t] == nullptr) return (int)cudaErrorInvalidValue;
  ThParams q;
  std::memcpy(&q, params, sizeof(q));
  start(thsice_step_kernel<T>, grid2d(nyp, nxp), dim3(BX, BY), a, q, nyp,
        nxp, oly, olx, nitMaxTsf);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
