// Kernel seaice_thermo: the sea ice's thermodynamics, one column a thread.
//
// Replaces: mitgcm_tpu/model/seaice.py:SeaIce.reg_ridge (:1559), growth
// (:1681-1945) and solve4temp (:1592-1678), which XLA fused into a few
// pointwise passes over the 2-D fields on the TPU (solve4temp once per
// thickness category, each with IMAX_TICE Newton iterations).
//
// One launch per step, one thread per cell of the padded array: the
// regularisation of negative and tiny ice (reg_ridge), the effective
// thicknesses, the loop over the multDim categories (each: the albedos,
// IMAX_TICE Newton iterations of the surface energy balance and the fluxes
// at the final temperature), the open-water and ice-ocean fluxes, the
// sublimation, melt, growth, precipitation and flooding budget, the new
// concentration, and the ocean's Qnet, Qsw, EmPmR and saltFlux. Halo cells
// keep their inputs (the interior-only update of the JAX code).
//
// Bound: operations in the math library, not bytes: a column reads 20
// fields (7 of them TICES) and writes 14, ~136 B in float32, but each of
// the 7 categories evaluates exp twice in each of its 11 flux evaluations
// (~160 exp and ~1500 other flops a column), about 5 flops per byte.
// Design: registers only; the order of every expression is the JAX code's
// (model/seaice.py's twin replays it), powers are multiplied out as
// integer_pow does, Python-number over field is an IEEE division and the
// constants the JAX code folds in Python are folded on the host in double.
//
// TP, the tracer variant (seaice_thermo_tr, template flag Tr): the ice
// tracers' sources (seaice.py:tracer_phys, :1948-1980) folded into the same
// launch. Growth's stages (HEFF after reg_ridge, after the ice-ocean flux,
// after the atmosphere over ice, after open-water growth and at the end;
// AREA after reg_ridge and at the end; seaice.py:1715-1914) are values the
// thread holds in registers at those points of the budget, so nothing is
// written for them: a tracer comes in and goes out of this launch, moved
// toward its sources where its mate grew or expanded, the 'age' tracer
// aged by deltaTtherm where its mate lives and reset elsewhere; the halo
// keeps it as it came. Names, mates and sources are TracerParams.

#pragma once

#include <cstring>

#include "gad_advect.cuh"

namespace mitgcm {

constexpr int kMaxCategories = 16;

// the constants, folded on the host in double as the JAX code folds them
struct ThermoParams {
  double c2k, MIN_LWDOWN, MIN_ATEMP, dTempFrz_dS, tempFrz0, snow_emiss,
      ice_emiss, boltzmann, SurfMeltTemp, wetIceAlb_south, dryIceAlb_south,
      wetIceAlb, dryIceAlb, wetSnowAlb_south, drySnowAlb_south, wetSnowAlb,
      drySnowAlb, recip_HCUT, HCUT, shortwave, XKIXKS, XKS, XKI, negAa1,
      aa2, lnTEN, bb1, Ppascals, one_m_bb1, aa1, cc1, cc2, D1I, D1, TMELT,
      lhSublim, EPS, area_reg_sq, hice_reg_sq, recip_denom, convertQ2HI,
      dt_over_rhoIce, mcPheePiston, frazil, mcPheeTaper, mcPheeStepFunc,
      negCpRhoRecipQI, deltaTtherm, SNOW2ICE, ICE2SNOW, convertPRECIP2HI,
      negConvertPRECIP2HI, facOpenGrow, facOpenMelt, SWFrac, rhoSnow, rhoIce,
      rhoConst, useFlooding, recip_HO_south, recip_HO, areaGainFormula,
      areaLossFormula, area_max, areaPDFfac, salt0, recip_dtT, convertHI2Q,
      convertHI2PRECIP, rhoConstFresh, area_floor, useMultDimSnow,
      pdf[kMaxCategories];
};

constexpr int kMaxTracers = 8;

// the ice tracers of TP: their count, then per tracer its mate (1: AREA,
// 0: HEFF), whether it is 'age', and its sources SItrFromOcean0,
// SItrFromFlood0 and SItrExpand0
struct TracerParams {
  double n, mate[kMaxTracers], age[kMaxTracers], ocean[kMaxTracers],
      flood[kMaxTracers], expand[kMaxTracers];
};

template <typename T>
struct ThermoArgs {
  // in, [nyp, nxp] (TICES [multDim, nyp, nxp])
  const T *heff, *hsnow, *area, *tices, *atemp, *aqh, *precip, *swdown,
      *lwdown, *runoff, *wspeed, *evap, *qnet, *qsw, *empmr, *saltflux,
      *theta0, *salt0, *heffm, *yC;
  // out
  T *heff_o, *hsnow_o, *area_o, *tices_o, *qnet_o, *qsw_o, *empmr_o,
      *saltflux_o;
};
constexpr int kThermoPointers = 28;

template <typename T>
__device__ __forceinline__ T sel(bool c, T a, T b) { return c ? a : b; }

// one tracer through growth's stages: toward src where the stage grew
template <typename T>
__device__ __forceinline__ T tracer_stage(T x, T before, T after, double src) {
  const T f = after > before ? before / after : T(1);
  return x * f + T(src) * (T(1) - f);
}

template <typename T, bool Tr>
__global__ void seaice_thermo_kernel(const ThermoArgs<T> a,
                                     const ThermoParams q,
                                     const TracerParams tq,
                                     const T* __restrict__ tr_in,
                                     T* __restrict__ tr_out, int nyp, int nxp,
                                     int ol, int multDim, int imax) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t p = static_cast<size_t>(j) * nxp + i;
  const bool inside = j >= ol && j < nyp - ol && i >= ol && i < nxp - ol;
  if (!inside) {   // the interior-only update: halo cells as they came
    a.heff_o[p] = a.heff[p];
    a.hsnow_o[p] = a.hsnow[p];
    a.area_o[p] = a.area[p];
    for (int c = 0; c < multDim; ++c)
      a.tices_o[c * P + p] = a.tices[c * P + p];
    a.qnet_o[p] = a.qnet[p];
    a.qsw_o[p] = a.qsw[p];
    a.empmr_o[p] = a.empmr[p];
    a.saltflux_o[p] = a.saltflux[p];
    if constexpr (Tr)
      for (int t = 0; t < static_cast<int>(tq.n); ++t)
        tr_out[t * P + p] = tr_in[t * P + p];
    return;
  }
  const T zero = T(0);
  const T hm = a.heffm[p];
  const bool south = a.yC[p] < T(0);
  // ---- reg_ridge ----
  T heff = a.heff[p], hsnow = a.hsnow[p], area = a.area[p];
  T dHn = nmax(-heff, zero) * T(1);
  heff = heff + dHn;
  T dSn = nmax(-hsnow, zero) * T(1);
  hsnow = hsnow + dSn;
  area = nmax(area, zero);
  const bool tiny = heff <= T(1.0e-5);
  const T t1r = tiny ? -heff : zero;
  const T t2r = tiny ? -hsnow : zero;
  heff = heff + t1r;
  hsnow = hsnow + t2r;
  dHn = dHn + t1r;
  dSn = dSn + t2r;
  if (heff == zero && hsnow == zero) area = zero;
  if (heff > zero || hsnow > zero) area = nmax(area, T(q.area_floor));
  area = nmin(area, T(q.area_max));
  // ---- growth ----
  const T HEFFpre = heff, HSNWpre = hsnow, AREApre = area;
  const bool pos = HEFFpre > zero;
  const T t1 = sqrt(AREApre * AREApre + T(q.area_reg_sq));
  const T t2 = HEFFpre / t1;
  const T heffActual = pos ? sqrt(t2 * t2 + T(q.hice_reg_sq)) : zero;
  const T hsnowActual = pos ? HSNWpre / t1 : zero;
  const T recip_heffActual =
      pos ? AREApre / sqrt(HEFFpre * HEFFpre + T(q.hice_reg_sq)) : zero;
  const T UG = nmax(T(q.EPS), a.wspeed[p]);
  const T salt0 = a.salt0[p];
  // solve4temp's inputs that do not depend on the category
  const T lwdown0 = nmax(T(q.MIN_LWDOWN), a.lwdown[p]);
  const T atempLoc = nmax(T(q.c2k + q.MIN_ATEMP), a.atemp[p]);
  const T tempFrzS = T(q.dTempFrz_dS) * salt0 + T(q.tempFrz0) + T(q.c2k);
  const T swdown = a.swdown[p], aqh = a.aqh[p];
  T a_QbyATM_cover = zero, a_QSWbyATM_cover = zero, a_FWbySublim = zero;
  for (int c = 0; c < multDim; ++c) {
    const T pFac = T((2.0 * (c + 1) - 1.0) * q.recip_denom);
    const T pFacSnow = q.useMultDimSnow != 0.0 ? pFac : T(1);
    const T hice = heffActual * pFac;
    const T hsn = hsnowActual * pFacSnow;
    // reg_ridge resets the category temperatures of tiny ice to 0 degC
    const T tin = tiny ? T(q.c2k) : a.tices[c * P + p];
    // seaice.py:solve4temp
    const bool iceOrNot = hice > zero;
    const bool snowy = hsn > zero;
    const T emiss = snowy ? T(q.snow_emiss) : T(q.ice_emiss);
    const T D3 = emiss * T(q.boltzmann);
    const T lwdownLoc = emiss * lwdown0;
    const bool melt = tin >= T(q.SurfMeltTemp);
    const T alb_ice = south ? (melt ? T(q.wetIceAlb_south)
                                    : T(q.dryIceAlb_south))
                            : (melt ? T(q.wetIceAlb) : T(q.dryIceAlb));
    const T alb_snow = south ? (melt ? T(q.wetSnowAlb_south)
                                     : T(q.drySnowAlb_south))
                             : (melt ? T(q.wetSnowAlb) : T(q.drySnowAlb));
    T alb = nmin(alb_ice + hsn * T(q.recip_HCUT) * (alb_snow - alb_ice),
                 alb_snow);
    if (hsn > T(q.HCUT)) alb = alb_snow;
    const T penet = snowy ? zero : T(q.shortwave) * exp(T(-1.5) * hice);
    const T IcePenetSW0 = -(T(1) - alb) * penet * swdown;
    const T absorbedSW = (T(1) - alb) * (T(1) - penet) * swdown;
    const T effConduct =
        iceOrNot ? T(q.XKIXKS) /
                       nmax(T(q.XKS) * hice + T(q.XKI) * hsn, T(1e-30))
                 : zero;
    T F_c, F_ia, F_lh, dFia;
    auto flux_terms = [&](T tt) {
      const T tt2 = tt * tt;
      const T tt3 = tt2 * tt;
      const T tt4 = tt2 * tt2;
      const T mm_pi = exp((T(q.negAa1) / tt + T(q.aa2)) * T(q.lnTEN));
      const T qhice =
          T(q.bb1) * mm_pi / (T(q.Ppascals) - T(q.one_m_bb1) * mm_pi);
      const T cc3t = exp(T(q.aa1) / tt * T(q.lnTEN));
      const T d = T(q.cc2) - cc3t * T(q.Ppascals);
      const T dqh_dTs = T(q.cc1) * cc3t / (d * d * tt2);
      F_c = effConduct * (tempFrzS - tt);
      F_lh = T(q.D1I) * UG * (qhice - aqh);
      const T F_lwu = tt4 * D3;
      const T F_sens = T(q.D1) * UG * (tt - atempLoc);
      F_ia = -lwdownLoc - absorbedSW + F_lwu + F_sens + F_lh;
      dFia = T(4.0) * D3 * tt3 + T(q.D1) * UG + T(q.D1I) * UG * dqh_dTs;
    };
    T ts = tin;
    for (int it = 0; it < imax; ++it) {
      flux_terms(ts);
      const T delta = (F_c - F_ia) / (effConduct + dFia);
      if (iceOrNot) ts = ts + delta;
      ts = nmin(ts, T(q.TMELT));
    }
    flux_terms(ts);
    a.tices_o[c * P + p] = iceOrNot ? ts : tin;
    const T fwsub = iceOrNot ? F_lh / T(q.lhSublim) : zero;
    const T fia = iceOrNot ? F_ia : zero;
    const T pensw = iceOrNot ? IcePenetSW0 : zero;
    const T pdf = T(q.pdf[c]);
    a_QbyATM_cover = a_QbyATM_cover + fia * pdf;
    a_QSWbyATM_cover = a_QSWbyATM_cover + pensw * pdf;
    a_FWbySublim = a_FWbySublim + fwsub * pdf;
  }
  const T cQ = T(q.convertQ2HI);
  const T open = T(1) - AREApre;
  a_QbyATM_cover = a_QbyATM_cover * cQ * AREApre;
  a_QSWbyATM_cover = a_QSWbyATM_cover * cQ * AREApre;
  const T a_QbyATM_open = a.qnet[p] * cQ * open;
  const T a_QSWbyATM_open = a.qsw[p] * cQ * open;
  T r_QbyATM_cover = a_QbyATM_cover;
  T r_QbyATM_open = a_QbyATM_open;
  a_FWbySublim = T(q.dt_over_rhoIce) * a_FWbySublim * AREApre;
  T r_FWbySublim = a_FWbySublim;
  const T theta0 = a.theta0[p];
  const T tempFrz = T(q.tempFrz0) + T(q.dTempFrz_dS) * salt0;
  const T fac = theta0 >= tempFrz ? T(q.mcPheePiston) : T(q.frazil);
  const T mltf = AREApre > zero
                     ? (q.mcPheeStepFunc != 0.0
                            ? T(1.0 - q.mcPheeTaper)
                            : T(1) - T(q.mcPheeTaper) * AREApre)
                     : T(1);
  const T turb = T(q.negCpRhoRecipQI) * (theta0 - tempFrz) *
                 T(q.deltaTtherm) * hm;
  T r_QbyOCN = fac * turb * mltf;
  const T S2I = T(q.SNOW2ICE), I2S = T(q.ICE2SNOW);
  // sublimation of snow, then of ice
  T t2_ = nmax(nmin(r_FWbySublim, hsnow * S2I), zero);
  hsnow = hsnow - t2_ * I2S;
  r_FWbySublim = r_FWbySublim - t2_;
  t2_ = nmax(nmin(r_FWbySublim, heff), zero);
  const T d_HEFFbySublim = -t2_;
  heff = heff - t2_;
  r_FWbySublim = r_FWbySublim - t2_;
  a_QbyATM_cover = a_QbyATM_cover - r_FWbySublim;
  r_QbyATM_cover = r_QbyATM_cover - r_FWbySublim;
  // ice-ocean
  const T d_HEFFbyOCNonICE = nmax(r_QbyOCN, -heff);
  r_QbyOCN = r_QbyOCN - d_HEFFbyOCNonICE;
  heff = heff + d_HEFFbyOCNonICE;
  const T stageH2 = heff;
  // snow melt by the atmosphere
  t2_ = nmin(nmax(r_QbyATM_cover, -hsnow * S2I), zero);
  const T d_HSNWbyATMonSNW = t2_ * I2S;
  hsnow = hsnow + t2_ * I2S;
  r_QbyATM_cover = r_QbyATM_cover - t2_;
  // ice melt and growth by the atmosphere over ice
  t2_ = nmax(-heff, r_QbyATM_cover + AREApre * r_QbyOCN);
  const T d_HEFFbyATMonOCN_cover = t2_;
  T d_HEFFbyATMonOCN = t2_;
  r_QbyATM_cover = r_QbyATM_cover - t2_;
  heff = heff + t2_;
  const T stageH3 = heff;
  // precipitation: snow, or fresh water
  const bool snows = a_QbyATM_cover >= zero;
  const T precip = a.precip[p];
  const T d_HSNWbyRAIN =
      snows ? T(q.convertPRECIP2HI * q.ICE2SNOW) * precip * AREApre : zero;
  const T d_HFRWbyRAIN =
      snows ? zero : T(q.negConvertPRECIP2HI) * precip * AREApre;
  hsnow = hsnow + d_HSNWbyRAIN;
  // snow melt by the ocean
  const T d_HSNWbyOCNonSNW = nmin(nmax(r_QbyOCN * I2S, -hsnow), zero);
  r_QbyOCN = r_QbyOCN - d_HSNWbyOCNonSNW * S2I;
  hsnow = hsnow + d_HSNWbyOCNonSNW;
  // open-water growth
  const T t1o = r_QbyATM_open + r_QbyOCN * open;
  const T t2o = T(q.SWFrac) * a_QSWbyATM_open;
  const T t3o = T(q.facOpenGrow) *
                nmax(t1o - t2o, -heff * T(q.facOpenMelt)) * hm;
  const T d_HEFFbyATMonOCN_open = t3o;
  d_HEFFbyATMonOCN = d_HEFFbyATMonOCN + t3o;
  r_QbyATM_open = r_QbyATM_open - t3o;
  heff = heff + t3o;
  const T stageH4 = heff;
  // flooding
  T d_HEFFbyFLOODING = zero;
  if (q.useFlooding != 0.0) {
    const T t0 = (hsnow * T(q.rhoSnow) + heff * T(q.rhoIce)) / T(q.rhoConst);
    d_HEFFbyFLOODING = nmax(zero, t0 - heff);
    heff = heff + d_HEFFbyFLOODING;
    hsnow = hsnow - d_HEFFbyFLOODING * I2S;
  }
  // area
  const T recip_HO = south ? T(q.recip_HO_south) : T(q.recip_HO);
  const T gain = q.areaGainFormula == 1.0 ? nmax(zero, d_HEFFbyATMonOCN_open)
                                          : nmax(zero, a_QbyATM_open);
  const T loss = q.areaLossFormula == 1.0
                     ? nmin(zero, d_HEFFbyATMonOCN_cover) +
                           nmin(zero, d_HEFFbyATMonOCN_open) +
                           nmin(zero, d_HEFFbyOCNonICE)
                     : nmin(zero, d_HEFFbyATMonOCN_cover +
                                      d_HEFFbyATMonOCN_open +
                                      d_HEFFbyOCNonICE);
  if (heff > zero || hsnow > zero) {
    area = nmax(zero, nmin(T(q.area_max),
                           area + recip_HO * gain +
                               T(0.5) * recip_heffActual * loss *
                                   T(q.areaPDFfac)));
  } else {
    area = zero;
  }
  // salt flux
  const T t1s = dHn + d_HEFFbyOCNonICE + d_HEFFbyATMonOCN + d_HEFFbyFLOODING +
                d_HEFFbySublim;
  const T t3s = nmax(zero, nmin(T(q.salt0), salt0));
  const T saltFlux = t1s * t3s * hm * T(q.recip_dtT) * T(q.rhoIce);
  // the ocean's forcing
  T qnet = r_QbyATM_cover + r_QbyATM_open + a_QSWbyATM_cover -
           (d_HEFFbyOCNonICE + d_HSNWbyOCNonSNW * S2I + dHn + dSn * S2I) * hm;
  T qsw = a_QSWbyATM_cover + a_QSWbyATM_open;
  qnet = qnet * T(q.convertHI2Q);
  qsw = qsw * T(q.convertHI2Q);
  const T empmr =
      hm *
      ((a.evap[p] - precip) * open - a.runoff[p] +
       (d_HSNWbyATMonSNW * S2I + d_HFRWbyRAIN + d_HSNWbyOCNonSNW * S2I +
        d_HEFFbyOCNonICE + d_HEFFbyATMonOCN + dHn + dSn * S2I +
        r_FWbySublim) * T(q.convertHI2PRECIP)) *
      T(q.rhoConstFresh);
  a.heff_o[p] = heff;
  a.hsnow_o[p] = hsnow;
  a.area_o[p] = area;
  a.qnet_o[p] = qnet;
  a.qsw_o[p] = qsw;
  a.empmr_o[p] = empmr;
  a.saltflux_o[p] = saltFlux;
  if constexpr (Tr) {
    // tracer_phys (seaice.py:1948-1980) on the stages above
    for (int t = 0; t < static_cast<int>(tq.n); ++t) {
      T x = tr_in[t * P + p];
      bool live;
      if (tq.mate[t] == 0.0) {
        x = tracer_stage(x, HEFFpre, stageH2, tq.ocean[t]);
        x = tracer_stage(x, stageH2, stageH3, tq.ocean[t]);
        x = tracer_stage(x, stageH3, stageH4, tq.ocean[t]);
        x = tracer_stage(x, stageH4, heff, tq.flood[t]);
        live = heff > zero;
      } else {
        x = tracer_stage(x, AREApre, area, tq.expand[t]);
        live = area > zero;
      }
      if (tq.age[t] != 0.0) x = live ? x + T(q.deltaTtherm) : zero;
      tr_out[t * P + p] = x;
    }
  }
}

template <typename T, bool Tr, typename Start>
int launch_seaice_thermo(const void* const* table, int n,
                         const double* params, int nparams,
                         const double* trparams, int ntrparams,
                         const void* tr_in, void* tr_out, int nyp, int nxp,
                         int ol, int multDim, int imax, Start start) {
  static_assert(sizeof(ThermoArgs<T>) == kThermoPointers * sizeof(void*),
                "ThermoArgs must be a plain table of pointers");
  if (n != kThermoPointers ||
      nparams != static_cast<int>(sizeof(ThermoParams) / sizeof(double)) ||
      multDim < 1 || multDim > kMaxCategories)
    return (int)cudaErrorInvalidValue;
  ThermoArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  ThermoParams q;
  std::memcpy(&q, params, sizeof(q));
  TracerParams tq{};
  if (Tr) {
    if (ntrparams != static_cast<int>(sizeof(TracerParams) / sizeof(double)))
      return (int)cudaErrorInvalidValue;
    std::memcpy(&tq, trparams, sizeof(tq));
    if (tq.n < 1 || tq.n > kMaxTracers || !tr_in || !tr_out)
      return (int)cudaErrorInvalidValue;
  }
  const dim3 g((nxp + BX - 1) / BX, (nyp + BY - 1) / BY, 1);
  start(seaice_thermo_kernel<T, Tr>, g, dim3(BX, BY), a, q, tq,
        (const T*)tr_in, (T*)tr_out, nyp, nxp, ol, multDim, imax);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

