// GM-Redi's slope limiting and tapering as device functions, shared by the
// kernels of gmredi.cu: gmredi.py:_slope_limit (:90-189) for the tensor and
// gmredi.py:_slope_psi (:347-393) for the bolus streamfunction, in
// z-coordinates (their unit conversions are 1). Each keeps the JAX code's
// operation order; a Python number of the JAX code is a double host
// parameter cast to T, as PyTorch casts it, and every division is a true
// division (the twins divide tensor by tensor).
#pragma once

#include "common.cuh"

namespace mitgcm {

// the taper schemes (model/gmredi.py:TAPERS, PSI_TAPERS)
enum GmTaper { kGmClip = 0, kGmGkw91 = 1, kGmLinear = 2, kGmDm95 = 3,
               kGmLdd97 = 4, kGmAc02 = 5 };

// gm_tensor's host numbers (model/gmredi.py:tensor_params)
struct TensorParams {
  double small, bigSlope, sqCut, mss, rmax, Scrit, Sd, isoK, Kgm, Kmin,
      gsign, negGsignIsoK, Cspd, LrhoInf, LrhoSup;
};

// gm_psi_b's host numbers (model/gmredi.py:psi_params)
struct PsiParams {
  double small, cutoff, maxS, mss, rMaxSlope, Scrit, Sd, halfSign, K;
};

template <typename T>
struct Slope {
  T sx, sy, ssq, taper;
};

// jnp.clip, NaN passed through as torch.clamp does
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// 0.5 (1 + tanh(clip((Scrit - smod) / Sd, -30, 30))), the clamp of the JAX
// code kept (known fault 4 of the reference)
template <typename T>
__device__ __forceinline__ T tanh_taper(T Scrit, T Sd, T smod) {
  const T arg = clip((Scrit - smod) / Sd, T(-30), T(30));
  return T(0.5) * (T(1) + tanh(arg));
}

// ldd97's Rossby radius Cspd / |f| clipped to [LrhoInf, LrhoSup]
template <typename T>
__device__ __forceinline__ T lrho(const TensorParams& q, T f) {
  const T L = f != T(0) ? T(q.Cspd) / (f != T(0) ? fabs(f) : T(1))
                        : T(q.LrhoSup);
  return clip(L, T(q.LrhoInf), T(q.LrhoSup));
}

// _slope_limit: the slopes, their square and the taper of scheme S
template <typename T, int S>
__device__ Slope<T> slope_limit(const TensorParams& q, T dSx, T dSy, T dSr,
                                T Lrho, T rDepth) {
  const T mss = T(q.mss), sqCut = T(q.sqCut);
  Slope<T> r;
  if (S == kGmAc02) {
    const T d2 = (dSx * dSx + dSy * dSy) + dSr * dSr;
    const T rD = d2 != T(0) ? T(1) / d2 : T(0);
    r.ssq = (dSx * dSx + dSy * dSy) * rD;
    r.sx = dSx * rD * dSr;
    r.sy = dSy * rD * dSr;
    r.taper = (r.ssq > mss && r.ssq < sqCut)
                  ? mss / (r.ssq == T(0) ? T(1) : r.ssq)
                  : (r.ssq >= sqCut ? T(0) : T(1));
    return r;
  }
  const T small = T(q.small), big = T(q.bigSlope);
  const T dsr = (dSr != T(0) && dSr <= small) ? small : dSr;
  r.sx = dsr == T(0) ? (dSx != T(0) ? (dSx >= T(0) ? big : -big) : T(0))
                     : dSx / dsr;
  r.sy = dsr == T(0) ? (dSy != T(0) ? (dSy >= T(0) ? big : -big) : T(0))
                     : dSy / dsr;
  r.ssq = r.sx * r.sx + r.sy * r.sy;
  r.taper = T(1);
  if (r.ssq >= sqCut) {
    r.ssq = sqCut;
    r.taper = T(0);
  }
  const bool live = r.ssq != T(0) && r.ssq < sqCut;
  if (S == kGmGkw91) {
    if (live && r.ssq > mss) r.taper = mss / r.ssq;
  } else if (S == kGmLinear) {
    if (live && r.ssq > mss) r.taper = sqrt(mss / r.ssq);
  } else if (S == kGmDm95) {
    if (live) r.taper = tanh_taper(T(q.Scrit), T(q.Sd), sqrt(r.ssq));
  } else if (S == kGmLdd97) {
    if (live) {
      const T smod = sqrt(r.ssq);
      const T f1 = tanh_taper(T(q.Scrit), T(q.Sd), smod);
      const T rnon = rDepth / (Lrho * (smod == T(0) ? T(1) : smod));
      const T f2 = rnon >= T(1)
                       ? T(1)
                       : T(0.5) * (T(1) + sin(T(M_PI) * (rnon - T(0.5))));
      r.taper = f1 * f2;
    }
  } else {   // clipping: dSigmaDr limited so that |S| <= maxSlope
    const T mod = sqrt(dSx * dSx + dSy * dSy);
    const T mr = mod * T(q.rmax);
    const T dsrc = (mod != T(0) && dSr <= mr) ? mr : dSr;
    const T safe = dsrc == T(0) ? T(1) : dsrc;
    r.sx = mod == T(0) ? T(0) : dSx / safe;
    r.sy = mod == T(0) ? T(0) : dSy / safe;
    r.ssq = r.sx * r.sx + r.sy * r.sy;
    r.taper = T(1);
  }
  return r;
}

// _slope_psi for one component: (slope, taper) into *s, *taper; dm95's
// taper has no cutoff guard (the reference's); ac02 tapers as gkw91
template <typename T, int S>
__device__ void slope_psi(const PsiParams& q, T slope, T dSr, T* s,
                          T* taper) {
  const T small = T(q.small);
  if (S == kGmClip) {
    const T ltd = small + fabs(slope) * T(q.rMaxSlope);
    *s = slope / (dSr < ltd ? ltd : dSr);
    *taper = T(1);
    return;
  }
  T v = slope / (dSr < small ? small : dSr);
  T t = T(1);
  const T cutoff = T(q.cutoff);
  if (fabs(v) >= cutoff) {
    v = T(v > T(0) ? 1 : (v < T(0) ? -1 : 0)) * cutoff;
    t = T(0);
  }
  const T smod = fabs(v), maxS = T(q.maxS);
  const bool live = smod > maxS && smod < cutoff;
  if (S == kGmGkw91) {
    if (live) t = T(q.mss) / (v * v + small);
  } else if (S == kGmLinear) {
    if (live) t = maxS / (smod + small);
  } else {   // dm95
    t = tanh_taper(T(q.Scrit), T(q.Sd), smod);
  }
  *s = v;
  *taper = t;
}

}  // namespace mitgcm
