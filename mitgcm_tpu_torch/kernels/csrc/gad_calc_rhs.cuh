// Kernel C's argument table and its per-cell fluxes, shared by the
// forward kernel (gad_calc_rhs.cu) and its VJP (gad_calc_rhs_adj.cu).
#pragma once

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct GadArgs {
  // [nr, nyp, nxp]
  const T *uTrans, *vTrans, *rTrans, *xA, *yA, *maskUp, *tracer, *kappaR,
      *maskC, *recip_hFacC;
  // [nyp, nxp]
  const T *rA, *recip_dxC, *recip_dyC, *cosFacU, *recip_rA, *maskInC;
  // [nr] and [nr+1]
  const T *recip_drF, *recip_drC;
  // output [nr, nyp, nxp]
  T* gTr;
};
constexpr int kGadNumPointers = 19;

template <typename T>
struct GadCell {
  const GadArgs<T>& a;
  int nr, nyp, nxp;
  T diffKh, rkSign;
  // implicitDiffusion: the implicit solve (impldiff.cu) takes the place of
  // the explicit vertical diffusive flux, which is left out
  bool implicitDiffusion;
  // calcAdvection false: the advective fluxes are left out (the
  // multi-dimensional advection, gad_multidim.cu, has advected the tracer)
  bool calcAdvection;
  // an extra vertical flux added at every interface (the KPP nonlocal
  // flux, gad.py:1099-1101), or null
  const T* df;

  __device__ size_t i3(int k, int j, int i) const {
    return (static_cast<size_t>(k) * nyp + j) * nxp + i;
  }
  __device__ size_t i2(int j, int i) const {
    return static_cast<size_t>(j) * nxp + i;
  }
  // zonal flux at the west face of (k, j, i)
  __device__ T fZon(int k, int j, int i) const {
    const size_t p = i3(k, j, i);
    const T t = a.tracer[p], tm1 = a.tracer[p - 1];
    const T adv = calcAdvection ? a.uTrans[p] * T(0.5) * (t + tm1) : T(0);
    return adv - diffKh * a.xA[p] * a.recip_dxC[i2(j, i)] * (t - tm1) *
                     a.cosFacU[i2(j, i)];
  }
  // meridional flux at the south face
  __device__ T fMer(int k, int j, int i) const {
    const size_t p = i3(k, j, i);
    const T t = a.tracer[p], tm1 = a.tracer[p - nxp];
    const T adv = calcAdvection ? a.vTrans[p] * T(0.5) * (t + tm1) : T(0);
    return adv - diffKh * a.yA[p] * a.recip_dyC[i2(j, i)] * (t - tm1);
  }
  // vertical flux at the upper face (interface k); zero below the bottom,
  // and at the surface but for df
  __device__ T fVer(int k, int j, int i) const {
    if (k >= nr) return T(0);
    const size_t p = i3(k, j, i);
    if (k == 0) return df ? df[p] : T(0);
    const size_t pm = p - static_cast<size_t>(nyp) * nxp;
    const T t = a.tracer[p], tkm1 = a.tracer[pm];
    T f = calcAdvection ? a.maskC[pm] * a.rTrans[p] * T(0.5) * (t + tkm1) *
                              a.maskInC[i2(j, i)]
                        : T(0);
    if (!implicitDiffusion)
      f = f + -a.kappaR[p] * a.maskUp[p] * a.rA[i2(j, i)] * a.recip_drC[k] *
                  (t - tkm1) * rkSign;
    return df ? f + df[p] : f;
  }
};

}  // namespace mitgcm
