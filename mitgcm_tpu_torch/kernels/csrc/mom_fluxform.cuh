// Kernel B's argument table, shared by the forward kernel
// (mom_fluxform.cu, mom_fluxform_tile.cuh) and its VJP
// (mom_fluxform_adj.cu), and the VJP's per-cell helpers.
#pragma once

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct MomArgs {
  // [nr, nyp, nxp]
  const T *u, *v, *w, *hFacC, *hFacW, *hFacS, *maskC, *maskW, *maskS,
      *recip_hFacW, *recip_hFacS;
  // [nr+1, nyp, nxp]
  const T *kappaRU, *kappaRV;
  // [nyp, nxp]
  const T *dxF, *dyF, *dxG, *dyG, *dxV, *dyU, *rA, *rAw, *rAs, *recip_dxF,
      *recip_dyF, *recip_dxV, *recip_dyU, *recip_rAw, *recip_rAs, *cosFacU,
      *cosFacV, *fCori, *fCoriCos, *angleCosC;
  // [nr] and [nr+1]
  const T *drF, *recip_drF, *recip_drC;
  // outputs [nr, nyp, nxp]
  T *gU, *gV, *guDiss, *gvDiss;
};
constexpr int kMomNumPointers = 40;

// The second table of B's dissipation variant (mom_fluxform_visc), each
// [nr, nyp, nxp] or null: kernel X's viscosities (null: the constants of
// MomViscParams and the launch), kernel Y's Laplacian (null: no biharmonic
// viscosity)
template <typename T>
struct MomViscArgs {
  const T *viscAh_D, *viscAh_Z, *viscA4_D, *viscA4_Z, *del2u, *del2v;
};
constexpr int kMomViscNumPointers = 6;

// its numbers: the constant biharmonic viscosities, the linear and
// quadratic drag coefficients (the quadratic 0 unless selectBotDragQuadr
// is 0), the no-slip bottom, and whether the drag block runs at all
template <typename T>
struct MomViscParams {
  T viscA4D, viscA4Z, bottomDragLinear, bottomDragQuadratic;
  bool noSlipBottom, drag;
};
constexpr int kMomViscNumParams = 4;

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }

template <typename T>
struct MomCell {
  const MomArgs<T>& a;
  int nr, nyp, nxp;

  __device__ size_t i3(int k, int j, int i) const {
    return (static_cast<size_t>(k) * nyp + j) * nxp + i;
  }
  __device__ size_t i2(int j, int i) const {
    return static_cast<size_t>(j) * nxp + i;
  }
  // 3-D read with the zero fill of stencil.shift_k above the surface
  __device__ T at(const T* f, int k, int j, int i) const {
    return k < 0 ? T(0) : f[i3(k, j, i)];
  }
  __device__ T uTrans(int k, int j, int i) const {
    return a.u[i3(k, j, i)] *
           (a.dyG[i2(j, i)] * a.drF[k] * a.hFacW[i3(k, j, i)]);
  }
  __device__ T vTrans(int k, int j, int i) const {
    return a.v[i3(k, j, i)] *
           (a.dxG[i2(j, i)] * a.drF[k] * a.hFacS[i3(k, j, i)]);
  }
  __device__ T wrA(int k, int j, int i) const {
    return a.w[i3(k, j, i)] * a.rA[i2(j, i)];
  }
  __device__ T dmask(int k, int j, int i) const {
    return a.maskC[i3(k, j, i)] - at(a.maskC, k - 1, j, i);
  }
  // mom_calc_hfacz.F
  __device__ T hFacZ(int k, int j, int i) const {
    const T mW = a.maskW[i3(k, j, i)], mWs = a.maskW[i3(k, j - 1, i)];
    const T mS = a.maskS[i3(k, j, i)], mSw = a.maskS[i3(k, j, i - 1)];
    const T openJ =
        tmin(a.hFacW[i3(k, j, i)], a.hFacW[i3(k, j - 1, i)]) * mW * mWs;
    const T openI =
        tmin(a.hFacS[i3(k, j, i)], a.hFacS[i3(k, j, i - 1)]) * mS * mSw;
    return tmin(openI, openJ) * mW * mWs;
  }
};

}  // namespace mitgcm
