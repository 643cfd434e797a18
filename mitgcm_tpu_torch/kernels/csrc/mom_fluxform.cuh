// Kernel B's argument table and its per-cell helpers, shared by the
// forward kernel (mom_fluxform.cu) and its VJP (mom_fluxform_adj.cu).
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

  // ---- advective fluxes ----
  __device__ T fZonU(int k, int j, int i) const {
    return T(0.25) * (uTrans(k, j, i) + uTrans(k, j, i + 1)) *
           (a.u[i3(k, j, i)] + a.u[i3(k, j, i + 1)]);
  }
  __device__ T fMerU(int k, int j, int i) const {
    return T(0.25) * (vTrans(k, j, i) + vTrans(k, j, i - 1)) *
           (a.u[i3(k, j, i)] + a.u[i3(k, j - 1, i)]);
  }
  __device__ T fZonV(int k, int j, int i) const {
    return T(0.25) * (uTrans(k, j, i) + uTrans(k, j - 1, i)) *
           (a.v[i3(k, j, i)] + a.v[i3(k, j, i - 1)]);
  }
  __device__ T fMerV(int k, int j, int i) const {
    return T(0.25) * (vTrans(k, j, i) + vTrans(k, j + 1, i)) *
           (a.v[i3(k, j, i)] + a.v[i3(k, j + 1, i)]);
  }
  // vertical advective flux of u at interface k (mom_u_adv_wu.F)
  __device__ T fVerU(int k, int j, int i) const {
    if (k >= nr) return T(0);
    const T rTrans = T(0.5) * (wrA(k, j, i) + wrA(k, j, i - 1));
    const T uk = a.u[i3(k, j, i)];
    if (k == 0) return rTrans * uk;
    const T mid = rTrans * T(0.5) * (uk + a.u[i3(k - 1, j, i)]);
    const T corr = T(0.25) *
                   (wrA(k, j, i) * dmask(k, j, i) +
                    wrA(k, j, i - 1) * dmask(k, j, i - 1)) * uk;
    return mid + corr;
  }
  __device__ T fVerV(int k, int j, int i) const {
    if (k >= nr) return T(0);
    const T rTrans = T(0.5) * (wrA(k, j, i) + wrA(k, j - 1, i));
    const T vk = a.v[i3(k, j, i)];
    if (k == 0) return rTrans * vk;
    const T mid = rTrans * T(0.5) * (vk + a.v[i3(k - 1, j, i)]);
    const T corr = T(0.25) *
                   (wrA(k, j, i) * dmask(k, j, i) +
                    wrA(k, j - 1, i) * dmask(k, j - 1, i)) * vk;
    return mid + corr;
  }

  // ---- harmonic viscous fluxes (mom_u_xviscflux.F etc.) ----
  __device__ T vZonU(int k, int j, int i, T nAhD) const {
    return a.dyF[i2(j, i)] * a.drF[k] * a.hFacC[i3(k, j, i)] *
           a.recip_dxF[i2(j, i)] *
           (nAhD * (a.u[i3(k, j, i + 1)] - a.u[i3(k, j, i)]) *
            a.cosFacU[i2(j, i)]);
  }
  __device__ T vMerU(int k, int j, int i, T nAhZ) const {
    return a.dxV[i2(j, i)] * a.drF[k] * hFacZ(k, j, i) *
           a.recip_dyU[i2(j, i)] *
           (nAhZ * (a.u[i3(k, j, i)] - a.u[i3(k, j - 1, i)]));
  }
  __device__ T vZonV(int k, int j, int i, T nAhZ) const {
    return a.dyU[i2(j, i)] * a.drF[k] * hFacZ(k, j, i) *
           a.recip_dxV[i2(j, i)] *
           (nAhZ * (a.v[i3(k, j, i)] - a.v[i3(k, j, i - 1)]) *
            a.cosFacV[i2(j, i)]);
  }
  __device__ T vMerV(int k, int j, int i, T nAhD) const {
    return a.dxF[i2(j, i)] * a.drF[k] * a.hFacC[i3(k, j, i)] *
           a.recip_dyF[i2(j, i)] *
           (nAhD * (a.v[i3(k, j + 1, i)] - a.v[i3(k, j, i)]));
  }
  // explicit vertical viscous flux at interface k (mom_u_rviscflux.F):
  // zero at the surface and below the bottom
  __device__ T rViscU(int k, int j, int i, T rkSign) const {
    if (k <= 0 || k >= nr) return T(0);
    return -a.kappaRU[i3(k, j, i)] * a.rAw[i2(j, i)] *
           (a.u[i3(k, j, i)] - a.u[i3(k - 1, j, i)]) * rkSign *
           a.recip_drC[k] * a.maskW[i3(k, j, i)] * a.maskW[i3(k - 1, j, i)];
  }
  __device__ T rViscV(int k, int j, int i, T rkSign) const {
    if (k <= 0 || k >= nr) return T(0);
    return -a.kappaRV[i3(k, j, i)] * a.rAs[i2(j, i)] *
           (a.v[i3(k, j, i)] - a.v[i3(k - 1, j, i)]) * rkSign *
           a.recip_drC[k] * a.maskS[i3(k, j, i)] * a.maskS[i3(k - 1, j, i)];
  }
};

}  // namespace mitgcm
