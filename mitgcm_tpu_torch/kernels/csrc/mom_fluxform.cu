// Kernel B: flux-form momentum tendencies gU, gV, guDiss, gvDiss.
//
// Replaces: mitgcm_tpu/model/mom_fluxform.py:mom_fluxform (:122-451) on the
// branches the wind-driven gyre runs: centred advection with the free-
// surface dmask correction (:155-230), constant harmonic viscosity and the
// explicit vertical viscous flux (:233-307), no-slip side drag (:312-340),
// no-slip bottom drag (:343-381) and Coriolis scheme 0 (:420-445). XLA
// fused this chain of shifted products into a few sweeps on the TPU.
//
// Bound: bytes. Per cell it reads 11 3-D fields (u, v, w, the hFac and
// masks, two kappa levels) and writes 4, ~60 B/cell in float32, for a few
// hundred flops: well below the card's ~20 flops/byte.
// Design: one thread per (k, j, i), i fastest, writing all four outputs in
// one pass. Neighbour fluxes (fZonU(i-1), fMerU(j+1), fVerU(k+1), hFacZ at
// j+1 and i+1, ...) are recomputed from the inputs instead of being stored:
// their loads hit L1/L2, so DRAM traffic stays at one read of each input
// and one write of each output. 2-D metrics are re-read for every level and
// stay in L2. Halo cells of the outputs are written as 0; callers fill or
// mask them (step.py fills uStar/vStar and every prognostic field).
//
// Each expression keeps the JAX code's operation order, so with
// --fmad=false the outputs are bit-equal to the plain PyTorch twin.

#include <cstring>

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
      *cosFacV, *fCori;
  // [nr] and [nr+1]
  const T *drF, *recip_drF, *recip_drC;
  // outputs [nr, nyp, nxp]
  T *gU, *gV, *guDiss, *gvDiss;
};
constexpr int kMomNumPointers = 38;

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

template <typename T>
__global__ void mom_fluxform_kernel(const MomArgs<T> a, int nr, int ny,
                                    int nx, int oly, int olx, T viscAhD,
                                    T viscAhZ, T sideDragFactor, T rkSign) {
  const int nyp = ny + 2 * oly, nxp = nx + 2 * olx;
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const MomCell<T> c{a, nr, nyp, nxp};
  const size_t p = c.i3(k, j, i);
  if (i < olx || i >= olx + nx || j < oly || j >= oly + ny) {
    a.gU[p] = T(0);
    a.gV[p] = T(0);
    a.guDiss[p] = T(0);
    a.gvDiss[p] = T(0);
    return;
  }
  const size_t q = c.i2(j, i);
  const T u = a.u[p], v = a.v[p];
  const T rhW = a.recip_hFacW[p], rhS = a.recip_hFacS[p];
  const T rdrF = a.recip_drF[k], drF = a.drF[k];

  // advection (mom_fluxform.F:355-905)
  T gU = -(rhW * rdrF * a.recip_rAw[q] *
           ((c.fZonU(k, j, i) - c.fZonU(k, j, i - 1)) +
            (c.fMerU(k, j + 1, i) - c.fMerU(k, j, i)) +
            (c.fVerU(k + 1, j, i) - c.fVerU(k, j, i)) * rkSign));
  T gV = -(rhS * rdrF * a.recip_rAs[q] *
           ((c.fZonV(k, j, i + 1) - c.fZonV(k, j, i)) +
            (c.fMerV(k, j, i) - c.fMerV(k, j - 1, i)) +
            (c.fVerV(k + 1, j, i) - c.fVerV(k, j, i)) * rkSign));

  // harmonic viscosity + explicit vertical viscosity
  const T nAhD = -viscAhD, nAhZ = -viscAhZ;
  const T dVrU = (c.rViscU(k + 1, j, i, rkSign) - c.rViscU(k, j, i, rkSign))
                 * rkSign;
  const T dVrV = (c.rViscV(k + 1, j, i, rkSign) - c.rViscV(k, j, i, rkSign))
                 * rkSign;
  T guDiss = -(rhW * rdrF * a.recip_rAw[q] *
               ((c.vZonU(k, j, i, nAhD) - c.vZonU(k, j, i - 1, nAhD)) +
                (c.vMerU(k, j + 1, i, nAhZ) - c.vMerU(k, j, i, nAhZ)) +
                dVrU));
  T gvDiss = -(rhS * rdrF * a.recip_rAs[q] *
               ((c.vZonV(k, j, i + 1, nAhZ) - c.vZonV(k, j, i, nAhZ)) +
                (c.vMerV(k, j, i, nAhD) - c.vMerV(k, j - 1, i, nAhD)) +
                dVrV));

  // no-slip side drag (mom_u_sidedrag.F)
  const T hZ = c.hFacZ(k, j, i);
  const T Ahu = viscAhZ * u;
  const T uDrag =
      -(rhW * rdrF * a.recip_rAw[q] *
        ((a.hFacW[p] - hZ) * a.dxV[q] * a.recip_dyU[q] * Ahu +
         (a.hFacW[p] - c.hFacZ(k, j + 1, i)) * a.dxV[q + nxp] *
             a.recip_dyU[q + nxp] * Ahu) *
        drF * sideDragFactor);
  const T Ahv = viscAhZ * v * a.cosFacV[q];
  const T vDrag =
      -(rhS * rdrF * a.recip_rAs[q] *
        ((a.hFacS[p] - hZ) * a.dyU[q] * a.recip_dxV[q] * Ahv +
         (a.hFacS[p] - c.hFacZ(k, j, i + 1)) * a.dyU[q + 1] *
             a.recip_dxV[q + 1] * Ahv) *
        drF * sideDragFactor);
  guDiss = guDiss + uDrag;
  gvDiss = gvDiss + vDrag;

  // no-slip bottom drag (mom_u_botdrag_coeff.F): only where the cell
  // below is dry, or at k = Nr
  const bool deepest = (k == nr - 1);
  const T recDr = deepest ? a.recip_drF[nr - 1] : a.recip_drC[k + 1];
  const T cDragU = a.kappaRU[c.i3(k + 1, j, i)] * recDr * T(2);
  const T cDragV = a.kappaRV[c.i3(k + 1, j, i)] * recDr * T(2);
  const size_t below = p + static_cast<size_t>(nyp) * nxp;
  const T bottomW = a.maskW[p] * (deepest ? T(1) : T(1) - a.maskW[below]);
  const T bottomS = a.maskS[p] * (deepest ? T(1) : T(1) - a.maskS[below]);
  guDiss = guDiss - cDragU * bottomW * u * rhW * rdrF;
  gvDiss = gvDiss - cDragV * bottomS * v * rhS * rdrF;

  // Coriolis, scheme 0 (mom_u_coriolis.F)
  const T fC = a.fCori[q];
  const T uCf = T(0.5) * (fC + a.fCori[q - 1]) * T(0.25) *
                (v + a.v[p + nxp] + a.v[p - 1] + a.v[p + nxp - 1]);
  const T vCf = T(-0.5) * (fC + a.fCori[q - nxp]) * T(0.25) *
                (u + a.u[p + 1] + a.u[p - nxp] + a.u[p - nxp + 1]);
  gU = gU + uCf;
  gV = gV + vCf;

  const T mW = a.maskW[p], mS = a.maskS[p];
  a.gU[p] = gU * mW;
  a.gV[p] = gV * mS;
  a.guDiss[p] = guDiss * mW;
  a.gvDiss[p] = gvDiss * mS;
}

template <typename T>
int launch_mom(const void* const* table, int n, int nr, int ny, int nx,
               int oly, int olx, double viscAhD, double viscAhZ,
               double sideDragFactor, double rkSign, void* stream) {
  static_assert(sizeof(MomArgs<T>) == kMomNumPointers * sizeof(void*),
                "MomArgs must be a plain table of pointers");
  if (n != kMomNumPointers) return (int)cudaErrorInvalidValue;
  MomArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  const dim3 g((nx + 2 * olx + BX - 1) / BX, (ny + 2 * oly + BY - 1) / BY,
               nr);
  mom_fluxform_kernel<T><<<g, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      a, nr, ny, nx, oly, olx, T(viscAhD), T(viscAhZ), T(sideDragFactor),
      T(rkSign));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

extern "C" int mitgcm_mom_fluxform_f32(const void* const* table, int n,
                                       int nr, int ny, int nx, int oly,
                                       int olx, double viscAhD,
                                       double viscAhZ, double sideDragFactor,
                                       double rkSign, void* stream) {
  return mitgcm::launch_mom<float>(table, n, nr, ny, nx, oly, olx, viscAhD,
                                   viscAhZ, sideDragFactor, rkSign, stream);
}

extern "C" int mitgcm_mom_fluxform_f64(const void* const* table, int n,
                                       int nr, int ny, int nx, int oly,
                                       int olx, double viscAhD,
                                       double viscAhZ, double sideDragFactor,
                                       double rkSign, void* stream) {
  return mitgcm::launch_mom<double>(table, n, nr, ny, nx, oly, olx, viscAhD,
                                    viscAhZ, sideDragFactor, rkSign, stream);
}
