// Shared by the kernels of the multi-dimensional advection: M
// (gad_multidim.cu), O (gad_os7mp.cu) and P (gad_ppm.cu), and the sea ice's
// advection (seaice_advect.cu), which takes M's face flux flux_h. The table of
// their inputs, the zero-filled reads of the JAX code's shifts, and M's
// sweep that updates each cell by the fluxes through its two faces in one
// direction (mitgcm_tpu/model/gad.py:multidim_advection, :1138-1154; O's
// and P's tiles and walks update the same way):
//   X  dst = src - dt/V ((F(i+1) - F(i)) - T (U(i+1) - U(i))) mIn
//   Y  the same with the meridional fluxes and transports
//   R  localT = src - dt/V ((F(k+1) - F(k)) - T (W(k+1) - W(k))) rkSign mIn,
//      dst = (localT - T) / dt
// where T is the tracer (the compensation term always uses it), F the
// scheme's flux at a face (0 for a face outside the array and at the
// surface), U and W the transports (0 outside the array) and V/dt the
// volume factors deltaT recip_hFacC recip_drF recip_rA.
#pragma once

#include <cstring>

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct AdvArgs {
  // [nr, nyp, nxp]
  const T *uTrans, *vTrans, *rTrans, *uVel, *vVel, *wVel, *tracer, *maskW,
      *maskS, *maskC, *recip_hFacC;
  // [nyp, nxp]
  const T *recip_dxC, *recip_dyC, *recip_rA, *maskInC, *maskInW, *maskInS,
      *dxF, *dyF, *recip_dxF, *recip_dyF;
  // [nr], [nr+1], [nr]
  const T *recip_drF, *recip_drC, *drF;
};
constexpr int kAdvPointers = 24;

// torch.minimum / maximum (a NaN in either gives NaN)
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
struct AdvCell {
  const AdvArgs<T>& a;
  const T* src;
  int nr, nyp, nxp;
  T deltaT;

  __device__ size_t i3(int k, int j, int i) const {
    return (static_cast<size_t>(k) * nyp + j) * nxp + i;
  }
  __device__ size_t i2(int j, int i) const {
    return static_cast<size_t>(j) * nxp + i;
  }
  // src at (k, j, i), 0 outside the padded array (a zero-filled shift)
  __device__ T s(int k, int j, int i) const {
    return (i < 0 || i >= nxp || j < 0 || j >= nyp) ? T(0) : src[i3(k, j, i)];
  }
  // the face masks maskW * maskInW and maskS * maskInS, 0 outside
  __device__ T mW(int k, int j, int i) const {
    if (i < 0 || i >= nxp) return T(0);
    return a.maskW[i3(k, j, i)] * a.maskInW[i2(j, i)];
  }
  __device__ T mS(int k, int j, int i) const {
    if (j < 0 || j >= nyp) return T(0);
    return a.maskS[i3(k, j, i)] * a.maskInS[i2(j, i)];
  }
};

// One sweep in direction DIR (0: X, 1: Y, 2: R), one thread per cell of the
// whole padded array. flux(c, k, j, i) is the scheme's flux at the west
// (X), south (Y) or top (R) face of (k, j, i), 0 outside the array.
template <typename T, int DIR, typename Flux>
__global__ void adv_sweep(const AdvArgs<T> a, const Flux flux,
                          const T* __restrict__ src, T* __restrict__ dst,
                          int nr, int nyp, int nxp, T deltaT, T rkSign) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const AdvCell<T> c{a, src, nr, nyp, nxp, deltaT};
  const size_t p = c.i3(k, j, i);
  const size_t q = c.i2(j, i);
  const T tr = a.tracer[p];
  const T vol = deltaT * a.recip_hFacC[p] * a.recip_drF[k] * a.recip_rA[q];
  const T mIn = a.maskInC[q];
  if (DIR == 0) {
    const T uE = i + 1 < nxp ? a.uTrans[p + 1] : T(0);
    dst[p] = src[p] - vol * ((flux(c, k, j, i + 1) - flux(c, k, j, i)) -
                             tr * (uE - a.uTrans[p])) * mIn;
  } else if (DIR == 1) {
    const T vN = j + 1 < nyp ? a.vTrans[p + nxp] : T(0);
    dst[p] = src[p] - vol * ((flux(c, k, j + 1, i) - flux(c, k, j, i)) -
                             tr * (vN - a.vTrans[p])) * mIn;
  } else {
    const size_t P = static_cast<size_t>(nyp) * nxp;
    const T rKp = k + 1 < nr ? a.rTrans[p + P] : T(0);
    const T localT =
        src[p] - vol * ((flux(c, k + 1, j, i) - flux(c, k, j, i)) -
                        tr * (rKp - a.rTrans[p])) * rkSign * mIn;
    dst[p] = (localT - tr) / deltaT;
  }
}

#ifdef __CUDACC__
// Launch one sweep on the stream; the caller returns cudaGetLastError().
template <typename T, int DIR, typename Flux>
void launch_sweep(const AdvArgs<T>& a, const Flux& flux, const void* src,
                  void* dst, int nr, int nyp, int nxp, double deltaT,
                  double rkSign, cudaStream_t stream) {
  const dim3 g((nxp + BX - 1) / BX, (nyp + BY - 1) / BY, nr);
  adv_sweep<T, DIR, Flux><<<g, dim3(BX, BY), 0, stream>>>(
      a, flux, (const T*)src, (T*)dst, nr, nyp, nxp, T(deltaT), T(rkSign));
}
#endif

// The pointer table as the struct (the wrapper's table is in its order).
template <typename T>
bool adv_args(const void* const* table, int n, AdvArgs<T>* a) {
  static_assert(sizeof(AdvArgs<T>) == kAdvPointers * sizeof(void*),
                "AdvArgs must be a plain table of pointers");
  if (n != kAdvPointers) return false;
  std::memcpy(a, table, sizeof(*a));
  return true;
}

// M's horizontal schemes: the face flux of schemes 1, 20, 30, 33 and 77
// (gad.py:adv_flux_x, _adv_flux_highorder), shared with the sea ice
constexpr int kUpwind1 = 1, kCentered2 = 2, kUpwind3 = 3, kCentered4 = 4,
              kDst2 = 20, kDst3 = 30, kDst3FluxLimit = 33, kFluxLimit = 77;

// the Superbee limiter of the slope ratio, with its overflow guard
// (gad.py:791-797)
template <typename T>
__device__ __forceinline__ T superbee(T Rj, T crRaw) {
  const T crMax = T(1.0e6);
  T cr;
  if (fabs(Rj) * crMax <= fabs(crRaw)) {
    cr = (crRaw >= T(0) ? crMax : -crMax) * (Rj >= T(0) ? T(1) : T(-1));
  } else {
    cr = crRaw / (Rj == T(0) ? T(1) : Rj);
  }
  return nmax(nmax(nmin(T(2.0) * cr, T(1)), nmin(cr, T(2.0))), T(0));
}

// DST-3 flux-limited weight psi for the ratio theta = R / Rj (gad.py:818-833)
template <typename T>
__device__ __forceinline__ T dst3fl_psi(T Rj, T R, T cfl, T d0, T d1) {
  const T thetaMax = T(1.0e20);
  T theta;
  if (fabs(Rj) * thetaMax <= fabs(R)) {
    theta = R * Rj >= T(0) ? thetaMax : -thetaMax;
  } else {
    theta = R / (Rj == T(0) ? T(1) : Rj);
  }
  const T psi = d0 + d1 * theta;
  return nmax(nmin(nmin(psi, T(1)), theta * (T(1) - cfl) / (cfl + T(1.0e-20))),
              T(0));
}

// the horizontal flux at a face (gad.py:adv_flux_x, _adv_flux_highorder):
// trans the transport, vdt the velocity times deltaT over the spacing, t
// and tm1 the tracer on either side, Rjp / Rj / Rjm the masked differences
// across the faces up to one cell away
template <typename T, int S>
__device__ T flux_h(T trans, T vdt, T t, T tm1, T Rjp, T Rj, T Rjm) {
  const T absT = fabs(trans);
  if (S == kUpwind1 || S == kDst2) {
    // gad_dst2u1_adv_x.F: Lax-Wendroff, or upwind with a limit of 1
    const T limit = S == kUpwind1 ? T(1) : vdt;
    return T(0.5) * (trans * (t + tm1) - absT * limit * (t - tm1));
  }
  const T cfl = fabs(vdt);
  if (S == kFluxLimit) {
    const T lim = superbee(Rj, trans > T(0) ? Rjm : Rjp);
    return trans * (t + tm1) * T(0.5) -
           absT * ((T(1) - lim) + cfl * lim) * Rj * T(0.5);
  }
  const T sixth = T(1.0 / 6.0);
  const T d0 = (T(2.0) - cfl) * (T(1) - cfl) * sixth;
  const T d1 = (T(1) - cfl * cfl) * sixth;
  if (S == kDst3)
    return T(0.5) * (trans + absT) * (tm1 + (d0 * Rj + d1 * Rjm)) +
           T(0.5) * (trans - absT) * (t - (d0 * Rj + d1 * Rjp));
  const T psiP = dst3fl_psi(Rj, Rjm, cfl, d0, d1);
  const T psiM = dst3fl_psi(Rj, Rjp, cfl, d0, d1);
  return T(0.5) * (trans + absT) * (tm1 + psiP * Rj) +
         T(0.5) * (trans - absT) * (t - psiM * Rj);
}

}  // namespace mitgcm
