// Shared by the kernels of the multi-dimensional advection: M
// (gad_multidim_tile.cuh), O (gad_os7mp_tile.cuh) and P (gad_ppm_tile.cuh),
// and the sea ice's advection (seaice_advect.cu), which takes M's face flux
// flux_h: the table of their inputs, torch's NaN-keeping minimum and
// maximum, and M's limiters and horizontal face flux. The sweeps update
// each cell by the fluxes through its two faces in one direction
// (mitgcm_tpu/model/gad.py:multidim_advection, :1138-1154):
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
