// Kernel seaice_advect: the sea ice's multi-dimensional advection of HEFF,
// AREA and HSNOW, with their harmonic diffusion.
//
// Replaces: mitgcm_tpu/model/seaice.py:SeaIce.advdiff (:1474-1556) with
// _advect_field (:1330, Cartesian), _flux_x/_flux_y (:1359/:1371, through
// gad.py:adv_flux_x/y :839/:877) and _diffuse_field (:1350), which XLA
// fused into a few 2-D passes per field on the TPU.
//
// Two launches per step, each carrying the three fields stacked [3, nyp,
// nxp]: seaice_advect_x writes the X-updated fields
//   localT = fld - dt maskInC recip_rA (F(i+1) - F(i)),
// seaice_advect_y updates them in Y, forms g = (localT - fld) / dt, adds
// the diffusion where diffKh > 0 and writes HEFFM (fld + dt g) on interior
// cells and fld on the halo (the interior-only update). The face flux is
// kernel M's (gad_advect.cuh:flux_h, schemes 1, 20, 30, 33 and 77), with the
// sea ice's face masks (SIMaskU/V alone) and 2-D update: no thickness
// factors and no tracer * divergence term, unlike M.
//
// Bound: bytes. Per launch a cell reads the three fields (six in Y), the
// ice velocity, a face mask and four metric fields and writes three, ~60
// B/cell in float32 for ~150 flops; the neighbours (i-2 .. i+1) hit L1/L2.
// Design: one thread per cell of the padded array, each computing both
// face fluxes of its cell in the JAX code's order (as M does), with the
// zero-filled shifts of the JAX code (a neighbour outside the array reads
// 0, a face flux outside it is 0), so every padded cell is bit-equal to the
// twin (model/seaice.py:_advect_plain) when built with --fmad=false.
//
// With ice tracers (seaice.py:1516-1556; ntr > 0, the same launches) the
// stacked fields grow to 3 + nTr. X forms each ice tracer's extensive
// form ext = HEFFM * tracer * mate (its mate HEFF or AREA before the step)
// where it reads it, a neighbour's included (the same product, so the same
// bits), writes it to the tracer's slot of the fields that Y reads, and
// advects it with the fields. Y advects and diffuses it with its mate's
// diffusivity and, in its epilogue (the new mate is already in a register
// of the same thread, so no launch of its own), divides it by the new
// mate where that reaches siEps (HEFF) or area_floor (AREA), caps it by
// the 5-point maximum of the old tracer (ADVCAP), clears its negative
// part where the mate is there, and writes it on interior cells (the old
// tracer on the halo).

#pragma once

#include <cstring>

#include "gad_advect.cuh"

namespace mitgcm {

template <typename T>
struct IceAdvArgs {
  // [nyp, nxp]
  const T *uIce, *vIce, *maskW, *maskS, *maskInC, *recip_rA, *recip_dxC,
      *recip_dyC, *dxG, *dyG, *heffm;
};
constexpr int kIceAdvPointers = 11;

template <typename T>
struct IceCell {
  const T* f;   // one field [nyp, nxp]
  int nyp, nxp;
  __device__ T operator()(int j, int i) const {
    return (i < 0 || i >= nxp || j < 0 || j >= nyp)
               ? T(0) : f[static_cast<size_t>(j) * nxp + i];
  }
};

// An ice tracer's extensive form HEFFM * tracer * mate, formed where it is
// read, 0 outside the array
template <typename T>
struct ExtCell {
  const T *tr, *mate, *hm;
  int nyp, nxp;
  __device__ T operator()(int j, int i) const {
    if (i < 0 || i >= nxp || j < 0 || j >= nyp) return T(0);
    const size_t q = static_cast<size_t>(j) * nxp + i;
    return hm[q] * tr[q] * mate[q];
  }
};

// the 'siEps' below which HEFF carries no tracer (seaice.py:1518)
constexpr double kSiEps = 1.0e-5;

// the face flux at the west (X) or south (Y) face of (j, i) of field c,
// 0 for a face outside the array (seaice.py:_flux_x/_flux_y)
template <typename T, int S, bool X, typename C>
__device__ T ice_flux(const IceAdvArgs<T>& a, const C& c, int j, int i,
                      T dt) {
  if ((X && i >= c.nxp) || (!X && j >= c.nyp)) return T(0);
  const size_t p = static_cast<size_t>(j) * c.nxp + i;
  const IceCell<T> m{X ? a.maskW : a.maskS, c.nyp, c.nxp};
  const int dj = X ? 0 : 1, di = X ? 1 : 0;
  const T vel = X ? a.uIce[p] : a.vIce[p];
  const T trans = vel * ((X ? a.dyG[p] : a.dxG[p]) * m(j, i));
  const T vdt = vel * dt * (X ? a.recip_dxC[p] : a.recip_dyC[p]);
  const T t = c(j, i), tm1 = c(j - dj, i - di);
  if (S == kUpwind1 || S == kDst2)
    return flux_h<T, S>(trans, vdt, t, tm1, T(0), T(0), T(0));
  const T Rjp = (c(j + dj, i + di) - t) * m(j + dj, i + di);
  const T Rj = (t - tm1) * m(j, i);
  const T Rjm = (tm1 - c(j - 2 * dj, i - 2 * di)) * m(j - dj, i - di);
  return flux_h<T, S>(trans, vdt, t, tm1, Rjp, Rj, Rjm);
}

// X: the X-updated fields; with Tr the ntr tracers' (tr, [ntr, nyp, nxp])
// extensive forms too, written to ext (the slots 3.. of the stacked
// fields; src holds slot 0 HEFF, 1 AREA, 2 HSNOW; a tracer's mate is AREA
// where bit t of `mates` is set). Without tracers the launch takes the
// variant with no tracer code (Tr false): the tracers' loop and its
// registers cost the fields' loop occupancy.
template <typename T, int S, bool Tr>
__global__ void seaice_advect_x_kernel(const IceAdvArgs<T> a,
                                       const T* __restrict__ src,
                                       const T* __restrict__ tr,
                                       T* __restrict__ ext,
                                       T* __restrict__ dst, int nyp, int nxp,
                                       int ntr, int mates, T dt) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t p = static_cast<size_t>(j) * nxp + i;
  const T fac = dt * a.maskInC[p] * a.recip_rA[p];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const IceCell<T> c{src + f * P, nyp, nxp};
    const T F0 = ice_flux<T, S, true>(a, c, j, i, dt);
    const T F1 = ice_flux<T, S, true>(a, c, j, i + 1, dt);
    dst[f * P + p] = src[f * P + p] - fac * (F1 - F0);
  }
  if constexpr (Tr) {
    for (int t = 0; t < ntr; ++t) {
      const ExtCell<T> c{tr + t * P, src + ((mates >> t) & 1) * P, a.heffm,
                         nyp, nxp};
      const T F0 = ice_flux<T, S, true>(a, c, j, i, dt);
      const T F1 = ice_flux<T, S, true>(a, c, j, i + 1, dt);
      const T e = c(j, i);
      ext[t * P + p] = e;
      dst[(3 + t) * P + p] = e - fac * (F1 - F0);
    }
  }
}

// Y: HEFFM (fld + dt g) on the interior, fld on the halo, for the 3 + ntr
// fields; then with Tr each tracer from its extensive form (the epilogue
// above), the old tracer tr on the halo
template <typename T, int S, bool Tr>
__global__ void seaice_advect_y_kernel(const IceAdvArgs<T> a,
                                       const T* __restrict__ fld,
                                       const T* __restrict__ localT,
                                       const T* __restrict__ tr,
                                       T* __restrict__ dst, int nyp, int nxp,
                                       int ol, int ntr, int mates, T dt,
                                       T kh0, T kh1, T kh2, T area_floor) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t p = static_cast<size_t>(j) * nxp + i;
  const bool inside = j >= ol && j < nyp - ol && i >= ol && i < nxp - ol;
  if (!inside) {
#pragma unroll
    for (int f = 0; f < 3; ++f) dst[f * P + p] = fld[f * P + p];
    if constexpr (Tr)
      for (int t = 0; t < ntr; ++t) dst[(3 + t) * P + p] = tr[t * P + p];
    return;
  }
  const T fac = dt * a.maskInC[p] * a.recip_rA[p];
  const T hm = a.heffm[p];
  // field f advected in Y and diffused with kh: HEFFM (fld + dt g)
  auto step = [&](int f, T kh) -> T {
    const T f0 = fld[f * P + p];
    const IceCell<T> c{localT + f * P, nyp, nxp};
    const T G0 = ice_flux<T, S, false>(a, c, j, i, dt);
    const T G1 = ice_flux<T, S, false>(a, c, j + 1, i, dt);
    const T lt = localT[f * P + p] - fac * (G1 - G0);
    T g = (lt - f0) / dt;
    if (kh > T(0)) {
      const IceCell<T> d{fld + f * P, nyp, nxp};
      // fZon at the west faces of (j, i) and (j, i+1), fMer at the south
      // faces of (j, i) and (j+1, i); 0 outside the array
      auto zon = [&](int jj, int ii) -> T {
        if (ii >= nxp) return T(0);
        const size_t q = static_cast<size_t>(jj) * nxp + ii;
        return -kh * (a.dyG[q] * a.maskW[q]) * a.recip_dxC[q] *
               (d(jj, ii) - d(jj, ii - 1));
      };
      auto mer = [&](int jj, int ii) -> T {
        if (jj >= nyp) return T(0);
        const size_t q = static_cast<size_t>(jj) * nxp + ii;
        return -kh * (a.dxG[q] * a.maskS[q]) * a.recip_dyC[q] *
               (d(jj, ii) - d(jj - 1, ii));
      };
      g = g + (-hm) * a.recip_rA[p] *
                  ((zon(j, i + 1) - zon(j, i)) + (mer(j + 1, i) - mer(j, i)));
    }
    return hm * (f0 + dt * g);
  };
  const T heff = step(0, kh0), area = step(1, kh1);
  dst[p] = heff;
  dst[P + p] = area;
  dst[2 * P + p] = step(2, kh2);
  if constexpr (Tr) {
    for (int t = 0; t < ntr; ++t) {
      // the tracer from its extensive form (seaice.py:1525-1553): the new
      // mate is HEFF or AREA of this cell
      const bool on_area = (mates >> t) & 1;
      const T v = step(3 + t, on_area ? kh1 : kh0);
      const T carrier = on_area ? area : heff;
      const bool live = carrier >= (on_area ? area_floor : T(kSiEps));
      T x = live ? v / carrier : T(0);
      const T* prev = tr + t * P;
      const T nbmax = nmax(nmax(nmax(prev[p], prev[p + 1]),
                                nmax(prev[p - 1], prev[p + nxp])),
                           prev[p - nxp]);
      x = x - nmax(T(0), x - nbmax);
      if (live) x = x - nmin(T(0), x);
      dst[(3 + t) * P + p] = x;
    }
  }
}

template <typename T>
bool ice_adv_args(const void* const* table, int n, IceAdvArgs<T>* a) {
  static_assert(sizeof(IceAdvArgs<T>) == kIceAdvPointers * sizeof(void*),
                "IceAdvArgs must be a plain table of pointers");
  if (n != kIceAdvPointers) return false;
  std::memcpy(a, table, sizeof(*a));
  return true;
}

template <typename T, typename Start>
int launch_seaice_advect(bool x, const void* const* table, int n,
                         const void* fld, const void* localT, const void* tr,
                         void* dst, int nyp, int nxp, int ol, int scheme,
                         int ntr, int mates, double dt, double kh0,
                         double kh1, double kh2, double area_floor,
                         Start start) {
  IceAdvArgs<T> a;
  if (!ice_adv_args(table, n, &a) || ntr < 0 || (ntr > 0 && tr == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 g((nxp + BX - 1) / BX, (nyp + BY - 1) / BY, 1);
  const dim3 b(BX, BY);
  const size_t P = static_cast<size_t>(nyp) * nxp;
#define MITGCM_ICE_ADV_START(S, TR)                                         \
  if (x)                                                                    \
    start(seaice_advect_x_kernel<T, S, TR>, g, b, a, (const T*)fld,         \
          (const T*)tr, (T*)fld + 3 * P, (T*)dst, nyp, nxp, ntr, mates,     \
          T(dt));                                                           \
  else                                                                      \
    start(seaice_advect_y_kernel<T, S, TR>, g, b, a, (const T*)fld,         \
          (const T*)localT, (const T*)tr, (T*)dst, nyp, nxp, ol, ntr, mates, \
          T(dt), T(kh0), T(kh1), T(kh2), T(area_floor));
#define MITGCM_ICE_ADV_CASE(S)                                              \
  case S:                                                                   \
    if (ntr > 0) {                                                          \
      MITGCM_ICE_ADV_START(S, true)                                         \
    } else {                                                                \
      MITGCM_ICE_ADV_START(S, false)                                        \
    }                                                                       \
    break;
  switch (scheme) {
    MITGCM_ICE_ADV_CASE(kUpwind1)
    MITGCM_ICE_ADV_CASE(kDst2)
    MITGCM_ICE_ADV_CASE(kDst3)
    MITGCM_ICE_ADV_CASE(kDst3FluxLimit)
    MITGCM_ICE_ADV_CASE(kFluxLimit)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MITGCM_ICE_ADV_CASE
#undef MITGCM_ICE_ADV_START
  return (int)cudaGetLastError();
}

}  // namespace mitgcm


