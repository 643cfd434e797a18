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

// the face flux at the west (X) or south (Y) face of (j, i) of field c,
// 0 for a face outside the array (seaice.py:_flux_x/_flux_y)
template <typename T, int S, bool X>
__device__ T ice_flux(const IceAdvArgs<T>& a, const IceCell<T>& c, int j,
                      int i, T dt) {
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

template <typename T, int S>
__global__ void seaice_advect_x_kernel(const IceAdvArgs<T> a,
                                       const T* __restrict__ src,
                                       T* __restrict__ dst, int nyp, int nxp,
                                       T dt) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t p = static_cast<size_t>(j) * nxp + i;
  const T fac = dt * a.maskInC[p] * a.recip_rA[p];
  for (int f = 0; f < 3; ++f) {
    const IceCell<T> c{src + f * P, nyp, nxp};
    const T F0 = ice_flux<T, S, true>(a, c, j, i, dt);
    const T F1 = ice_flux<T, S, true>(a, c, j, i + 1, dt);
    dst[f * P + p] = src[f * P + p] - fac * (F1 - F0);
  }
}

template <typename T, int S>
__global__ void seaice_advect_y_kernel(const IceAdvArgs<T> a,
                                       const T* __restrict__ fld,
                                       const T* __restrict__ localT,
                                       T* __restrict__ dst, int nyp, int nxp,
                                       int ol, T dt, T kh0, T kh1, T kh2) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t p = static_cast<size_t>(j) * nxp + i;
  const bool inside = j >= ol && j < nyp - ol && i >= ol && i < nxp - ol;
  const T fac = dt * a.maskInC[p] * a.recip_rA[p];
  const T hm = a.heffm[p];
  const T khs[3] = {kh0, kh1, kh2};
  for (int f = 0; f < 3; ++f) {
    const T f0 = fld[f * P + p];
    if (!inside) {
      dst[f * P + p] = f0;
      continue;
    }
    const IceCell<T> c{localT + f * P, nyp, nxp};
    const T G0 = ice_flux<T, S, false>(a, c, j, i, dt);
    const T G1 = ice_flux<T, S, false>(a, c, j + 1, i, dt);
    const T lt = localT[f * P + p] - fac * (G1 - G0);
    T g = (lt - f0) / dt;
    const T kh = khs[f];
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
    dst[f * P + p] = hm * (f0 + dt * g);
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

template <typename T>
int launch_seaice_advect(bool x, const void* const* table, int n,
                         const void* src, const void* localT, void* dst,
                         int nyp, int nxp, int ol, int scheme, double dt,
                         double kh0, double kh1, double kh2,
                         cudaStream_t stream) {
  IceAdvArgs<T> a;
  if (!ice_adv_args(table, n, &a)) return (int)cudaErrorInvalidValue;
  const dim3 g((nxp + BX - 1) / BX, (nyp + BY - 1) / BY, 1);
  const dim3 b(BX, BY);
#define MITGCM_ICE_ADV_CASE(S)                                              \
  case S:                                                                   \
    if (x)                                                                  \
      seaice_advect_x_kernel<T, S><<<g, b, 0, stream>>>(                    \
          a, (const T*)src, (T*)dst, nyp, nxp, T(dt));                      \
    else                                                                    \
      seaice_advect_y_kernel<T, S><<<g, b, 0, stream>>>(                    \
          a, (const T*)src, (const T*)localT, (T*)dst, nyp, nxp, ol, T(dt), \
          T(kh0), T(kh1), T(kh2));                                          \
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
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define MITGCM_SEAICE_ADVECT_ENTRY_POINTS(T, SUF)                            \
  extern "C" int mitgcm_seaice_advect_x_##SUF(                               \
      const void* const* table, int n, const void* src, void* dst, int nyp,  \
      int nxp, int ol, int scheme, double dt, void* stream) {                \
    return mitgcm::launch_seaice_advect<T>(true, table, n, src, nullptr,     \
                                           dst, nyp, nxp, ol, scheme, dt,    \
                                           0.0, 0.0, 0.0,                    \
                                           (cudaStream_t)stream);            \
  }                                                                          \
  extern "C" int mitgcm_seaice_advect_y_##SUF(                               \
      const void* const* table, int n, const void* fld, const void* localT,  \
      void* dst, int nyp, int nxp, int ol, int scheme, double dt,            \
      double kh0, double kh1, double kh2, void* stream) {                    \
    return mitgcm::launch_seaice_advect<T>(false, table, n, fld, localT,     \
                                           dst, nyp, nxp, ol, scheme, dt,    \
                                           kh0, kh1, kh2,                    \
                                           (cudaStream_t)stream);            \
  }

MITGCM_SEAICE_ADVECT_ENTRY_POINTS(float, f32)
MITGCM_SEAICE_ADVECT_ENTRY_POINTS(double, f64)
