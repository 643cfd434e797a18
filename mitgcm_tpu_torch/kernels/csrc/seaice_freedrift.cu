// Kernel seaice_freedrift: the sea ice's free-drift velocity, one launch.
//
// Replaces: mitgcm_tpu/model/seaice.py:SeaIce.freedrift (:1246-1286), which
// XLA ran on the TPU as fused 2-D passes: the surface stress and the ocean
// velocity at C points, the analytic balance of stress and Coriolis against
// the quadratic ice-ocean drag (atan2 and sqrt), the velocity at C points,
// its halo fill, the average to the U and V points, masked, and a second
// fill.
//
// One thread per padded cell. Both fills are done by computing: a thread
// computes the velocity at the interior cell its cell wraps to
// (common.cuh:wrap), whose C-point solves read the C cells beside it, again
// wrapped. Every other read is the JAX code's zero-filled shift
// (seaice.cuh:Fld). atan2, sin, cos and sqrt are CUDA's own, as PyTorch's
// on the card, so the twin agrees bit for bit.
//
// Bound: bytes (9 2-D fields read, 2 written); each thread solves 3 cells.

#include "seaice.cuh"

namespace mitgcm {

template <typename T>
struct FreedriftArgs {
  const T *heff, *uVel0, *vVel0, *forcex0, *forcey0, *fCori, *yC, *maskU,
      *maskV;
  T *uo, *vo;
};
constexpr int kFreedriftPointers = 11;

struct FreedriftParams {
  double rhoIce, rhoConst, waterDrag, waterDragSouth;
};

// the free-drift velocity at C point (j, i), inside the array
template <typename T>
__device__ void drift_at(const FreedriftArgs<T>& a, const FreedriftParams& q,
                         int nyp, int nxp, int j, int i, T* uic, T* vic) {
  const Fld<T> fx{a.forcex0, nyp, nxp}, fy{a.forcey0, nyp, nxp},
      u0{a.uVel0, nyp, nxp}, v0{a.vVel0, nyp, nxp};
  const size_t p = static_cast<size_t>(j) * nxp + i;
  const T taux_c = T(0.5) * (fx(j, i) + fx(j, i + 1));
  const T tauy_c = T(0.5) * (fy(j, i) + fy(j + 1, i));
  const T mIceCor = T(q.rhoIce) * a.heff[p] * a.fCori[p];
  const T u_c = T(0.5) * (u0(j, i) + u0(j, i + 1));
  const T v_c = T(0.5) * (v0(j, i) + v0(j + 1, i));
  const T rhs_x = -taux_c - mIceCor * v_c;
  const T rhs_y = -tauy_c + mIceCor * u_c;
  const T nsq = rhs_x * rhs_x + rhs_y * rhs_y;
  const bool pos = nsq > T(0);
  const T rhs_n = pos ? sqrt(nsq) : T(0);
  const T rhs_a = pos ? atan2(rhs_y, rhs_x) : T(0);
  const T wDrag = a.yC[p] < T(0) ? T(q.waterDragSouth) : T(q.waterDrag);
  const T inv = T(1.0) / (T(q.rhoConst) * wDrag);
  const T t2 = (inv * inv) * mIceCor * mIceCor;
  const T t3 = (inv * inv) * rhs_n * rhs_n;
  const T t4 = t2 * t2 + T(4.0) * t3;
  const T sol_n = t3 > T(0) ? sqrt(T(0.5) * (sqrt(t4) - t2)) : T(0);
  const T c1 = wDrag * T(q.rhoConst);
  const T s2 = c1 * sol_n * sol_n;
  const T s3 = mIceCor * sol_n;
  const T s4 = s2 * s2 + s3 * s3;
  const T sol_a = s4 > T(0) ? rhs_a - atan2(s3, s2) : T(0);
  *uic = u_c - sol_n * cos(sol_a);
  *vic = v_c - sol_n * sin(sol_a);
}

template <typename T>
__global__ void seaice_freedrift_kernel(const FreedriftArgs<T> a,
                                        const FreedriftParams q, int ny,
                                        int nx, int ol) {
  const int nyp = ny + 2 * ol, nxp = nx + 2 * ol;
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t p = static_cast<size_t>(j) * nxp + i;
  // the velocity point this cell's fill copies, and its C neighbours as
  // the first fill left them
  const int jw = wrap(j, ol, ny), iw = wrap(i, ol, nx);
  const size_t w = static_cast<size_t>(jw) * nxp + iw;
  T uc, vc, uw, vw, us, vs;
  drift_at(a, q, nyp, nxp, jw, iw, &uc, &vc);
  drift_at(a, q, nyp, nxp, jw, wrap(iw - 1, ol, nx), &uw, &vw);
  drift_at(a, q, nyp, nxp, wrap(jw - 1, ol, ny), iw, &us, &vs);
  a.uo[p] = T(0.5) * (uw + uc) * a.maskU[w];
  a.vo[p] = T(0.5) * (vs + vc) * a.maskV[w];
}

template <typename T>
int launch_freedrift(const void* const* table, int n, const double* params,
                     int nparams, int ny, int nx, int ol,
                     cudaStream_t stream) {
  FreedriftArgs<T> a;
  if (!table_of<T, FreedriftArgs<T>, kFreedriftPointers>(table, n, &a) ||
      nparams != static_cast<int>(sizeof(FreedriftParams) / sizeof(double)) ||
      ny < 1 || nx < 1 || ol < 1)
    return (int)cudaErrorInvalidValue;
  FreedriftParams q;
  std::memcpy(&q, params, sizeof(q));
  seaice_freedrift_kernel<T>
      <<<grid2d(ny + 2 * ol, nx + 2 * ol), dim3(BX, BY), 0, stream>>>(
          a, q, ny, nx, ol);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define MITGCM_SEAICE_FREEDRIFT_ENTRY_POINT(T, SUF)                           \
  extern "C" int mitgcm_seaice_freedrift_##SUF(                               \
      const void* const* table, int n, const double* params, int nparams,     \
      int ny, int nx, int ol, void* stream) {                                 \
    return mitgcm::launch_freedrift<T>(table, n, params, nparams, ny, nx, ol, \
                                       (cudaStream_t)stream);                 \
  }

MITGCM_SEAICE_FREEDRIFT_ENTRY_POINT(float, f32)
MITGCM_SEAICE_FREEDRIFT_ENTRY_POINT(double, f64)
