// Kernel T: implicit vertical diffusion, a tridiagonal solve per column.
//
// Replaces: mitgcm_tpu/model/thermodynamics.py:impldiff (:24-73), the
// Thomas elimination of impldiff.F / solve_tridiagonal.F, which XLA ran as
// an unrolled scan over the levels of the whole [nr, nyp, nxp] field. It
// runs four times per vi-gyre step: on theta and salt (implicitDiffusion)
// and on uStar and vStar (implicitViscosity).
//
// Bound: bytes. Per cell it reads the field, kappaR and recip_hFac and
// writes the result, plus one write and one read of the sweep's multiplier
// (~24 B/cell in float32 with the kappa level shared), for ~15 flops.
// Design: one thread per column (j, i), over the whole padded plane (a
// column has no horizontal neighbours, so halo columns come out as the
// twin's), i fastest so that every level's loads and stores are coalesced.
// The forward sweep goes down in registers and keeps y in `out` and the
// multiplier gam in a scratch field; the back substitution goes up over
// both. The coefficients a, b, c and the guards (a = 0 under a dry cell
// above, c = 0 over a dry cell below, reciprocal 1 of a zero pivot) are
// replayed in the JAX code's order, so with --fmad=false the result is
// bit-equal to the plain PyTorch twin (thermodynamics.py:_impldiff_plain).

#include "common.cuh"

namespace mitgcm {

template <typename T>
__device__ __forceinline__ T guarded_recip(T d) {
  return d != T(0) ? T(1) / d : T(1);
}

template <typename T>
__global__ void impldiff_kernel(const T* __restrict__ field,
                                const T* __restrict__ kappa,
                                const T* __restrict__ rhf,
                                const T* __restrict__ rdrF,
                                const T* __restrict__ rdrC,
                                T* __restrict__ gam, T* __restrict__ out,
                                int nr, int plane, T deltaT) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= plane) return;
  const size_t P = static_cast<size_t>(plane);
  const T ndt = -deltaT;
  // c of cell k (k <= nr-2), from the interface below it
  auto c_of = [&](int k) -> T {
    const size_t p = k * P + col;
    const T c = ndt * rhf[p] * rdrF[k] * kappa[p + P] * rdrC[k + 1];
    return rhf[p + P] == T(0) ? T(0) : c;
  };
  T c = c_of(0);
  T bet = guarded_recip(T(1) - (T(0) + c));
  T y = field[col] * bet;
  out[col] = y;
  gam[col] = T(0);
  for (int k = 1; k < nr; ++k) {
    const size_t p = k * P + col;
    T a = ndt * rhf[p] * rdrF[k] * kappa[p] * rdrC[k];
    a = rhf[p - P] == T(0) ? T(0) : a;
    const T c_above = c;
    c = k < nr - 1 ? c_of(k) : T(0);
    const T b = T(1) - (a + c);
    const T g = c_above * bet;
    bet = guarded_recip(b - a * g);
    y = bet * (field[p] - a * y);
    out[p] = y;
    gam[p] = g;
  }
  T x = y;
  for (int k = nr - 2; k >= 0; --k) {
    const size_t p = k * P + col;
    x = out[p] - gam[p + P] * x;
    out[p] = x;
  }
}

template <typename T>
int launch_impldiff(const void* field, const void* kappa, const void* rhf,
                    const void* rdrF, const void* rdrC, void* gam, void* out,
                    int nr, int plane, double deltaT, void* stream) {
  if (nr < 2 || plane < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  impldiff_kernel<T><<<(plane + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
      (const T*)field, (const T*)kappa, (const T*)rhf, (const T*)rdrF,
      (const T*)rdrC, (T*)gam, (T*)out, nr, plane, T(deltaT));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

extern "C" int mitgcm_impldiff_f32(const void* field, const void* kappa,
                                   const void* rhf, const void* rdrF,
                                   const void* rdrC, void* gam, void* out,
                                   int nr, int plane, double deltaT,
                                   void* stream) {
  return mitgcm::launch_impldiff<float>(field, kappa, rhf, rdrF, rdrC, gam,
                                        out, nr, plane, deltaT, stream);
}

extern "C" int mitgcm_impldiff_f64(const void* field, const void* kappa,
                                   const void* rhf, const void* rdrF,
                                   const void* rdrC, void* gam, void* out,
                                   int nr, int plane, double deltaT,
                                   void* stream) {
  return mitgcm::launch_impldiff<double>(field, kappa, rhf, rdrF, rdrC, gam,
                                         out, nr, plane, deltaT, stream);
}
