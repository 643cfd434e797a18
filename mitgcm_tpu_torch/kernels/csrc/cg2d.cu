// Kernel A: one preconditioned-CG iteration of the 2-D free-surface solve.
//
// Replaces: mitgcm_tpu/solver/cg2d.py:_cg2d_raw, the while_loop body
// (:250-267) with _apply_A (:118), _apply_P (:124) and the interior-masked
// dot products (:221-226). XLA fused that body into a few passes on the
// TPU; here it is three kernels per iteration:
//   cg2d_stencil_dot  q = P r with dot(q, r), and q = A s with dot(s, q)
//   cg2d_s_update     s = q + beta s, beta = eta_n / eta_nm1
//   cg2d_xr_update    x += alpha s, r -= alpha q, dot(r, r),
//                     alpha = eta_n / dot(s, q)
// alpha and beta never leave the device: each thread divides the two
// device scalars itself.
//
// Bound: bytes. A 5-point stencil does ~10 flops per 7 loads, far below
// the card's ~20 flops/byte, and the 2-D fields of a realistic basin
// (1024^2 cells, 4-8 MB each) fit in the 50 MB L2, so an iteration is
// bound by L2 traffic and by launch latency rather than by HBM.
// Design: one thread per interior cell, i fastest for coalescing; the
// dot products are fused into the producing kernels (no extra pass) and
// summed deterministically (common.cuh:grid_sum), so every run takes the
// same number of iterations. The halo wrap of s and r is folded into the
// neighbour indexing (common.cuh:wrap): every stored result and every dot
// is interior-masked (cg2d.py:252-266), so no halo is ever filled inside
// the loop. Only interior cells are written.
//
// The arithmetic order of each expression is that of the JAX code, so
// (built with --fmad=false) each stored field is bit-equal to the plain
// PyTorch twin; only the order of the dot-product sums differs.

#include "common.cuh"

namespace mitgcm {

template <typename T>
__global__ void stencil_dot_kernel(const T* __restrict__ cW,
                                   const T* __restrict__ cS,
                                   const T* __restrict__ cC,
                                   const T* __restrict__ y,
                                   T* __restrict__ out, T* dot_out,
                                   T* partials, unsigned int* counter,
                                   int ny, int nx, int oly, int olx,
                                   int center_first) {
  __shared__ T sh[NT];
  const int i0 = blockIdx.x * BX + threadIdx.x;
  const int j0 = blockIdx.y * BY + threadIdx.y;
  T prod = T(0);
  if (i0 < nx && j0 < ny) {
    const int nxp = nx + 2 * olx;
    const int i = i0 + olx, j = j0 + oly;
    const size_t p = static_cast<size_t>(j) * nxp + i;
    const size_t row = static_cast<size_t>(j) * nxp;
    const T yc = y[p];
    const T yw = y[row + wrap(i - 1, olx, nx)];
    const T ye = y[row + wrap(i + 1, olx, nx)];
    const T ys = y[static_cast<size_t>(wrap(j - 1, oly, ny)) * nxp + i];
    const T yn = y[static_cast<size_t>(wrap(j + 1, oly, ny)) * nxp + i];
    T v;
    if (center_first) {  // _apply_P order
      v = cC[p] * yc + cW[p] * yw + cW[p + 1] * ye + cS[p] * ys
          + cS[p + nxp] * yn;
    } else {             // _apply_A order
      v = cW[p] * yw + cW[p + 1] * ye + cS[p] * ys + cS[p + nxp] * yn
          + cC[p] * yc;
    }
    out[p] = v;
    prod = v * yc;
  }
  grid_sum(prod, sh, partials, counter, dot_out);
}

template <typename T>
__global__ void s_update_kernel(const T* __restrict__ q, T* __restrict__ s,
                                const T* eta_n, const T* eta_nm1, int ny,
                                int nx, int oly, int olx) {
  const int i0 = blockIdx.x * BX + threadIdx.x;
  const int j0 = blockIdx.y * BY + threadIdx.y;
  if (i0 >= nx || j0 >= ny) return;
  const size_t p = static_cast<size_t>(j0 + oly) * (nx + 2 * olx) + i0 + olx;
  const T beta = *eta_n / *eta_nm1;
  s[p] = q[p] + beta * s[p];
}

template <typename T>
__global__ void xr_update_kernel(T* __restrict__ x, T* __restrict__ r,
                                 const T* __restrict__ s,
                                 const T* __restrict__ q, const T* num,
                                 const T* den, T* dot_out, T* partials,
                                 unsigned int* counter, int ny, int nx,
                                 int oly, int olx) {
  __shared__ T sh[NT];
  const int i0 = blockIdx.x * BX + threadIdx.x;
  const int j0 = blockIdx.y * BY + threadIdx.y;
  T prod = T(0);
  if (i0 < nx && j0 < ny) {
    const size_t p =
        static_cast<size_t>(j0 + oly) * (nx + 2 * olx) + i0 + olx;
    const T alpha = *num / *den;
    x[p] = x[p] + alpha * s[p];
    const T rn = r[p] - alpha * q[p];
    r[p] = rn;
    prod = rn * rn;
  }
  grid_sum(prod, sh, partials, counter, dot_out);
}

}  // namespace mitgcm

using mitgcm::grid2d;
using mitgcm::BX;
using mitgcm::BY;

#define MITGCM_CG2D_ENTRY_POINTS(T, SUF)                                      \
  extern "C" int mitgcm_cg2d_stencil_dot_##SUF(                               \
      const void* cW, const void* cS, const void* cC, const void* y,          \
      void* out, void* dot_out, void* partials, void* counter, int ny,        \
      int nx, int oly, int olx, int center_first, void* stream) {             \
    mitgcm::stencil_dot_kernel<T>                                             \
        <<<grid2d(ny, nx), dim3(BX, BY), 0, (cudaStream_t)stream>>>(          \
            (const T*)cW, (const T*)cS, (const T*)cC, (const T*)y, (T*)out,   \
            (T*)dot_out, (T*)partials, (unsigned int*)counter, ny, nx, oly,   \
            olx, center_first);                                               \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int mitgcm_cg2d_s_update_##SUF(                                  \
      const void* q, void* s, const void* eta_n, const void* eta_nm1,         \
      int ny, int nx, int oly, int olx, void* stream) {                       \
    mitgcm::s_update_kernel<T>                                                \
        <<<grid2d(ny, nx), dim3(BX, BY), 0, (cudaStream_t)stream>>>(          \
            (const T*)q, (T*)s, (const T*)eta_n, (const T*)eta_nm1, ny, nx,   \
            oly, olx);                                                        \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int mitgcm_cg2d_xr_update_##SUF(                                 \
      void* x, void* r, const void* s, const void* q, const void* num,        \
      const void* den, void* dot_out, void* partials, void* counter, int ny,  \
      int nx, int oly, int olx, void* stream) {                               \
    mitgcm::xr_update_kernel<T>                                               \
        <<<grid2d(ny, nx), dim3(BX, BY), 0, (cudaStream_t)stream>>>(          \
            (T*)x, (T*)r, (const T*)s, (const T*)q, (const T*)num,            \
            (const T*)den, (T*)dot_out, (T*)partials, (unsigned int*)counter, \
            ny, nx, oly, olx);                                                \
    return (int)cudaGetLastError();                                           \
  }

MITGCM_CG2D_ENTRY_POINTS(float, f32)
MITGCM_CG2D_ENTRY_POINTS(double, f64)

// Number of per-block partial sums a dot-producing cg2d kernel writes.
extern "C" int mitgcm_cg2d_num_partials(int ny, int nx) {
  const dim3 g = grid2d(ny, nx);
  return (int)(g.x * g.y);
}

extern "C" const char* mitgcm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
