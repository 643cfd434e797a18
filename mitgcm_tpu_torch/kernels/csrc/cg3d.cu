// Kernel H-cg3d: one preconditioned-CG iteration of the 3-D
// non-hydrostatic pressure solve.
//
// Replaces: mitgcm_tpu/solver/cg3d.py:_cg3d_raw, the while_loop body
// (:221-236) with _apply_A (:131, the 7-point operator), _apply_P (:141,
// the column tridiagonal preconditioner, LU-factored by build_cg3d) and
// the interior- and maskC-masked dot products. XLA fused that body into a
// few passes on the TPU; here it is three launches per iteration:
//   cg3d_precond_dot    q = P^-1 r, eta_n = dot(q, r)
//   cg3d_s_stencil_dot  s' = (q + beta s) imask, beta = eta_n / eta_nm1;
//                       qA = (A s') imask, dot(s', qA)
//   cg3d_xr_update      x += alpha s', r -= alpha qA, dot(r, r),
//                       alpha = eta_n / dot(s', qA); the stopping test
//
// Bound: bytes. Per iteration the three launches read the 7 operator
// arrays and the masks once and r, q, s, x a few times, ~12 field passes,
// for ~40 flops per cell: far below the card's ~20 flops/byte.
// Design: one thread per interior column (j, i), i fastest for
// coalescing, walking k inside each launch, so the column sweeps of P and
// the vertical neighbours of A live in registers.
//  - P's forward substitution writes q, the back substitution reads it
//    back: no per-thread level array, so no cap on nr.
//  - s is double-buffered: s_stencil_dot reads s from one buffer and
//    writes s' to the other (and A s' to qA, apart from P's q), because
//    it needs s' at the horizontal neighbours, which other blocks are
//    writing in the same launch: updating s in place would race. Each
//    thread recomputes its neighbours' s' from q and s (bit-equal to
//    theirs). The halo wrap of s (and of nothing else: every other
//    read is column-local) is folded into the neighbour indexing
//    (common.cuh:wrap), so no halo is filled inside the loop.
//  - The dot products are column sums in a fixed level order (k
//    descending for P's, during the back substitution; ascending for the
//    others) followed by common.cuh:grid_sum's fixed 2-D tree, so the
//    plain twin (solver/cg3d.py) reproduces them bit for bit and every run
//    takes the same number of iterations.
//  - The loop stays on the device: the last block of cg3d_xr_update
//    counts the iteration and sets a `done` word (ctrl[0]) when
//    dot(r, r) < tol^2 or the count reaches cg3dMaxIters, and every
//    launch returns at once while `done` is set. The host enqueues
//    iterations in batches and reads `done` once per batch; the result and
//    the count are those of stopping at once.
//
// The arithmetic order of each expression is that of the JAX code, so
// (built with --fmad=false) each stored field is bit-equal to the twin.

#include "common.cuh"

namespace mitgcm {

template <typename T>
__global__ void cg3d_precond_dot_kernel(
    const T* __restrict__ zMC, const T* __restrict__ zML,
    const T* __restrict__ zMU, const T* __restrict__ maskC,
    const T* __restrict__ r, T* __restrict__ q, T* dot_out, T* partials,
    unsigned int* counter, const int* ctrl, int nr, int ny, int nx, int oly,
    int olx) {
  if (ctrl[0]) return;   // the same for every block of the launch
  __shared__ T sh[NT];
  const int i0 = blockIdx.x * BX + threadIdx.x;
  const int j0 = blockIdx.y * BY + threadIdx.y;
  T acc = T(0);
  if (i0 < nx && j0 < ny) {
    const int nxp = nx + 2 * olx;
    const size_t plane = static_cast<size_t>(ny + 2 * oly) * nxp;
    const size_t p0 = static_cast<size_t>(j0 + oly) * nxp + i0 + olx;
    T qkm1 = T(0);
    for (int k = 0; k < nr; ++k) {   // forward substitution
      const size_t p = p0 + k * plane;
      const T qk = zMC[p] * (r[p] - zML[p] * qkm1);
      q[p] = qk;
      qkm1 = qk;
    }
    T qkp1 = T(0);
    for (int k = nr - 1; k >= 0; --k) {   // back substitution, dot(q, r)
      const size_t p = p0 + k * plane;
      const T qk = q[p] - zMU[p] * qkp1;
      q[p] = qk;
      qkp1 = qk;
      acc = acc + qk * r[p] * maskC[p];
    }
  }
  grid_sum(acc, sh, partials, counter, dot_out);
}

template <typename T>
__global__ void cg3d_s_stencil_dot_kernel(
    const T* __restrict__ aW, const T* __restrict__ aS,
    const T* __restrict__ aV, const T* __restrict__ aC,
    const T* __restrict__ maskC, const T* __restrict__ q,
    const T* __restrict__ s_in, T* __restrict__ s_out, T* __restrict__ qa,
    const T* eta_n, const T* eta_nm1, T* dot_out, T* partials,
    unsigned int* counter, const int* ctrl, int nr, int ny, int nx, int oly,
    int olx) {
  if (ctrl[0]) return;
  __shared__ T sh[NT];
  const int i0 = blockIdx.x * BX + threadIdx.x;
  const int j0 = blockIdx.y * BY + threadIdx.y;
  T acc = T(0);
  if (i0 < nx && j0 < ny) {
    const int nxp = nx + 2 * olx;
    const int i = i0 + olx, j = j0 + oly;
    const size_t plane = static_cast<size_t>(ny + 2 * oly) * nxp;
    const size_t row = static_cast<size_t>(j) * nxp;
    const size_t pc = row + i;
    const size_t pw = row + wrap(i - 1, olx, nx);
    const size_t pe = row + wrap(i + 1, olx, nx);
    const size_t ps = static_cast<size_t>(wrap(j - 1, oly, ny)) * nxp + i;
    const size_t pn = static_cast<size_t>(wrap(j + 1, oly, ny)) * nxp + i;
    const T beta = *eta_n / *eta_nm1;
    // s' of a cell, as the thread that owns it computes it
    auto snew = [&](size_t p) { return (q[p] + beta * s_in[p]) * maskC[p]; };
    T s_up = T(0);
    T s_c = snew(pc);
    for (int k = 0; k < nr; ++k) {
      const size_t off = k * plane;
      const size_t p = pc + off;
      const bool deep = (k + 1 == nr);
      const T s_dn = deep ? T(0) : snew(p + plane);
      const T aVdn = deep ? T(0) : aV[p + plane];
      const T v = aW[p] * snew(pw + off) + aW[p + 1] * snew(pe + off) +
                  aS[p] * snew(ps + off) + aS[p + nxp] * snew(pn + off) +
                  aV[p] * s_up + aVdn * s_dn + aC[p] * s_c;
      const T m = maskC[p];
      const T qk = v * m;
      s_out[p] = s_c;
      qa[p] = qk;
      acc = acc + s_c * qk * m;
      s_up = s_c;
      s_c = s_dn;
    }
  }
  grid_sum(acc, sh, partials, counter, dot_out);
}

template <typename T>
__global__ void cg3d_xr_update_kernel(
    T* __restrict__ x, T* __restrict__ r, const T* __restrict__ s,
    const T* __restrict__ q, const T* num, const T* den,
    const T* __restrict__ maskC, T* dot_out, T* partials,
    unsigned int* counter, int* ctrl, const T* tol_sq, int nr, int ny,
    int nx, int oly, int olx, int max_iters, int count_iter) {
  if (ctrl[0]) return;
  __shared__ T sh[NT];
  const int i0 = blockIdx.x * BX + threadIdx.x;
  const int j0 = blockIdx.y * BY + threadIdx.y;
  T acc = T(0);
  if (i0 < nx && j0 < ny) {
    const int nxp = nx + 2 * olx;
    const size_t plane = static_cast<size_t>(ny + 2 * oly) * nxp;
    const size_t p0 = static_cast<size_t>(j0 + oly) * nxp + i0 + olx;
    const T alpha = *num / *den;
    for (int k = 0; k < nr; ++k) {
      const size_t p = p0 + k * plane;
      const T m = maskC[p];
      x[p] = (x[p] + alpha * s[p]) * m;
      const T rn = (r[p] - alpha * q[p]) * m;
      r[p] = rn;
      acc = acc + rn * rn * m;
    }
  }
  if (grid_sum(acc, sh, partials, counter, dot_out)) {
    // every other block has passed its `done` test: stop or go on
    const int it = ctrl[1] + count_iter;
    ctrl[1] = it;
    ctrl[0] = (!(*dot_out >= *tol_sq) || it >= max_iters) ? 1 : 0;
  }
}

}  // namespace mitgcm

using mitgcm::grid2d;
using mitgcm::BX;
using mitgcm::BY;

#define MITGCM_CG3D_ENTRY_POINTS(T, SUF)                                      \
  extern "C" int mitgcm_cg3d_precond_dot_##SUF(                               \
      const void* zMC, const void* zML, const void* zMU, const void* maskC,   \
      const void* r, void* q, void* dot_out, void* partials, void* counter,   \
      const void* ctrl, int nr, int ny, int nx, int oly, int olx,             \
      void* stream) {                                                         \
    mitgcm::cg3d_precond_dot_kernel<T>                                        \
        <<<grid2d(ny, nx), dim3(BX, BY), 0, (cudaStream_t)stream>>>(          \
            (const T*)zMC, (const T*)zML, (const T*)zMU, (const T*)maskC,     \
            (const T*)r, (T*)q, (T*)dot_out, (T*)partials,                    \
            (unsigned int*)counter, (const int*)ctrl, nr, ny, nx, oly, olx);  \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int mitgcm_cg3d_s_stencil_dot_##SUF(                             \
      const void* aW, const void* aS, const void* aV, const void* aC,         \
      const void* maskC, const void* q, const void* s_in, void* s_out,        \
      void* qa, const void* eta_n, const void* eta_nm1, void* dot_out,        \
      void* partials, void* counter, const void* ctrl, int nr, int ny,        \
      int nx, int oly, int olx, void* stream) {                               \
    mitgcm::cg3d_s_stencil_dot_kernel<T>                                      \
        <<<grid2d(ny, nx), dim3(BX, BY), 0, (cudaStream_t)stream>>>(          \
            (const T*)aW, (const T*)aS, (const T*)aV, (const T*)aC,           \
            (const T*)maskC, (const T*)q, (const T*)s_in, (T*)s_out,          \
            (T*)qa, (const T*)eta_n, (const T*)eta_nm1, (T*)dot_out,          \
            (T*)partials, (unsigned int*)counter, (const int*)ctrl, nr, ny,   \
            nx, oly, olx);                                                    \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int mitgcm_cg3d_xr_update_##SUF(                                 \
      void* x, void* r, const void* s, const void* q, const void* num,        \
      const void* den, const void* maskC, void* dot_out, void* partials,      \
      void* counter, void* ctrl, const void* tol_sq, int nr, int ny, int nx,  \
      int oly, int olx, int max_iters, int count_iter, void* stream) {        \
    mitgcm::cg3d_xr_update_kernel<T>                                          \
        <<<grid2d(ny, nx), dim3(BX, BY), 0, (cudaStream_t)stream>>>(          \
            (T*)x, (T*)r, (const T*)s, (const T*)q, (const T*)num,            \
            (const T*)den, (const T*)maskC, (T*)dot_out, (T*)partials,        \
            (unsigned int*)counter, (int*)ctrl, (const T*)tol_sq, nr, ny, nx, \
            oly, olx, max_iters, count_iter);                                 \
    return (int)cudaGetLastError();                                           \
  }

MITGCM_CG3D_ENTRY_POINTS(float, f32)
MITGCM_CG3D_ENTRY_POINTS(double, f64)
