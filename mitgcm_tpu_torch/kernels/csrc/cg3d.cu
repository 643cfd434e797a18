// Kernel H-cg3d: one preconditioned-CG iteration of the 3-D
// non-hydrostatic pressure solve.
//
// Replaces: mitgcm_tpu/solver/cg3d.py:_cg3d_raw, the while_loop body
// (:221-236) with _apply_A (:131, the 7-point operator), _apply_P (:141,
// the column tridiagonal preconditioner, LU-factored by build_cg3d) and
// the interior- and maskC-masked dot products. XLA fused that body into a
// few passes on the TPU; here it is two launches per iteration:
//   cg3d_s_stencil_dot  s' = (q + beta s) imask, beta = eta_n / eta_nm1;
//                       qA = (A s') imask, dot(s', qA)
//   cg3d_xr_precond     x += alpha s', r -= alpha qA, dot(r, r), alpha =
//                       eta_n / dot(s', qA); the stopping test; then the
//                       next iteration's q = P^-1 r and eta = dot(q, r)
// P's column solve runs in the second pass as soon as a column's new r is
// known: no grid-wide value lies between the two (alpha is known before
// the pass starts, and eta is first read by the next pass A). The q and
// eta of an iteration that stops are computed and never read.
//
// Bound: bytes. Pass A reads the four operator arrays, maskC, q and s and
// writes s' and qA (9 field passes); pass B reads x, r, s', qA, maskC and
// P's three arrays and writes x, r and q (11): 20 a iteration, for ~50
// flops a cell, far below the card's ~20 flops a byte.
// Design: column-walking tiles of one thread a column, 32 x 8 columns a
// block (cg3d_tile.cuh, a header of its own for the tests' host check).
//  - s is double-buffered: pass A reads s from one buffer and writes s' to
//    the other, because its neighbours' s' are formed by other blocks in
//    the same launch. A block forms each level's s' once for its tile and
//    ring, in shared memory; the halo wrap of s' (and of nothing else:
//    every other read is column-local or of the operator's filled halo) is
//    folded into the ring's indexing (common.cuh:wrap), so no halo is
//    filled inside the loop.
//  - Pass B keeps a column's forward values and new r in shared memory
//    between its two sweeps, so q is written once.
//  - The dot products are column sums in a fixed level order (k
//    descending for P's, during the back substitution; ascending for the
//    others) followed by common.cuh:grid_reduce's fixed 2-D tree, so the
//    plain twin (solver/cg3d.py) reproduces them bit for bit and every run
//    takes the same number of iterations.
//  - The loop stays on the device: the last block of cg3d_xr_precond
//    counts the iteration and sets a `done` word (ctrl[0]) when dot(r, r)
//    < tol^2 or the count reaches cg3dMaxIters, and every launch returns at
//    once while `done` is set. The host enqueues iterations in batches and
//    reads `done` once per batch; the result and the count are those of
//    stopping at once.
//
// The arithmetic order of each expression is that of the JAX code, so
// (built with --fmad=false) each stored field is bit-equal to the twin.

#include "cg3d_tile.cuh"

#define MITGCM_CG3D_ENTRY_POINTS(T, SUF)                                      \
  extern "C" int mitgcm_cg3d_s_stencil_dot_##SUF(                             \
      const void* aW, const void* aS, const void* aV, const void* aC,         \
      const void* maskC, const void* q, const void* s_in, void* s_out,        \
      void* qa, const void* eta_n, const void* eta_nm1, void* dot_out,        \
      void* partials, void* counter, const void* ctrl, int nr, int ny,        \
      int nx, int oly, int olx, void* stream) {                               \
    const mitgcm::SStencilArgs<T> a{                                          \
        (const T*)aW,    (const T*)aS,      (const T*)aV,                     \
        (const T*)aC,    (const T*)maskC,   (const T*)q,                      \
        (const T*)s_in,  (T*)s_out,         (T*)qa,                           \
        (const T*)eta_n, (const T*)eta_nm1, (T*)dot_out,                      \
        (T*)partials,    (unsigned int*)counter, (const int*)ctrl};           \
    return mitgcm::launch_s_stencil_dot<T>(                                   \
        a, nr, ny, nx, oly, olx, mitgcm::OnStream{(cudaStream_t)stream});     \
  }                                                                           \
  extern "C" int mitgcm_cg3d_xr_precond_##SUF(                                \
      void* x, void* r, const void* s, const void* qa, const void* maskC,     \
      const void* zMC, const void* zML, const void* zMU, void* q,             \
      const void* num, const void* den, void* err_out, void* eta_out,         \
      void* partials, void* counter, void* pair, void* ctrl,                  \
      const void* tol_sq, int nr, int ny, int nx, int oly, int olx,           \
      int max_iters, int count_iter, void* stream) {                          \
    const mitgcm::XrPrecondArgs<T> a{                                         \
        (T*)x,         (T*)r,         (const T*)s,   (const T*)qa,            \
        (const T*)maskC, (const T*)zMC, (const T*)zML, (const T*)zMU,         \
        (T*)q,         (const T*)num, (const T*)den, (T*)err_out,             \
        (T*)eta_out,   (T*)partials,  (unsigned int*)counter, (T*)pair,       \
        (int*)ctrl,    (const T*)tol_sq};                                     \
    return mitgcm::launch_xr_precond<T>(                                      \
        a, nr, ny, nx, oly, olx, max_iters, count_iter,                       \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }

MITGCM_CG3D_ENTRY_POINTS(float, f32)
MITGCM_CG3D_ENTRY_POINTS(double, f64)
