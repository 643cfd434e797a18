// Kernel N2 (cg3d_setup): the set-up of a cg3d solve, and its launches. Included by cg3d_setup.cu, whose entry points start them
// on the card, and by the host check of the tests, which runs them on the
// CPU.
//
// Replaces: the start of mitgcm_tpu/solver/cg3d.py:_cg3d_raw
// (:189-214; cg3d.F:117-147), which XLA fused into a few passes
// over the padded [nr, nyp, nxp] arrays:
//   b = (b * cg3dNorm) * imask3       imask3 = interior mask * maskC
//                                     (built once, on the operator);
//   with the normalisation (cg3dTargetResWunit <= 0):
//     rhsMax = max |b| (NaN if any cell is NaN, as torch.max),
//     rhsNorm = rhsMax != 0 ? 1 / rhsMax : 1, b = b * rhsNorm,
//     x0 = x0 * rhsNorm;
//   x = x0 * imask3, r = b, and the work fields s, s', q, qA zero.
// (The solve's end, x / rhsNorm, is one PyTorch division by the device
// scalar.) Two launches: cg3d_setup_scale forms b with the block maxima of |b|,
// reduced as common.cuh:grid_reduce reduces (max in place of the sum,
// exact in any order), and its last block writes rhsMax and rhsNorm to the
// device (the host reads neither); cg3d_setup_fill writes r = b * rhsNorm
// in place, x and the four zero fields.
//
// Bound: bytes. scale reads b and imask3 and writes r (12 B/cell in
// float32), fill reads r, x0 and imask3 and writes r, x and the four work
// fields (36 B/cell).
// Design: scale walks columns (a 2-D grid of 32 x 8 threads, the block
// tree of grid_reduce); fill, which reads no neighbour, takes one thread
// a cell in memory order (flat 1-D blocks; a grid with the level as the
// fastest block index ran it at 0.57 of its bound). Each product keeps
// the twin's order (solver/cg3d.py:_setup_plain), so with --fmad=false
// every field is bit-equal to the twin's.
#pragma once

#include "common.cuh"

namespace mitgcm {

// torch.max: NaN where either is NaN, else the larger
struct MaxNan {
  template <typename T>
  __device__ T operator()(T a, T b) const { return max_nan(a, b); }
};

template <typename T>
struct Cg3dSetupArgs {
  // [nr, nyp, nxp]: the right-hand side, the first guess, the mask
  const T *b, *x0, *imask3;
  // 0-d: cg3dNorm
  const T* norm;
  // outputs [nr, nyp, nxp]: r (b, scaled), x, s, s', q, qA
  T *r, *x, *s0, *s1, *q, *qa;
  // scratch: the block maxima, the last-block counter (0 between
  // launches); output: rhsMax, rhsNorm
  T* partials;
  unsigned int* counter;
  T* scal;
};
constexpr int kCg3dSetupNumPointers = 13;

template <typename T>
__global__ void __launch_bounds__(NT) cg3d_setup_scale_kernel(
    Cg3dSetupArgs<T> a, int nr, int nyp, int nxp, int normalise) {
  __shared__ T sh[NT];
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  T mx = T(0);
  if (i < nxp && j < nyp) {
    const size_t P = static_cast<size_t>(nyp) * nxp;
    const size_t q = static_cast<size_t>(j) * nxp + i;
    const T norm = *a.norm;
    for (int k = 0; k < nr; ++k) {
      const size_t p = k * P + q;
      const T bn = (a.b[p] * norm) * a.imask3[p];
      a.r[p] = bn;
      mx = max_nan(mx, fabs(bn));
    }
  }
  if (!normalise) return;
  const T v[1] = {mx};
  if (grid_reduce(v, MaxNan(), sh, a.partials, a.counter, a.scal)) {
    const T rhsMax = a.scal[0];
    a.scal[1] = rhsMax != T(0) ? T(1) / rhsMax : T(1);
  }
}

// one thread a cell of n, in memory order
inline dim3 flat_grid(size_t n) {
  return dim3(static_cast<unsigned>((n + NT - 1) / NT));
}

__device__ __forceinline__ size_t flat_index() {
  return static_cast<size_t>(blockIdx.x) * NT + threadIdx.x;
}

template <typename T>
__global__ void __launch_bounds__(NT) cg3d_setup_fill_kernel(
    Cg3dSetupArgs<T> a, size_t n, int normalise) {
  const size_t p = flat_index();
  if (p >= n) return;
  const T m = a.imask3[p];
  if (normalise) {
    const T rhsNorm = a.scal[1];
    a.r[p] = a.r[p] * rhsNorm;
    a.x[p] = (a.x0[p] * rhsNorm) * m;
  } else {
    a.x[p] = a.x0[p] * m;
  }
  a.s0[p] = T(0);
  a.s1[p] = T(0);
  a.q[p] = T(0);
  a.qa[p] = T(0);
}

// The set-up's table as the struct; false if it is not one the launch
// takes (the maxima, counter and scal may be null without the
// normalisation).
template <typename T>
bool cg3d_setup_args(const void* const* table, int n, int nr, int nyp,
                     int nxp, int normalise, Cg3dSetupArgs<T>* a) {
  static_assert(sizeof(Cg3dSetupArgs<T>) ==
                    kCg3dSetupNumPointers * sizeof(void*),
                "Cg3dSetupArgs must be a plain table of pointers");
  if (!unpack(a, table, n, kCg3dSetupNumPointers) || nr < 1 || nyp < 1 ||
      nxp < 1)
    return false;
  for (int t = 0; t < kCg3dSetupNumPointers; ++t)
    if (!table[t] && (normalise || t < 10)) return false;
  return true;
}

// Start the set-up's first launch (scale) or its second (fill) with
// start(kernel, grid, block, args...) (OnStream on the card); partials
// holds one value a block of grid2d(nyp, nxp).
template <typename T, typename Start>
int launch_cg3d_setup_scale(const void* const* table, int n, int nr, int nyp,
                            int nxp, int normalise, Start start) {
  Cg3dSetupArgs<T> a;
  if (!cg3d_setup_args(table, n, nr, nyp, nxp, normalise, &a))
    return (int)cudaErrorInvalidValue;
  start(cg3d_setup_scale_kernel<T>, grid2d(nyp, nxp), dim3(BX, BY), a, nr,
        nyp, nxp, normalise);
  return (int)cudaGetLastError();
}

template <typename T, typename Start>
int launch_cg3d_setup_fill(const void* const* table, int n, int nr, int nyp,
                           int nxp, int normalise, Start start) {
  Cg3dSetupArgs<T> a;
  if (!cg3d_setup_args(table, n, nr, nyp, nxp, normalise, &a))
    return (int)cudaErrorInvalidValue;
  const size_t n3 = static_cast<size_t>(nr) * nyp * nxp;
  start(cg3d_setup_fill_kernel<T>, flat_grid(n3), dim3(NT), a, n3,
        normalise);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
