// Shared helpers for the port's kernels: launch shape, halo wrap and a
// deterministic two-stage sum.
#pragma once

#include <cuda_runtime.h>

namespace mitgcm {

// 2-D blocks of 32 x 8 threads: i (x) fastest, so a warp reads 32
// neighbouring doubles or floats of one row.
constexpr int BX = 32;
constexpr int BY = 8;
constexpr int NT = BX * BY;

inline dim3 grid2d(int ny, int nx) {
  return dim3((nx + BX - 1) / BX, (ny + BY - 1) / BY, 1);
}

// Padded index p of an interior cell's neighbour, wrapped back into the
// interior [ol, ol+n): exactly what the single-device cyclic halo fill
// (ops/stencil.py:cyclic_fill_halo) would have stored at p.
__device__ __forceinline__ int wrap(int p, int ol, int n) {
  int q = (p - ol) % n;
  return (q < 0 ? q + n : q) + ol;
}

// Sum v over all threads of all blocks of a 2-D grid into *out, in a fixed
// order: a shared-memory tree inside each block, one partial per block, and
// the last block to finish adds the partials (strided, then a tree) in
// index order. The result is the same from run to run. `counter` must be 0
// before the launch; the last block resets it. Returns true in thread 0 of
// the last block, after *out is written (a caller may act on the sum
// there), false elsewhere.
template <typename T>
__device__ bool grid_sum(T v, T* sh, T* partials, unsigned int* counter,
                         T* out) {
  __shared__ bool last;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const int nb = gridDim.x * gridDim.y;
  sh[t] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] += sh[t + s];
    __syncthreads();
  }
  if (t == 0) {
    partials[blockIdx.y * gridDim.x + blockIdx.x] = sh[0];
    __threadfence();
    last = (atomicAdd(counter, 1u) == static_cast<unsigned int>(nb - 1));
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  const volatile T* vp = partials;
  T acc = T(0);
  for (int b = t; b < nb; b += NT) acc += vp[b];
  sh[t] = acc;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] += sh[t + s];
    __syncthreads();
  }
  if (t == 0) {
    *out = sh[0];
    *counter = 0u;
    return true;
  }
  return false;
}

}  // namespace mitgcm
