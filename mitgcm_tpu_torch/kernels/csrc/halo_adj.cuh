// Kernel F' (halo_fold): the transpose of kernel F's halo wrap, and its
// launch. Included by halo_adj.cu, whose entry point starts it on the card,
// and by the host check of the tests, which runs it on the CPU.
//
// Replaces the VJP that jax.grad took of mitgcm_tpu/ops/stencil.py:
// cyclic_fill_halo (:54-69), a modular gather that XLA transposed into a
// scatter-add: every padded cell's cotangent is added onto the interior
// cell it was read from, ((j - oly) mod ny, (i - olx) mod nx), and the
// input's halo cells get 0 (they are not read). The port's plain version,
// ops/stencil.py:_fold, adds the cotangents in a fixed order with no
// scatter: the padded axis is cut into blocks of n cells after `lead`
// zeros (lead = ceil(ol / n) * n - ol, so that padded index p lands on
// (p - ol) mod n) and the blocks are summed in index order, first along x
// for every padded row, then along y; a halo wider than the interior
// simply spans more blocks.
//
// Bound: bytes. It reads every padded cell of the cotangent once and
// writes every padded cell of the result once (8 B/cell in float32); a few
// additions a cell.
// Design: gather form, one thread a padded cell (i fastest) of
// kFoldPlanes planes (the z block index; one on a 2-D field), their loads
// issued before any store: a cell a thread left too few bytes in flight
// to reach the card's rate (0.42 of the bound at 1024 x 1024 x 32
// float32, 0.65 with 4 planes a thread). An
// interior cell sums its blocks' cells in _fold's order, each block's
// absent cell a 0 as F.pad's zero, so the result is _fold's bit for bit;
// a halo cell writes 0. No atomics: two runs give the same bits.
#pragma once

#include "common.cuh"

namespace mitgcm {

// _fold's blocks along one padded axis of length n + 2 ol: the zeros in
// front and the number of blocks of n
struct FoldAxis {
  int n, ol, lead, blocks;
};

__host__ __device__ inline FoldAxis fold_axis(int n, int ol) {
  FoldAxis a;
  a.n = n;
  a.ol = ol;
  a.lead = (ol + n - 1) / n * n - ol;
  const int len = a.lead + n + 2 * ol;
  a.blocks = (len + n - 1) / n;
  return a;
}

constexpr int kFoldPlanes = 4;   // planes a thread, their loads first

template <typename T, int K>
__global__ void halo_fold_kernel(const T* __restrict__ g, T* __restrict__ out,
                                 int planes, FoldAxis ax, FoldAxis ay) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int nxp = ax.n + 2 * ax.ol, nyp = ay.n + 2 * ay.ol;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t q = static_cast<size_t>(j) * nxp + i;
  const int p0 = blockIdx.z * K;
  const int ii = i - ax.ol, jj = j - ay.ol;
  T acc[K];
#pragma unroll
  for (int u = 0; u < K; ++u) acc[u] = T(0);
  if (ii >= 0 && ii < ax.n && jj >= 0 && jj < ay.n) {
    // _fold's sums, the blocks in index order, the planes' loads together
    for (int by = 0; by < ay.blocks; ++by) {
      const int py = by * ay.n + jj - ay.lead;
      T row[K];
#pragma unroll
      for (int u = 0; u < K; ++u) row[u] = T(0);
      if (py >= 0 && py < nyp) {
        for (int bx = 0; bx < ax.blocks; ++bx) {
          const int px = bx * ax.n + ii - ax.lead;
          const bool in = px >= 0 && px < nxp;
          const size_t c = static_cast<size_t>(py) * nxp + (in ? px : 0);
#pragma unroll
          for (int u = 0; u < K; ++u) {
            const T v = in && p0 + u < planes ? g[(p0 + u) * P + c] : T(0);
            row[u] = bx == 0 ? v : row[u] + v;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < K; ++u)
        acc[u] = by == 0 ? row[u] : acc[u] + row[u];
    }
  }
#pragma unroll
  for (int u = 0; u < K; ++u)
    if (p0 + u < planes) out[(p0 + u) * P + q] = acc[u];
}

template <typename T, typename Start>
int launch_halo_fold(const void* g, void* out, int planes, int ny, int nx,
                     int oly, int olx, Start start) {
  // a 2-D field's one plane a thread: the unrolled planes' guards cost a
  // plane as much again
  const int k = planes >= kFoldPlanes ? kFoldPlanes : 1;
  const int zs = (planes + k - 1) / k;
  if (!g || !out || planes < 1 || zs > 65535 || ny < 1 || nx < 1 ||
      oly < 0 || olx < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nx + 2 * olx + BX - 1) / BX, (ny + 2 * oly + BY - 1) / BY,
                  static_cast<unsigned>(zs));
  if (k == 1)
    start(halo_fold_kernel<T, 1>, grid, dim3(BX, BY), (const T*)g, (T*)out,
          planes, fold_axis(nx, olx), fold_axis(ny, oly));
  else
    start(halo_fold_kernel<T, kFoldPlanes>, grid, dim3(BX, BY), (const T*)g,
          (T*)out, planes, fold_axis(nx, olx), fold_axis(ny, oly));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
