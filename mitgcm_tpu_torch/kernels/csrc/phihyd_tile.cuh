// Kernel D's kernel: a column-walking tile (tile.cuh) that scans each
// column once, and its launch. Included by phihyd.cu, whose entry point
// starts it on the card, and by the host check of the tests, which runs it
// on the CPU.
//
// A block owns a tile of kTY rows of kTX threads, each thread V
// neighbouring columns of a row (V = 16 bytes of T: a warp moves 512
// contiguous bytes of a row), and walks k from the surface down, with the
// V running sums in registers. The tiles cover the padded array: D writes
// every padded cell. The tile's west neighbour column and south neighbour
// row, a one-sided ring without its corner, run with it: threads 0 ..
// kTX - 1 carry V columns of the south row each and the next kTY threads
// one cell of the west column each, so a column's sum is formed about 1.26
// times (644 sums for 512 columns; 164 for 128 where V is 1) and its rho
// read as often. Each level's phiC of the tile and the ring is staged in
// shared memory, where dPhiHydX and dPhiHydY take their neighbours; a ring
// column outside the array stages 0 (the shifts' zero fill). Two stages
// alternate with k, so one barrier a level. The levels go in groups of
// kPhiGroup: the next group's rho is loaded before this group's sums. A
// level's weights dRlocM and dRlocM + dRlocP are formed once for the
// block, by thread 0, a level ahead, from drC, rF and rC as the twin forms
// them (0.5 * drC, with the end values). The sum adds in k order, as the
// twin's loop does, so with --fmad=false the outputs are bit-equal to
// model/phihyd.py:_phi_hyd_plain.
// V is 1 where the rows or fields do not allow 16-byte accesses, or where
// 16-byte tiles would be fewer than kPhiMinBlocks (a small grid keeps its
// blocks). At 1024 x 1024 x 32 float32 on an H100 the 16-byte tile is the
// fast one: with one column a thread the walk ran no faster than the
// kernel it replaced, whatever its group of levels, tile height or
// occupancy.
#pragma once

#include "tile.cuh"

namespace mitgcm {

constexpr int kPhiGroup = 4;          // levels loaded together
constexpr int kPhiMinBlocks = 1024;   // for 16-byte columns: 8 an SM

template <typename T>
struct PhiColumn {
  T acc = T(0);
  // phiC of level k from that level's buoyancy, advancing the running sum
  __device__ T next(T b, T wsum, T wM) {
    const T incr = wsum * b;
    acc = acc + incr;
    return (acc - incr) + wM * b;
  }
};

// level k's half-cell weights: {dRlocM, dRlocM + dRlocP}
template <typename T>
__device__ __forceinline__ void phi_weights(const T* drC, const T* rF,
                                            const T* rC, int k, int nr,
                                            T* w) {
  const T wM = k == 0 ? rF[0] - rC[0] : T(0.5) * drC[k];
  const T wP = k == nr - 1 ? rC[nr - 1] - rF[nr] : T(0.5) * drC[k + 1];
  w[0] = wM;
  w[1] = wM + wP;
}

template <typename T, int V>
__global__ void __launch_bounds__(kTileThreads)
    phihyd_kernel(const T* __restrict__ rho, const T* __restrict__ drC,
                  const T* __restrict__ rF, const T* __restrict__ rC,
                  const T* __restrict__ rdxC, const T* __restrict__ rdyC,
                  T* __restrict__ phiC, T* __restrict__ dX,
                  T* __restrict__ dY, int nr, int nyp, int nxp, int ntx,
                  T gravity, T recip_rhoConst) {
  constexpr int W = kTX * V;   // the tile's columns
  // phiC of a level by k parity: [the south ring row, then the tile's
  // rows][the west ring column, then the tile's columns]
  __shared__ T stage[2][kTY + 1][W + 1];
  __shared__ T weights[2][2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * kTX + tx;
  const int j0 = (blockIdx.x / ntx) * kTY, i0 = (blockIdx.x % ntx) * W;
  const int i = i0 + tx * V, j = j0 + ty;
  const bool own = i < nxp && j < nyp;
  // the ring: threads 0 .. kTX - 1 carry V columns of the south row each,
  // the next kTY threads one cell of the west column each
  const bool south = t < kTX, west = t >= kTX && t < kTX + kTY;
  const int si = i0 + t * V, wj = j0 + t - kTX;
  const bool inS = south && j0 > 0 && si < nxp;
  const bool inW = west && i0 > 0 && wj < nyp;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t q = own ? static_cast<size_t>(j) * nxp + i : 0;
  const size_t rq = inS   ? static_cast<size_t>(j0 - 1) * nxp + si
                    : inW ? static_cast<size_t>(wj) * nxp + i0 - 1
                          : 0;
  const Pack<T, V> rdx = own ? load_pack<T, V>(rdxC, q) : Pack<T, V>{};
  const Pack<T, V> rdy = own ? load_pack<T, V>(rdyC, q) : Pack<T, V>{};
  // rho of the levels in flight, the tile's and the ring's (a west cell in
  // x[0]): this group's, then the next group's, loaded while this group
  // is summed
  Pack<T, V> cur[kPhiGroup], next[kPhiGroup], rcur[kPhiGroup],
      rnext[kPhiGroup];
  auto load = [&](int k, Pack<T, V>& o, Pack<T, V>& r) {
    o = own && k < nr ? load_pack<T, V>(rho, k * P + q) : Pack<T, V>{};
    r = Pack<T, V>{};
    if (inS && k < nr) r = load_pack<T, V>(rho, k * P + rq);
    if (inW && k < nr) r.x[0] = rho[k * P + rq];
  };
#pragma unroll
  for (int g = 0; g < kPhiGroup; ++g) load(g, cur[g], rcur[g]);
  if (t == 0) phi_weights(drC, rF, rC, 0, nr, weights[0]);
  __syncthreads();
  PhiColumn<T> col[V], rcol[V];
  for (int kb = 0; kb < nr; kb += kPhiGroup) {
#pragma unroll
    for (int g = 0; g < kPhiGroup; ++g)
      load(kb + kPhiGroup + g, next[g], rnext[g]);
#pragma unroll
    for (int g = 0; g < kPhiGroup; ++g) {
      const int k = kb + g;
      if (k >= nr) break;
      const int s = k & 1;
      if (t == 0 && k + 1 < nr)
        phi_weights(drC, rF, rC, k + 1, nr, weights[s ^ 1]);
      const T wM = weights[s][0], wsum = weights[s][1];
      T pc[V];
#pragma unroll
      for (int c = 0; c < V; ++c) {
        pc[c] = own ? col[c].next((gravity * cur[g].x[c]) * recip_rhoConst,
                                  wsum, wM)
                    : T(0);
        stage[s][ty + 1][1 + tx * V + c] = pc[c];
      }
      if (south) {
#pragma unroll
        for (int c = 0; c < V; ++c)
          stage[s][0][1 + t * V + c] =
              inS ? rcol[c].next((gravity * rcur[g].x[c]) * recip_rhoConst,
                                 wsum, wM)
                  : T(0);
      }
      if (west)
        stage[s][wj - j0 + 1][0] =
            inW ? rcol[0].next((gravity * rcur[g].x[0]) * recip_rhoConst,
                               wsum, wM)
                : T(0);
      __syncthreads();
      if (own) {
        Pack<T, V> phi, gx, gy;
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const T pw = c == 0 ? stage[s][ty + 1][tx * V] : pc[c - 1];
          phi.x[c] = pc[c];
          gx.x[c] = rdx.x[c] * (pc[c] - pw);
          gy.x[c] = rdy.x[c] * (pc[c] - stage[s][ty][1 + tx * V + c]);
        }
        const size_t p = k * P + q;
        store_pack<T, V>(phiC, p, phi);
        store_pack<T, V>(dX, p, gx);
        store_pack<T, V>(dY, p, gy);
      }
    }
#pragma unroll
    for (int g = 0; g < kPhiGroup; ++g) {
      cur[g] = next[g];
      rcur[g] = rnext[g];
    }
  }
}

// Start phihyd_kernel<T, V> over the padded array's tiles with
// start(kernel, grid, block, args...).
template <typename T, int V, typename Start>
void start_phihyd(const void* rho, const void* drC, const void* rF,
                  const void* rC, const void* rdxC, const void* rdyC,
                  void* phiC, void* dX, void* dY, int nr, int nyp, int nxp,
                  double gravity, double recip_rhoConst, Start start) {
  const int ntx = (nxp + kTX * V - 1) / (kTX * V);
  const int nty = (nyp + kTY - 1) / kTY;
  start(phihyd_kernel<T, V>, dim3(ntx * nty), dim3(kTX, kTY),
        (const T*)rho, (const T*)drC, (const T*)rF, (const T*)rC,
        (const T*)rdxC, (const T*)rdyC, (T*)phiC, (T*)dX, (T*)dY, nr, nyp,
        nxp, ntx, T(gravity), T(recip_rhoConst));
}

// Check the sizes, pick the width V and start the kernel with start(kernel,
// grid, block, args...) (OnStream on the card). min_blocks: kPhiMinBlocks
// on the card (the tests' host check gives 0 for 16-byte columns wherever
// the rows allow them).
template <typename T, typename Start>
int launch_phihyd(const void* rho, const void* drC, const void* rF,
                  const void* rC, const void* rdxC, const void* rdyC,
                  void* phiC, void* dX, void* dY, int nr, int nyp, int nxp,
                  double gravity, double recip_rhoConst, int min_blocks,
                  Start start) {
  if (nr < 1 || nyp < 1 || nxp < 1) return (int)cudaErrorInvalidValue;
  constexpr int kV = 16 / sizeof(T);
  const void* fields[] = {rho, rdxC, rdyC, phiC, dX, dY};
  const long long packed_tiles =
      static_cast<long long>((nxp + kTX * kV - 1) / (kTX * kV)) *
      ((nyp + kTY - 1) / kTY);
  if (rows_of_packs<T>(fields, 6, nxp) && packed_tiles >= min_blocks)
    start_phihyd<T, kV>(rho, drC, rF, rC, rdxC, rdyC, phiC, dX, dY, nr, nyp,
                        nxp, gravity, recip_rhoConst, start);
  else
    start_phihyd<T, 1>(rho, drC, rF, rC, rdxC, rdyC, phiC, dX, dY, nr, nyp,
                       nxp, gravity, recip_rhoConst, start);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
