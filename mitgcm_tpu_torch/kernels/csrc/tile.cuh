// Column-walking tiles, shared by kernels B (mom_fluxform_tile.cuh) and C
// (gad_calc_rhs_tile.cuh): a block owns kTX x kTY interior columns, one
// thread per column, i fastest (a row of the tile is one warp), and walks
// the levels from the surface down. Per level it stages the tile and its
// one-cell ring in shared memory; the ring's kRing cells are staged by
// threads 0..kRing-1, each keeping the same ring cell for the whole walk,
// so that what a column carries from one level to the next stays in that
// thread's registers. Blocks past the tiles zero the outputs' halo cells.
#pragma once

#include "common.cuh"

namespace mitgcm {

constexpr int kTX = 32;               // a warp per tile row
constexpr int kTY = 4;
constexpr int kTileThreads = kTX * kTY;
constexpr int kRX = kTX + 2;          // the tile and its ring
constexpr int kRY = kTY + 2;
constexpr int kRegion = kRX * kRY;
constexpr int kRing = 2 * kRX + 2 * kTY;
static_assert(kTX == 32, "a tile row is one warp");
static_assert(kTY >= 4, "the edge tasks take four warps");
static_assert(kRing <= kTileThreads, "one thread per ring cell");

// index of (ry, rx) in a region array: ry, rx count from the ring's
// south-west corner (j0 - 1, i0 - 1)
__device__ __forceinline__ int rg(int ry, int rx) { return ry * kRX + rx; }

// the region coordinates of ring cell r: the south row, the north row, then
// the west and east columns between them
__device__ __forceinline__ void ring_cell(int r, int& ry, int& rx) {
  if (r < kRX) {
    ry = 0;
    rx = r;
  } else if (r < 2 * kRX) {
    ry = kRY - 1;
    rx = r - kRX;
  } else if (r < 2 * kRX + kTY) {
    ry = r - 2 * kRX + 1;
    rx = 0;
  } else {
    ry = r - 2 * kRX - kTY + 1;
    rx = kRX - 1;
  }
}

// The launch: tiles over the ny x nx interior, then halo blocks.
struct TileGrid {
  int ntx, nty, tiles, halo_blocks;
};

inline TileGrid tile_grid(int nr, int ny, int nx, int oly, int olx) {
  TileGrid g;
  g.ntx = (nx + kTX - 1) / kTX;
  g.nty = (ny + kTY - 1) / kTY;
  g.tiles = g.ntx * g.nty;
  const long long halo =
      static_cast<long long>(nr) *
      ((static_cast<long long>(ny) + 2 * oly) * (nx + 2 * olx) -
       static_cast<long long>(ny) * nx);
  const long long blocks = (halo + kTileThreads - 1) / kTileThreads;
  g.halo_blocks = static_cast<int>(blocks < 264 ? blocks : 264);
  return g;
}

// The tile a block owns: its interior origin (j0, i0); false for a halo
// block.
__device__ __forceinline__ bool tile_origin(int ntx, int tiles, int oly,
                                            int olx, int& j0, int& i0) {
  const int b = blockIdx.x;
  if (b >= tiles) return false;
  j0 = oly + (b / ntx) * kTY;
  i0 = olx + (b % ntx) * kTX;
  return true;
}

// Zero the halo cells of the N outputs at every level: a halo block's
// share of a grid-stride loop over them (the south rows, the north rows,
// then the west and east columns of the interior rows).
template <typename T, int N>
__device__ void zero_halo(T* const (&outs)[N], int nr, int ny, int nx,
                          int oly, int olx, int halo_block, int halo_blocks) {
  const int nyp = ny + 2 * oly, nxp = nx + 2 * olx;
  const long long per = static_cast<long long>(nyp) * nxp -
                        static_cast<long long>(ny) * nx;
  const long long band = static_cast<long long>(oly) * nxp;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  for (long long f = static_cast<long long>(halo_block) * kTileThreads + t;
       f < per * nr; f += static_cast<long long>(halo_blocks) * kTileThreads) {
    const int k = static_cast<int>(f / per);
    long long g = f - k * per;
    int j, i;
    if (g < band) {
      j = static_cast<int>(g / nxp);
      i = static_cast<int>(g % nxp);
    } else if (g < 2 * band) {
      g -= band;
      j = oly + ny + static_cast<int>(g / nxp);
      i = static_cast<int>(g % nxp);
    } else {
      g -= 2 * band;
      j = oly + static_cast<int>(g / (2 * olx));
      const int c = static_cast<int>(g % (2 * olx));
      i = c < olx ? c : nx + c;
    }
    const size_t p = (static_cast<size_t>(k) * nyp + j) * nxp + i;
    for (int n = 0; n < N; ++n) outs[n][p] = T(0);
  }
}

#ifdef __CUDACC__
// Starts a tile kernel on a stream: the `start` that the entry points give
// launch_mom and launch_calc_rhs (the tests' host check gives its own).
struct OnStream {
  cudaStream_t stream;
  template <typename Kernel, typename... Args>
  void operator()(Kernel kernel, dim3 grid, dim3 block, Args... args) const {
    kernel<<<grid, block, 0, stream>>>(args...);
  }
};
#endif

}  // namespace mitgcm
