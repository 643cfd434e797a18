// Kernel A: the whole 2-D free-surface solve, one persistent cooperative
// launch per solve.
//
// Replaces: mitgcm_tpu/solver/cg2d.py:_cg2d_raw (:203-275), which XLA ran
// as one while_loop on the TPU: r0 = b - A x0, the loop body (:250-267)
// with _apply_P (:124), _apply_A (:118) and the interior-masked dot
// products (:221-226), the stop test err >= tol_sq and it < cg2dMaxIters
// (:246-248) and the min-residual selection (:262-276).
//
// Bound: an iteration moves the fields of its two phases (about 17 padded
// 2-D fields, 72 MB at 1024x1024 in float32) and does ~30 flops a cell, so
// each phase is bound by bytes; the working set (x, r, s, z, q, x_min and
// the six coefficient fields, ~60 MB) is a little more than the 50 MB L2.
// What held the solve back before was not the card but the host: four
// launches and one host read of the residual an iteration. So the loop
// runs on the device, in one cooperative launch (all blocks co-resident):
// as many 32 x 8 blocks as the card holds at once, each walking the fixed
// 32 x 8 tiles of the interior (tile += gridDim.x), and a grid-wide
// barrier between phases. Two phases an iteration:
//   phase 1  x += alpha s, r = r - alpha q (written to the other r
//            buffer), z = P r, with dot(r, r) and dot(z, r) in one
//            two-component reduction; x_min = x (the value read) where
//            the last residual was the smallest so far;
//   phase 2  s = z + beta s (written to the other s buffer), q = A s, with
//            dot(s, q).
// A stencil reads its neighbours' new r or s, which other blocks write in
// the same phase; it recomputes them from the previous buffers instead
// (the same expression, so the same bits), which is why r and s are
// double-buffered and z is apart from q. A tile's loads are all issued
// before its stores; the six operator fields, constant through the launch,
// go through the read-only cache. The last block to reach a barrier
// combines the tiles' partial sums and releases the others, so every block
// sees the same sums and takes the same branch: the stop test, the
// iteration count and the min-residual selection live on the device, and
// the host reads the iteration count once, after the launch.
//
// Order: each dot product is common.cuh:grid_reduce's sum, bit for bit:
// per 32 x 8 tile its shared-memory tree (here the first three levels from
// shared memory by warp 0, then a shuffle tree), one partial per tile by
// tile index, and the partials strided over 256 lanes, then the same tree.
// It does not depend on the grid size the occupancy query returns. Every
// other expression keeps the JAX code's operation order, so (built with
// --fmad=false) the solve is bit-equal to the plain host loop of
// solver/cg2d.py, iterations included. The halo wrap of r and s is folded
// into the neighbour indexing; only interior cells are written.
//
// Kernel A-exact (cg2d_solve_exact, template flag Exact; cg2dExactSums on
// one face; replaces mitgcm_tpu/solver/cg2d.py:_dot_seq_fortran, :137-166)
// keeps MITgcm's order instead: each dot's products go to a scratch plane
// of their own (r and s are double-buffered, so no plane of theirs is
// free); after a grid barrier one block a sNy x sNx tile adds its tile's
// products serially, i fastest and j outer, from a zero (ordered_sum:
// thread 0 adds while the block stages the next chunk in shared memory);
// after a second barrier the last block adds the tiles' partials serially,
// bj outer and bi inner, from a zero. Phase 1's two dots share the
// barriers. Everything else is A's.

#include <type_traits>

#include "common.cuh"

namespace mitgcm {

static_assert(BX == 32 && BY == 8, "tile_sum unrolls the 32 x 8 tree");

template <typename T>
struct Cg2dArgs {
  const T* aW;
  const T* aS;
  const T* aC;
  const T* pW;
  const T* pS;
  const T* pC;
  const T* b;         // the normalised right-hand side
  const T* tol_sq;    // 0-d
  T* x;               // first guess in, solution out (interior cells)
  T* work;            // r[2], s[2], z, q, x_min (A-exact: and the two
                      // product planes): padded fields in a row
  T* partials;        // two per tile (A-exact: per sny x snx tile)
  T* scalars;         // [0, 2) a barrier's sums; [2] first and [3] last
                      // squared residual
  unsigned int* ctrl; // [0] arrivals (0 between launches), [1] barriers
                      // completed, [2] iterations
  int ny, nx, oly, olx, max_iters, use_min;
};

// A-exact's arguments: A's, and MITgcm's tiles (sny x snx). A keeps its
// own struct: with the two ints in it A's code came out 15 % slower an
// iteration at 1024 x 1024 on an H100.
template <typename T>
struct Cg2dExactArgs : Cg2dArgs<T> {
  int sny, snx;
};

template <typename T, bool Exact>
using Cg2dKernelArgs =
    std::conditional_t<Exact, Cg2dExactArgs<T>, Cg2dArgs<T>>;

// A-exact's serial sums: a chunk of kSeqU values a thread staged in shared
// memory at a time, two chunks in flight
constexpr int kSeqU = 2;
constexpr int kSeqChunk = kSeqU * NT;

// The K ordered sums out[c] = (((0 + v(0, c)) + v(1, c)) + ...) + v(n - 1,
// c), valid in thread 0: the block's threads stage the values in shared
// memory (buf: 2 K kSeqChunk values), one chunk while thread 0 adds the
// last one. Every thread of the block must call it.
template <typename T, int K, typename At>
__device__ __forceinline__ void ordered_sum(int n, At at, T* buf,
                                            T (&out)[K]) {
  const int t = threadIdx.y * BX + threadIdx.x;
  T reg[K][kSeqU];
  auto load = [&](int base) {
#pragma unroll
    for (int u = 0; u < kSeqU; ++u) {
      const int m = base + u * NT + t;
#pragma unroll
      for (int c = 0; c < K; ++c) reg[c][u] = m < n ? at(m, c) : T(0);
    }
  };
  auto store = [&](int half) {
#pragma unroll
    for (int c = 0; c < K; ++c)
#pragma unroll
      for (int u = 0; u < kSeqU; ++u)
        buf[(half * K + c) * kSeqChunk + u * NT + t] = reg[c][u];
  };
#pragma unroll
  for (int c = 0; c < K; ++c) out[c] = T(0);
  load(0);
  store(0);
  __syncthreads();
  int half = 0;
  for (int base = 0; base < n; base += kSeqChunk, half ^= 1) {
    const bool more = base + kSeqChunk < n;
    if (more) load(base + kSeqChunk);
    if (t == 0) {
      const int cnt = n - base < kSeqChunk ? n - base : kSeqChunk;
      const T* v = buf + half * K * kSeqChunk;
#pragma unroll 16
      for (int m = 0; m < cnt; ++m)
#pragma unroll
        for (int c = 0; c < K; ++c) out[c] = out[c] + v[c * kSeqChunk + m];
    }
    if (more) store(half ^ 1);
    __syncthreads();
  }
}

// One thread's cell of an interior tile and its four neighbours' padded
// indices, wrapped back into the interior.
struct Cell {
  bool in;
  size_t p, w, e, s, n;
};

__device__ __forceinline__ Cell cell_of(int tile, int ntx, int ny, int nx,
                                        int oly, int olx) {
  Cell c;
  const int i0 = (tile % ntx) * BX + threadIdx.x;
  const int j0 = (tile / ntx) * BY + threadIdx.y;
  c.in = i0 < nx && j0 < ny;
  const int nxp = nx + 2 * olx;
  const int i = i0 + olx, j = j0 + oly;
  const int iw = i0 == 0 ? i - 1 + nx : i - 1;
  const int ie = i0 == nx - 1 ? i + 1 - nx : i + 1;
  const int js = j0 == 0 ? j - 1 + ny : j - 1;
  const int jn = j0 == ny - 1 ? j + 1 - ny : j + 1;
  const size_t row = static_cast<size_t>(j) * nxp;
  c.p = row + i;
  c.w = row + iw;
  c.e = row + ie;
  c.s = static_cast<size_t>(js) * nxp + i;
  c.n = static_cast<size_t>(jn) * nxp + i;
  return c;
}

// The five coefficients of a 5-point stencil at a cell (west, east,
// south, north, centre), through the read-only cache.
template <typename T>
struct Coeffs {
  T w, e, s, n, c;
};

template <typename T>
__device__ __forceinline__ Coeffs<T> coeffs(const T* cW, const T* cS,
                                            const T* cC, size_t p, int nxp) {
  return {__ldg(cW + p), __ldg(cW + p + 1), __ldg(cS + p),
          __ldg(cS + p + nxp), __ldg(cC + p)};
}

// The K sums of one tile's values into out[0, K) (thread 0 writes), in
// grid_reduce's in-block order: the tree sh[t] = sh[t] + sh[t + s] for
// s = 128 ... 1 is, for lane l of warp 0 and v_w = sh[32 w + l],
// ((v0 + v4) + (v2 + v6)) + ((v1 + v5) + (v3 + v7)), then s = 16 ... 1
// within the warp. sh holds K * NT values; the caller alternates two such
// buffers between tiles, so one __syncthreads a tile suffices.
template <typename T, int K>
__device__ __forceinline__ void tile_sum(const T (&v)[K], T* sh, T* out) {
  const int t = threadIdx.y * BX + threadIdx.x;
#pragma unroll
  for (int c = 0; c < K; ++c) sh[c * NT + t] = v[c];
  __syncthreads();
  if (threadIdx.y == 0) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const T* a = sh + c * NT + threadIdx.x;
      T u = ((a[0] + a[128]) + (a[64] + a[192]))
            + ((a[32] + a[160]) + (a[96] + a[224]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        u = u + __shfl_down_sync(0xffffffffu, u, o);
      if (threadIdx.x == 0) out[c] = u;
    }
  }
}

// Grid-wide barrier of a cooperative launch, with the reduction of the
// tiles' K partials (K = 0: the barrier alone). Each block's thread 0
// publishes the block's writes and counts its arrival; the last block to
// arrive sums the partials (lane l: tiles l, l + 256, ... in order, then
// tile_sum's tree; Seq: serially in tile order, ordered_sum into the
// shared buffer sh) into scalars[0, K), resets the count and releases the
// others, which wait for the barrier count to pass `gen`. Every thread
// returns the K sums in v.
template <typename T, int K, bool Seq = false>
__device__ __forceinline__ void barrier_sum(const Cg2dArgs<T>& a, int ntiles,
                                            T* sh, unsigned int& gen,
                                            T (&v)[K > 0 ? K : 1]) {
  __shared__ bool last;
  const int t = threadIdx.y * BX + threadIdx.x;
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(&a.ctrl[0], 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (last) {
    if constexpr (K > 0 && Seq) {
      T acc[K];
      ordered_sum<T, K>(
          ntiles, [&](int m, int c) { return __ldcg(a.partials + K * m + c); },
          sh, acc);
      if (t == 0)
#pragma unroll
        for (int c = 0; c < K; ++c) a.scalars[c] = acc[c];
    } else if constexpr (K > 0) {
      T acc[K];
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] = T(0);
      int b = t;
      for (; b + 3 * NT < ntiles; b += 4 * NT) {
        T u[4][K];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int c = 0; c < K; ++c)
            u[m][c] = __ldcg(a.partials + K * (b + m * NT) + c);
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int c = 0; c < K; ++c) acc[c] = acc[c] + u[m][c];
      }
      for (; b < ntiles; b += NT)
#pragma unroll
        for (int c = 0; c < K; ++c)
          acc[c] = acc[c] + __ldcg(a.partials + K * b + c);
      tile_sum<T, K>(acc, sh, a.scalars);
    }
    if (t == 0) {
      a.ctrl[0] = 0u;
      __threadfence();
      atomicAdd(&a.ctrl[1], 1u);
    }
  } else if (t == 0) {
    while (*reinterpret_cast<volatile unsigned int*>(&a.ctrl[1]) == gen) {
    }
    __threadfence();
  }
  ++gen;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < K; ++c) v[c] = __ldcg(a.scalars + c);
}

// A-exact's staging buffer for ordered_sum (two chunks of two dots), one
// for the kernel's dots
template <typename T>
__device__ __forceinline__ T* exact_stage() {
  __shared__ T buf[4 * kSeqChunk];
  return buf;
}

// A-exact: after a barrier, each MITgcm tile's K ordered sums of the
// product planes prod[c] (padded fields) into partials[K m + c], a block a
// tile (m = blockIdx.x, blockIdx.x + gridDim.x, ...), then the second
// barrier's ordered sum of the partials. Every thread returns the K sums.
template <typename T, int K>
__device__ __forceinline__ void exact_dots(const Cg2dExactArgs<T>& a,
                                           T* const* prod, unsigned int& gen,
                                           T (&v)[K]) {
  T* const buf = exact_stage<T>();
  T none[1];
  barrier_sum<T, 0>(a, 0, buf, gen, none);
  const int nxp = a.nx + 2 * a.olx;
  const int nsx = a.nx / a.snx;
  const int ntiles = nsx * (a.ny / a.sny);
  for (int m = blockIdx.x; m < ntiles; m += gridDim.x) {
    const size_t p0 = static_cast<size_t>(a.oly + (m / nsx) * a.sny) * nxp
                      + a.olx + (m % nsx) * a.snx;
    const int snx = a.snx;
    T s[K];
    ordered_sum<T, K>(
        a.sny * snx,
        [&](int n, int c) {
          return __ldcg(prod[c] + p0 + static_cast<size_t>(n / snx) * nxp
                        + n % snx);
        },
        buf, s);
    if (threadIdx.x == 0 && threadIdx.y == 0)
#pragma unroll
      for (int c = 0; c < K; ++c) a.partials[K * m + c] = s[c];
  }
  barrier_sum<T, K, true>(a, ntiles, buf, gen, v);
}

template <typename T, bool Exact>
__global__ void __launch_bounds__(NT)
    cg2d_solve_kernel(Cg2dKernelArgs<T, Exact> a) {
  __shared__ T sh[2][2 * NT];
  const int ny = a.ny, nx = a.nx, oly = a.oly, olx = a.olx;
  const int nxp = nx + 2 * olx;
  const int ntx = (nx + BX - 1) / BX;
  const int ntiles = ntx * ((ny + BY - 1) / BY);
  const size_t field = static_cast<size_t>(ny + 2 * oly) * nxp;
  T* const r_buf[2] = {a.work, a.work + field};
  T* const s_buf[2] = {a.work + 2 * field, a.work + 3 * field};
  T* const z = a.work + 4 * field;
  T* const q = a.work + 5 * field;
  T* const x_min = a.work + 6 * field;
  // A-exact's product planes
  T* const prod[2] = {a.work + 7 * field, a.work + 8 * field};
  T* const x = a.x;
  const T tol_sq = *a.tol_sq;
  unsigned int gen = 0;
  if (threadIdx.x == 0 && threadIdx.y == 0)
    gen = *reinterpret_cast<volatile unsigned int*>(&a.ctrl[1]);

  // phase 0: q = A x (r0 = b - A x follows in phase 1 with alpha = 1 and
  // s = 0, as the host loop's first xr step), s = 0
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Cell c = cell_of(tile, ntx, ny, nx, oly, olx);
    if (c.in) {
      const Coeffs<T> k = coeffs(a.aW, a.aS, a.aC, c.p, nxp);
      q[c.p] = k.w * x[c.w] + k.e * x[c.e] + k.s * x[c.s] + k.n * x[c.n]
               + k.c * x[c.p];
      s_buf[0][c.p] = T(0);
    }
  }
  T none[1];
  barrier_sum<T, 0>(a, ntiles, sh[0], gen, none);

  const T one = T(1);
  const T* r_in = a.b;
  int cur = 0;                 // the r and s buffers of this iteration
  T num = one, den = one;      // alpha = num / den
  T eta_nm1 = one, err = T(0), first = T(0), min_err = T(0);
  bool copy = false;           // x_min = x, pending from the last test
  int it = 0;
  for (;;) {
    // phase 1: the x and r updates of the last iteration (and the pending
    // x_min copy of the x read), then z = P r
    {
      const T alpha = num / den;
      const T* s = s_buf[cur];
      T* r_out = r_buf[cur];
      int par = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const Cell c = cell_of(tile, ntx, ny, nx, oly, olx);
        T v[2] = {T(0), T(0)};
        if (c.in) {   // every load first, so that they are in flight together
          const T xc = x[c.p], sc = s[c.p];
          const T r0[5] = {r_in[c.p], r_in[c.w], r_in[c.e], r_in[c.s],
                           r_in[c.n]};
          const T q0[5] = {q[c.p], q[c.w], q[c.e], q[c.s], q[c.n]};
          const Coeffs<T> k = coeffs(a.pW, a.pS, a.pC, c.p, nxp);
          const T rc = r0[0] - alpha * q0[0];
          const T rw = r0[1] - alpha * q0[1];
          const T re = r0[2] - alpha * q0[2];
          const T rs = r0[3] - alpha * q0[3];
          const T rn = r0[4] - alpha * q0[4];
          const T zc = k.c * rc + k.w * rw + k.e * re + k.s * rs + k.n * rn;
          if (copy) x_min[c.p] = xc;
          x[c.p] = xc + alpha * sc;
          r_out[c.p] = rc;
          z[c.p] = zc;
          v[0] = rc * rc;
          v[1] = zc * rc;
          if constexpr (Exact) {
            prod[0][c.p] = v[0];
            prod[1][c.p] = v[1];
          }
        }
        if constexpr (!Exact) {
          tile_sum<T, 2>(v, sh[par], a.partials + 2 * tile);
          par ^= 1;
        }
      }
      T sums[2];
      if constexpr (Exact)
        exact_dots<T, 2>(a, prod, gen, sums);
      else
        barrier_sum<T, 2>(a, ntiles, sh[0], gen, sums);
      err = sums[0];
      const T eta_n = sums[1];
      // the host loop's x_min = x after this test: the first x, then each
      // x with a smaller residual (copied in the next phase 1, before x
      // changes, and only if there is one: after the last test the copy
      // cannot change the selection below)
      if (it == 0) {
        first = err;
        min_err = err;
        copy = a.use_min;
      } else {
        copy = a.use_min && err < min_err;
        if (err < min_err) min_err = err;
      }
      if (!(err >= tol_sq && it < a.max_iters)) break;
      num = eta_n;
    }
    // phase 2: s = z + beta s, q = A s, dot(s, q)
    {
      const T beta = num / eta_nm1;
      const T* s_in = s_buf[cur];
      T* s_out = s_buf[cur ^ 1];
      int par = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const Cell c = cell_of(tile, ntx, ny, nx, oly, olx);
        T v[1] = {T(0)};
        if (c.in) {
          const T z0[5] = {z[c.p], z[c.w], z[c.e], z[c.s], z[c.n]};
          const T s0[5] = {s_in[c.p], s_in[c.w], s_in[c.e], s_in[c.s],
                           s_in[c.n]};
          const Coeffs<T> k = coeffs(a.aW, a.aS, a.aC, c.p, nxp);
          const T sc = z0[0] + beta * s0[0];
          const T sw = z0[1] + beta * s0[1];
          const T se = z0[2] + beta * s0[2];
          const T ss = z0[3] + beta * s0[3];
          const T sn = z0[4] + beta * s0[4];
          const T qc = k.w * sw + k.e * se + k.s * ss + k.n * sn + k.c * sc;
          s_out[c.p] = sc;
          q[c.p] = qc;
          v[0] = qc * sc;
          if constexpr (Exact) prod[0][c.p] = v[0];
        }
        if constexpr (!Exact) {
          tile_sum<T, 1>(v, sh[par], a.partials + tile);
          par ^= 1;
        }
      }
      T sq[1];
      if constexpr (Exact)
        exact_dots<T, 1>(a, prod, gen, sq);
      else
        barrier_sum<T, 1>(a, ntiles, sh[0], gen, sq);
      den = sq[0];
      eta_nm1 = num;
    }
    r_in = r_buf[cur];
    cur ^= 1;
    ++it;
  }
  if (a.use_min && err > min_err) {
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const Cell c = cell_of(tile, ntx, ny, nx, oly, olx);
      if (c.in) x[c.p] = x_min[c.p];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    a.scalars[2] = first;
    a.scalars[3] = err;
    a.ctrl[2] = static_cast<unsigned int>(it);
  }
}

// The grid: as many blocks as the card holds at once (so that the
// cooperative launch is accepted), at most one a tile.
template <typename T, bool Exact>
int launch_cg2d_solve(const Cg2dKernelArgs<T, Exact>& args, void* stream) {
  if (args.ny < 1 || args.nx < 1 || args.oly < 1 || args.olx < 1)
    return (int)cudaErrorInvalidValue;
  if constexpr (Exact) {
    if (args.sny < 1 || args.snx < 1 || args.ny % args.sny != 0 ||
        args.nx % args.snx != 0)
      return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cg2d_solve_kernel<T, Exact>, NT, 0);
  if (err != cudaSuccess) return (int)err;
  const dim3 tiles = grid2d(args.ny, args.nx);
  const int ntiles = (int)(tiles.x * tiles.y);
  const int blocks = per_sm * sms < ntiles ? per_sm * sms : ntiles;
  Cg2dKernelArgs<T, Exact> a = args;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)cg2d_solve_kernel<T, Exact>,
                                    dim3(blocks), dim3(BX, BY), params, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear it: the wrapper raises with this code
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

using mitgcm::grid2d;

#define MITGCM_CG2D_ENTRY_POINT(T, SUF)                                       \
  extern "C" int mitgcm_cg2d_solve_##SUF(                                     \
      const void* aW, const void* aS, const void* aC, const void* pW,         \
      const void* pS, const void* pC, const void* b, const void* tol_sq,      \
      void* x, void* work, void* partials, void* scalars, void* ctrl, int ny, \
      int nx, int oly, int olx, int max_iters, int use_min, void* stream) {   \
    mitgcm::Cg2dArgs<T> a{(const T*)aW,     (const T*)aS,                     \
                          (const T*)aC,     (const T*)pW,                     \
                          (const T*)pS,     (const T*)pC,                     \
                          (const T*)b,      (const T*)tol_sq,                 \
                          (T*)x,            (T*)work,                         \
                          (T*)partials,     (T*)scalars,                      \
                          (unsigned int*)ctrl, ny, nx, oly, olx, max_iters,   \
                          use_min};                                           \
    return mitgcm::launch_cg2d_solve<T, false>(a, stream);                    \
  }                                                                           \
  extern "C" int mitgcm_cg2d_solve_exact_##SUF(                               \
      const void* aW, const void* aS, const void* aC, const void* pW,         \
      const void* pS, const void* pC, const void* b, const void* tol_sq,      \
      void* x, void* work, void* partials, void* scalars, void* ctrl, int ny, \
      int nx, int oly, int olx, int max_iters, int use_min, int sny, int snx, \
      void* stream) {                                                         \
    mitgcm::Cg2dExactArgs<T> a{{(const T*)aW, (const T*)aS, (const T*)aC,     \
                                (const T*)pW, (const T*)pS, (const T*)pC,     \
                                (const T*)b, (const T*)tol_sq, (T*)x,         \
                                (T*)work, (T*)partials, (T*)scalars,          \
                                (unsigned int*)ctrl, ny, nx, oly, olx,        \
                                max_iters, use_min},                          \
                               sny, snx};                                     \
    return mitgcm::launch_cg2d_solve<T, true>(a, stream);                     \
  }

MITGCM_CG2D_ENTRY_POINT(float, f32)
MITGCM_CG2D_ENTRY_POINT(double, f64)

// Number of 32 x 8 tiles of an ny x nx interior: the per-tile partial sums
// of cg2d_solve (two each) and of the dot-producing cg3d kernels.
extern "C" int mitgcm_cg2d_num_partials(int ny, int nx) {
  const dim3 g = grid2d(ny, nx);
  return (int)(g.x * g.y);
}

extern "C" const char* mitgcm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
