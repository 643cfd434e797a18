// Kernel H-cg3d's two passes, column-walking tiles, and their launches.
// Included by cg3d.cu, whose entry points start them on the card, and by
// the host check of the tests, which runs them on the CPU.
//
// A block owns one 32 x 8 tile of interior columns (BX x BY: the tile of
// common.cuh:grid_reduce's fixed tree, so the dot products keep their
// order), one thread a column, and walks the levels from the surface
// down.
//  - cg3d_s_stencil_dot (pass A) forms each level's s' = (q + beta s)
//    maskC once for the tile and its one-cell ring, in shared memory (two
//    stages that alternate with k, one barrier a level); a stage cell
//    outside the interior holds the interior cell it wraps to
//    (common.cuh:wrap), so no halo is filled inside the loop. The ring's
//    80 cells are formed by threads 0..79, each keeping its cell for the
//    whole walk. From that plane qA = (A s') maskC in the JAX code's term
//    order; s' of the level below is the next stage's own cell, carried
//    in a register. Each level's loads are issued a level ahead (q, s and
//    maskC two levels ahead, since s' of level k + 1 is formed at level
//    k).
//  - cg3d_xr_precond (pass B) walks each column down: x and r updated,
//    dot(r, r), P's forward substitution on the new r; then up: the back
//    substitution writes q once and sums dot(q, r). The forward values
//    and the new r stay in dynamic shared memory between the two sweeps
//    (2 nr values of T a column: 100 KB a block at 50 levels in float32),
//    where the card offers that much; otherwise (a deep column in float64)
//    they go through q and r in device memory, as the three-launch
//    iteration did. The down sweep loads a group of 8 levels of float (4
//    of double) while it sums the group before, the up sweep 16 (8): the
//    walk's time is the latency of its loads, and one block an SM (its
//    registers) with that many levels in flight ran faster than two with
//    fewer. Both dot products are reduced together (grid_reduce with K =
//    2), and the last block updates `ctrl`.
// One column a thread: the reduction tree fixes the tile at 256 columns,
// whose staged columns take 100 KB, and the interior starts 8 bytes past
// a 16-byte boundary on the halos of 2 that the path runs. Two columns a
// thread (8-byte loads) ran pass B no faster on an H100, nor did its
// loads as asynchronous copies into a ring in shared memory; nor did pass
// A's loads 2-4 levels ahead.
#pragma once

#include "common.cuh"

namespace mitgcm {

// the stage of pass A: the tile and its ring, (ry, rx) from the ring's
// south-west corner (j0 - 1, i0 - 1)
constexpr int kCgRX = BX + 2;
constexpr int kCgRY = BY + 2;
constexpr int kCgRing = 2 * BX + 2 * BY;   // the ring without its corners
static_assert(kCgRing <= NT, "one thread per ring cell");

// the region coordinates of ring cell c: the south row, the north row,
// then the west and east columns between them
__device__ __forceinline__ void cg_ring_cell(int c, int& ry, int& rx) {
  if (c < BX) {
    ry = 0;
    rx = c + 1;
  } else if (c < 2 * BX) {
    ry = kCgRY - 1;
    rx = c - BX + 1;
  } else if (c < 2 * BX + BY) {
    ry = c - 2 * BX + 1;
    rx = 0;
  } else {
    ry = c - 2 * BX - BY + 1;
    rx = kCgRX - 1;
  }
}

// q, s and maskC of one cell and level, the inputs of its s'
template <typename T>
struct SIn {
  T q = T(0), s = T(0), m = T(0);
};

template <typename T>
__device__ __forceinline__ SIn<T> s_in_at(const T* q, const T* s,
                                          const T* maskC, size_t p, int k,
                                          int nr, size_t plane) {
  SIn<T> v;
  if (k < nr) {
    const size_t pk = p + k * plane;
    v.q = q[pk];
    v.s = s[pk];
    v.m = maskC[pk];
  }
  return v;
}

// the operator's coefficients of one column and level: aW, its eastern
// neighbour's, aS, its northern neighbour's, aC, and aV of the level below
template <typename T>
struct AIn {
  T w = T(0), we = T(0), s = T(0), sn = T(0), c = T(0), vdn = T(0);
};

template <typename T>
__device__ __forceinline__ AIn<T> a_in_at(const T* aW, const T* aS,
                                          const T* aV, const T* aC, size_t p,
                                          int k, int nr, size_t plane,
                                          int nxp) {
  AIn<T> a;
  if (k < nr) {
    const size_t pk = p + k * plane;
    a.w = aW[pk];
    a.we = aW[pk + 1];
    a.s = aS[pk];
    a.sn = aS[pk + nxp];
    a.c = aC[pk];
    if (k + 1 < nr) a.vdn = aV[pk + plane];
  }
  return a;
}

// Pass A: on the interior s_out = (q + beta s_in) maskC with beta = eta_n
// / eta_nm1, qa = (A s_out) maskC and dot_out = dot(s_out, qa), each
// column summed from the surface down.
template <typename T>
__global__ void __launch_bounds__(NT) cg3d_s_stencil_dot_kernel(
    const T* __restrict__ aW, const T* __restrict__ aS,
    const T* __restrict__ aV, const T* __restrict__ aC,
    const T* __restrict__ maskC, const T* __restrict__ q,
    const T* __restrict__ s_in, T* __restrict__ s_out, T* __restrict__ qa,
    const T* eta_n, const T* eta_nm1, T* dot_out, T* partials,
    unsigned int* counter, const int* ctrl, int nr, int ny, int nx, int oly,
    int olx) {
  if (ctrl[0]) return;   // the same for every block of the launch
  __shared__ T sh[NT];
  __shared__ T stage[2][kCgRY][kCgRX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * BX + tx;
  const int i0 = blockIdx.x * BX, j0 = blockIdx.y * BY;
  const bool own = i0 + tx < nx && j0 + ty < ny;
  const int nxp = nx + 2 * olx;
  const size_t plane = static_cast<size_t>(ny + 2 * oly) * nxp;
  // the padded index of this thread's stage cell (its own column, or the
  // interior column that a cell past the interior wraps to) and of its
  // ring cell
  const size_t p =
      static_cast<size_t>(wrap(j0 + ty + oly, oly, ny)) * nxp +
      wrap(i0 + tx + olx, olx, nx);
  const bool ring = t < kCgRing;
  int ry = 0, rx = 0;
  if (ring) cg_ring_cell(t, ry, rx);
  const size_t pr =
      ring ? static_cast<size_t>(wrap(j0 + oly - 1 + ry, oly, ny)) * nxp +
                 wrap(i0 + olx - 1 + rx, olx, nx)
           : 0;
  const T beta = *eta_n / *eta_nm1;
  auto snew = [&](const SIn<T>& v) { return (v.q + beta * v.s) * v.m; };
  auto ring_in = [&](int k) {
    return ring ? s_in_at(q, s_in, maskC, pr, k, nr, plane) : SIn<T>{};
  };
  auto coef = [&](int k) {
    return own ? a_in_at(aW, aS, aV, aC, p, k, nr, plane, nxp) : AIn<T>{};
  };

  // level 0's s' staged; level 1's inputs and level 0's coefficients in
  // flight
  const SIn<T> c0 = s_in_at(q, s_in, maskC, p, 0, nr, plane);
  T s_c = snew(c0);
  T m_c = c0.m;
  stage[0][ty + 1][tx + 1] = s_c;
  if (ring) stage[0][ry][rx] = snew(ring_in(0));
  SIn<T> c1 = s_in_at(q, s_in, maskC, p, 1, nr, plane);
  SIn<T> r1 = ring_in(1);
  AIn<T> a0 = coef(0);
  T av = own ? aV[p] : T(0);
  __syncthreads();
  T s_up = T(0);
  T acc = T(0);
  for (int k = 0; k < nr; ++k) {
    const int b = k & 1;
    // the next level's loads before this level's sums
    const SIn<T> c2 = s_in_at(q, s_in, maskC, p, k + 2, nr, plane);
    const SIn<T> r2 = ring_in(k + 2);
    const AIn<T> a1 = coef(k + 1);
    // s' of level k + 1 into the other stage
    const bool deep = (k + 1 == nr);
    const T s_dn = deep ? T(0) : snew(c1);
    if (!deep) {
      stage[b ^ 1][ty + 1][tx + 1] = s_dn;
      if (ring) stage[b ^ 1][ry][rx] = snew(r1);
    }
    if (own) {
      const T v = a0.w * stage[b][ty + 1][tx] +
                  a0.we * stage[b][ty + 1][tx + 2] +
                  a0.s * stage[b][ty][tx + 1] +
                  a0.sn * stage[b][ty + 2][tx + 1] + av * s_up +
                  a0.vdn * s_dn + a0.c * s_c;
      const T qk = v * m_c;
      const size_t pk = p + k * plane;
      s_out[pk] = s_c;
      qa[pk] = qk;
      acc = acc + s_c * qk * m_c;
    }
    s_up = s_c;
    s_c = s_dn;
    m_c = c1.m;
    av = a0.vdn;
    c1 = c2;
    r1 = r2;
    a0 = a1;
    __syncthreads();
  }
  grid_sum(acc, sh, partials, counter, dot_out);
}

// Pass B: on the interior x = (x + alpha s) maskC and r = (r - alpha qa)
// maskC with alpha = num / den, err_out = dot(r, r) (each column summed
// from the surface down), q = P^-1 r and eta_out = dot(q, r) (summed from
// the bottom up). With STAGED the forward values and the new r wait in
// dynamic shared memory ([nr][NT] each) between the sweeps, else in q and
// r. DOWN and UP levels are loaded while the group before them
// is summed. pair holds the two sums for the last block, which copies them
// out and adds count_iter to the iterations in ctrl, setting done when
// dot(r, r) < tol_sq or the iterations reach max_iters.
template <typename T, bool STAGED, int DOWN, int UP>
__global__ void __launch_bounds__(NT) cg3d_xr_precond_kernel(
    T* __restrict__ x, T* __restrict__ r, const T* __restrict__ s,
    const T* __restrict__ qa, const T* __restrict__ maskC,
    const T* __restrict__ zMC, const T* __restrict__ zML,
    const T* __restrict__ zMU, T* __restrict__ q, const T* num,
    const T* den, T* err_out, T* eta_out, T* partials,
    unsigned int* counter, T* pair, int* ctrl, const T* tol_sq, int nr,
    int ny, int nx, int oly, int olx, int max_iters, int count_iter) {
  if (ctrl[0]) return;
  __shared__ T sh[2 * NT];
  const int t = threadIdx.y * BX + threadIdx.x;
  const int i0 = blockIdx.x * BX + threadIdx.x;
  const int j0 = blockIdx.y * BY + threadIdx.y;
  T acc[2] = {T(0), T(0)};
  if (i0 < nx && j0 < ny) {
    T* ys = STAGED ? dynamic_shared<T>() : nullptr;
    T* rs = STAGED ? ys + static_cast<size_t>(nr) * NT : nullptr;
    const int nxp = nx + 2 * olx;
    const size_t plane = static_cast<size_t>(ny + 2 * oly) * nxp;
    const size_t p0 = static_cast<size_t>(j0 + oly) * nxp + i0 + olx;
    const T alpha = *num / *den;
    struct Fwd {
      T x, r, s, qa, m, zc, zl;
    };
    auto fwd_at = [&](int k) {
      Fwd f{};
      if (k < nr) {
        const size_t p = p0 + k * plane;
        f = Fwd{x[p], r[p], s[p], qa[p], maskC[p], zMC[p], zML[p]};
      }
      return f;
    };
    // down: x, r, dot(r, r), the forward sweep
    Fwd cur[DOWN], nxt[DOWN];
#pragma unroll
    for (int g = 0; g < DOWN; ++g) cur[g] = fwd_at(g);
    T ykm1 = T(0);
    for (int kb = 0; kb < nr; kb += DOWN) {
#pragma unroll
      for (int g = 0; g < DOWN; ++g) nxt[g] = fwd_at(kb + DOWN + g);
#pragma unroll
      for (int g = 0; g < DOWN; ++g) {
        const int k = kb + g;
        if (k >= nr) break;
        const Fwd& f = cur[g];
        const size_t p = p0 + k * plane;
        x[p] = (f.x + alpha * f.s) * f.m;
        const T rn = (f.r - alpha * f.qa) * f.m;
        r[p] = rn;
        acc[0] = acc[0] + rn * rn * f.m;
        const T yk = f.zc * (rn - f.zl * ykm1);
        if (STAGED) {
          ys[k * NT + t] = yk;
          rs[k * NT + t] = rn;
        } else {
          q[p] = yk;
        }
        ykm1 = yk;
      }
#pragma unroll
      for (int g = 0; g < DOWN; ++g) cur[g] = nxt[g];
    }
    struct Bwd {
      T zu, m, y, r;
    };
    auto bwd_at = [&](int k) {
      Bwd b{};
      if (k >= 0) {
        const size_t p = p0 + k * plane;
        b.zu = zMU[p];
        b.m = maskC[p];
        if (!STAGED) {
          b.y = q[p];
          b.r = r[p];
        }
      }
      return b;
    };
    // up: the back sweep and dot(q, r)
    Bwd bcur[UP], bnxt[UP];
#pragma unroll
    for (int g = 0; g < UP; ++g) bcur[g] = bwd_at(nr - 1 - g);
    T qkp1 = T(0);
    for (int kb = nr - 1; kb >= 0; kb -= UP) {
#pragma unroll
      for (int g = 0; g < UP; ++g) bnxt[g] = bwd_at(kb - UP - g);
#pragma unroll
      for (int g = 0; g < UP; ++g) {
        const int k = kb - g;
        if (k < 0) break;
        const Bwd& b = bcur[g];
        const T y = STAGED ? ys[k * NT + t] : b.y;
        const T rk = STAGED ? rs[k * NT + t] : b.r;
        const T qk = y - b.zu * qkp1;
        q[p0 + k * plane] = qk;
        qkp1 = qk;
        acc[1] = acc[1] + qk * rk * b.m;
      }
#pragma unroll
      for (int g = 0; g < UP; ++g) bcur[g] = bnxt[g];
    }
  }
  if (grid_reduce(acc, Add(), sh, partials, counter, pair)) {
    // every other block has passed its `done` test: stop or go on
    *err_out = pair[0];
    *eta_out = pair[1];
    const int it = ctrl[1] + count_iter;
    ctrl[1] = it;
    ctrl[0] = (!(pair[0] >= *tol_sq) || it >= max_iters) ? 1 : 0;
  }
}

// the pointers of pass A's launch, in its entry point's order
template <typename T>
struct SStencilArgs {
  const T *aW, *aS, *aV, *aC, *maskC, *q, *s_in;
  T *s_out, *qa;
  const T *eta_n, *eta_nm1;
  T *dot_out, *partials;
  unsigned int* counter;
  const int* ctrl;
};

// Start pass A with start(kernel, grid, block, args...) (OnStream on the
// card).
template <typename T, typename Start>
int launch_s_stencil_dot(const SStencilArgs<T>& a, int nr, int ny, int nx,
                         int oly, int olx, Start start) {
  if (nr < 1 || ny < 1 || nx < 1 || oly < 1 || olx < 1)
    return (int)cudaErrorInvalidValue;
  start(cg3d_s_stencil_dot_kernel<T>, grid2d(ny, nx), dim3(BX, BY), a.aW,
        a.aS, a.aV, a.aC, a.maskC, a.q, a.s_in, a.s_out, a.qa, a.eta_n,
        a.eta_nm1, a.dot_out, a.partials, a.counter, a.ctrl, nr, ny, nx, oly,
        olx);
  return (int)cudaGetLastError();
}

template <typename T>
struct XrPrecondArgs {
  T *x, *r;
  const T *s, *qa, *maskC, *zMC, *zML, *zMU;
  T* q;
  const T *num, *den;
  T *err_out, *eta_out, *partials;
  unsigned int* counter;
  T* pair;
  int* ctrl;
  const T* tol_sq;
};

// pass B's levels in flight: the down sweep's group (7 fields a level, 8
// levels of float), the up sweep's (2 fields a level, 16 of float)
template <typename T>
constexpr int kXrDown = 32 / sizeof(T);
template <typename T>
constexpr int kXrUp = 64 / sizeof(T);
// the static shared memory of pass B
template <typename T>
constexpr size_t kXrStatic = 2 * NT * sizeof(T) + 16;

// Start pass B with start.shared(kernel, bytes, grid, block, args...) (a
// kernel with dynamic shared memory; OnStream on the card): staged where
// the block can hold its columns' forward values and new r beside its
// static shared memory (start.max_shared(): the most a block may use),
// else through q and r.
template <typename T, typename Start>
int launch_xr_precond(const XrPrecondArgs<T>& a, int nr, int ny, int nx,
                      int oly, int olx, int max_iters, int count_iter,
                      Start start) {
  if (nr < 1 || ny < 1 || nx < 1 || oly < 1 || olx < 1)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = 2 * static_cast<size_t>(nr) * NT * sizeof(T);
  const bool staged = bytes + kXrStatic<T> <= start.max_shared();
  auto go = [&](auto kernel, size_t smem) {
    start.shared(kernel, smem, grid2d(ny, nx), dim3(BX, BY), a.x, a.r, a.s,
                 a.qa, a.maskC, a.zMC, a.zML, a.zMU, a.q, a.num, a.den,
                 a.err_out, a.eta_out, a.partials, a.counter, a.pair, a.ctrl,
                 a.tol_sq, nr, ny, nx, oly, olx, max_iters, count_iter);
  };
  if (staged)
    go(cg3d_xr_precond_kernel<T, true, kXrDown<T>, kXrUp<T>>, bytes);
  else
    go(cg3d_xr_precond_kernel<T, false, kXrDown<T>, kXrUp<T>>, size_t(0));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
