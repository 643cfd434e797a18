// Kernel B''s backward kernel: a column-walking tile (tile.cuh) that forms
// each face cotangent and each viscous coefficient once, and its launch.
// Included by mom_fluxform_adj.cu, whose entry points start it on the
// card, and by the host check of the tests, which runs it on the CPU.
//
// B' writes u_bar, v_bar and w_bar at every padded cell, nonzero up to one
// cell outside the interior (the output region): a block owns kTX x kTY
// columns of that region and walks k from the surface down; the blocks past
// the tiles zero the rest. Per level each thread stages its own column and
// the first kRing threads one cell of the tile's one-cell ring, each the
// same cell all the walk long, into shared memory: u, v, the transports
// uTrans and vTrans, hFacW, hFacS, maskW, maskS, the masked cotangents of
// the advective (aU, aV) and viscous (dU, dV) brackets, the Coriolis
// terms' cotangent products, level k-1's u and v and the vertical flux
// cotangents FvU and FvV at interface k (from the cotangents of levels k-1
// and k, which the thread carries), and over the south-west region w rA at
// levels k and k+1 and w rA dmask at level k. Then each thread forms the
// face cotangents of its own cell's faces (FzU, FmU, FzV, FmV) and the
// viscous products (the face cotangent times its coefficient: VzU ZU, VmU
// MU, VzV ZV, VmV MV) and hFacZ, four warps those of the ring's faces, into
// shared memory; each cell then sums its contributions. The own column's
// cotangents, FvU/FvV, RvU/RvV and RU/RV at interface k+1 come from level
// k+1's loads, which the thread issues a level ahead with the rest of that
// level's loads, and stay in registers as the next level's upper-interface
// terms. Three barriers a level.
// Each sum takes its terms in the order, and each term the expression, of
// the one-thread-a-cell kernel this replaced (u_bar, v_bar, the drag, then
// w_bar; a term whose face or cell lies outside the function's reach is
// skipped as there), so with --fmad=false the outputs are that kernel's
// bits.
#pragma once

#include <cstring>

#include "mom_fluxform.cuh"
#include "tile.cuh"

namespace mitgcm {

template <typename T>
struct MomAdjArgs {
  // kernel B's table; its output slots gU, gV, guDiss and gvDiss hold the
  // cotangents of those outputs
  MomArgs<T> f;
  // outputs [nr, nyp, nxp]
  T *u_bar, *v_bar, *w_bar;
};
constexpr int kMomAdjNumPointers = kMomNumPointers + 3;

// the tile and its south and west ring (as mom_fluxform_tile.cuh)
constexpr int kAdjSWX = kTX + 1;
constexpr int kAdjSW = kAdjSWX * (kTY + 1);

template <typename T>
struct MomAdjShared {
  // level k over the region
  T u[kRegion], v[kRegion], uT[kRegion], vT[kRegion], hW[kRegion],
      hS[kRegion], mW[kRegion], mS[kRegion];
  T aU[kRegion], aV[kRegion], dU[kRegion], dV[kRegion];
  // cV times its Coriolis factor (in u_bar), cU times its factor (in v_bar)
  T cv[kRegion], cu[kRegion];
  // level k-1's u and v, the flux cotangents at interface k
  T uP[kRegion], vP[kRegion], FvU[kRegion], FvV[kRegion];
  // over the south-west region: w rA and w rA dmask at level k, w rA at
  // level k+1
  T wrA[kAdjSW], wd[kAdjSW], wrA1[kAdjSW];
  // the faces: [row][column] of the face's cell from the tile's first,
  // FzU/PzU from the west ring's column, FmV/PmV from the south ring's row
  T FzU[kTY][kTX + 1], PzU[kTY][kTX + 1];
  T FmU[kTY + 1][kTX + 1], PmU[kTY + 1][kTX];
  T FzV[kTY + 1][kTX + 1], PzV[kTY][kTX + 1];
  T FmV[kTY + 1][kTX], PmV[kTY + 1][kTX];
  T hFacZ[kTY + 1][kTX + 1];
};

// what the kernel loads for level k, issued while level k-1 is computed
template <typename T>
struct MomAdjLevel {
  // the own column: hFacW, hFacS, hFacC at level k; at level k+1 u, v,
  // maskW, maskS, recip_hFacW, recip_hFacS, the four cotangents, the
  // kappas (k+1 of nr+1), w and maskC
  T hW = T(0), hS = T(0), hC = T(0);
  T u1 = T(0), v1 = T(0), mW1 = T(0), mS1 = T(0), rhW1 = T(0), rhS1 = T(0),
    gU1 = T(0), gV1 = T(0), gD1 = T(0), gvD1 = T(0), kRU1 = T(0),
    kRV1 = T(0), w1 = T(0), mC1 = T(0);
  // the ring cell at level k: u, v, maskW, maskS, hFacW, hFacS,
  // recip_hFacW, recip_hFacS, the four cotangents; w and maskC at k+1
  T ru = T(0), rv = T(0), rmW = T(0), rmS = T(0), rHW = T(0), rHS = T(0),
    rrhW = T(0), rrhS = T(0), rgU = T(0), rgV = T(0), rgD = T(0),
    rgvD = T(0), rw1 = T(0), rmC1 = T(0);
  // hFacC at level k of the ring face of the south row or west column
  T eHC = T(0);
};

// a cell a thread stages all the walk long: its own column or its ring cell
template <typename T>
struct MomAdjSlot {
  int r = 0, sw = -1;   // region index; south-west index or -1
  bool valid = false;   // inside the padded array
  bool inner = false;   // inside the interior (nonzero cotangents)
  size_t q = 0;         // 2-D index
  T dyG = T(0), dxG = T(0), rrAw = T(0), rrAs = T(0), rA = T(0),
    fu = T(0), fv = T(0);
  // carried from level k-1: the cotangents, u and v; w, maskC at level k
  // and maskC at level k-1
  T aU = T(0), aV = T(0), dU = T(0), dV = T(0), u = T(0), v = T(0);
  T w = T(0), mC = T(0), mCp = T(0);
};

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    mom_fluxform_adj_kernel(const MomAdjArgs<T> b, int nr, int ny, int nx,
                            int oly, int olx, int ntx, int tiles, T viscAhD,
                            T viscAhZ, T sideDragFactor, T rkSign) {
  const MomArgs<T>& a = b.f;
  const int nyp = ny + 2 * oly, nxp = nx + 2 * olx;
  const size_t plane = static_cast<size_t>(nyp) * nxp;
  int j0, i0;
  // the tiles cover the output region, one cell more than the interior
  if (!tile_origin(ntx, tiles, oly - 1, olx - 1, j0, i0)) {
    T* const outs[3] = {b.u_bar, b.v_bar, b.w_bar};
    zero_halo(outs, nr, ny + 2, nx + 2, oly - 1, olx - 1, blockIdx.x - tiles,
              gridDim.x - tiles);
    return;
  }
  __shared__ MomAdjShared<T> s;
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * kTX + tx;
  const int j = j0 + ty, i = i0 + tx;
  const bool own = j < nyp && i < nxp;
  const bool active = j <= oly + ny && i <= olx + nx;
  const size_t q = own ? static_cast<size_t>(j) * nxp + i : 0;
  const T nAhD = -viscAhD, nAhZ = -viscAhZ;
  const T q25 = T(0.25);

  // where the interior's cotangents are nonzero, and the faces whose
  // fluxes interior cells read (kernel B's output region)
  auto row = [&](int jj) { return jj >= oly && jj < oly + ny; };
  auto col = [&](int ii) { return ii >= olx && ii < olx + nx; };
  auto in = [&](int jj, int ii) { return row(jj) && col(ii); };
  auto zonU = [&](int jj, int ii) {
    return row(jj) && ii >= olx - 1 && ii <= olx + nx - 1;
  };
  auto merU = [&](int jj, int ii) {
    return col(ii) && jj >= oly && jj <= oly + ny;
  };
  auto zonV = [&](int jj, int ii) {
    return row(jj) && ii >= olx && ii <= olx + nx;
  };
  auto merV = [&](int jj, int ii) {
    return col(ii) && jj >= oly - 1 && jj <= oly + ny - 1;
  };

  // the staging slots: 0 the own column, 1 the ring cell (threads < kRing)
  MomAdjSlot<T> sl[2];
  const int nslots = t < kRing ? 2 : 1;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    if (n >= nslots) break;
    int ry = ty + 1, rx = tx + 1;
    if (n == 1) ring_cell(t, ry, rx);
    MomAdjSlot<T>& c = sl[n];
    const int cj = j0 - 1 + ry, ci = i0 - 1 + rx;
    c.r = rg(ry, rx);
    c.valid = cj >= 0 && ci >= 0 && cj < nyp && ci < nxp;
    c.inner = in(cj, ci);
    if (ry <= kTY && rx <= kTX) c.sw = ry * kAdjSWX + rx;
    if (c.valid) {
      c.q = static_cast<size_t>(cj) * nxp + ci;
      c.dyG = a.dyG[c.q];
      c.dxG = a.dxG[c.q];
      if (c.inner) {
        const T fC = a.fCori[c.q];
        c.rrAw = a.recip_rAw[c.q];
        c.rrAs = a.recip_rAs[c.q];
        c.fu = T(0.5) * (fC + a.fCori[c.q - 1]) * q25;
        c.fv = T(-0.5) * (fC + a.fCori[c.q - nxp]) * q25;
      }
      if (c.sw >= 0) {
        c.rA = a.rA[c.q];
        c.w = a.w[c.q];
        c.mC = a.maskC[c.q];
      }
    }
  }

  // the own column's 2-D metrics
  T rAw = 0, rAs = 0, rA = 0, dyF = 0, rdxF = 0, cosU = 0, dxV = 0, rdyU = 0,
    dyU = 0, rdxV = 0, cosV = 0, dxF = 0, rdyF = 0, dxVn = 0, rdyUn = 0,
    dyUe = 0, rdxVe = 0;
  if (own) {
    rAw = a.rAw[q];
    rAs = a.rAs[q];
    rA = a.rA[q];
    dyF = a.dyF[q];
    rdxF = a.recip_dxF[q];
    cosU = a.cosFacU[q];
    dxV = a.dxV[q];
    rdyU = a.recip_dyU[q];
    dyU = a.dyU[q];
    rdxV = a.recip_dxV[q];
    cosV = a.cosFacV[q];
    dxF = a.dxF[q];
    rdyF = a.recip_dyF[q];
  }
  if (own && in(j, i)) {
    dxVn = a.dxV[q + nxp];
    rdyUn = a.recip_dyU[q + nxp];
    dyUe = a.dyU[q + 1];
    rdxVe = a.recip_dxV[q + 1];
  }

  // the ring's faces, a task per warp: 0 the south row's FmV and PmV, 1 the
  // north row's hFacZ, FmU, PmU and FzV, 2 the west column's FzU and PzU, 3
  // the east column's hFacZ, FmU, FzV and PzV
  int task = -1, ey = 0, ex = 0;
  if (ty == 0) {
    task = 0, ey = 0, ex = tx + 1;
  } else if (ty == 1) {
    task = 1, ey = kTY + 1, ex = tx + 1;
  } else if (ty == 2 && tx < kTY) {
    task = 2, ey = tx + 1, ex = 0;
  } else if (ty == 3 && tx < kTY) {
    task = 3, ey = tx + 1, ex = kTX + 1;
  }
  const int ej = j0 - 1 + ey, ei = i0 - 1 + ex;
  const bool ev = task >= 0 && ej >= 0 && ei >= 0 && ej < nyp && ei < nxp;
  const size_t eq = ev ? static_cast<size_t>(ej) * nxp + ei : 0;
  T e0 = 0, e1 = 0, e2 = 0;
  if (ev) {
    if (task == 0) {
      e0 = a.dxF[eq], e1 = a.recip_dyF[eq];
    } else if (task == 1) {
      e0 = a.dxV[eq], e1 = a.recip_dyU[eq];
    } else if (task == 2) {
      e0 = a.dyF[eq], e1 = a.recip_dxF[eq], e2 = a.cosFacU[eq];
    } else {
      e0 = a.dyU[eq], e1 = a.recip_dxV[eq], e2 = a.cosFacV[eq];
    }
  }

  // the masked cotangents of a cell at level k (0 outside the interior)
  auto cot = [&](bool inner, int k, T rr, T g, T m, T rrA) -> T {
    return inner ? -(rr * a.recip_drF[k] * rrA) * (g * m) : T(0);
  };

  // level 0 of the own column: u, v, the masks, recip_hFac, the
  // cotangents, and the flux cotangents at the surface interface
  T u0 = 0, v0 = 0, mW0 = 0, mS0 = 0, rhW0 = 0, rhS0 = 0, gU0 = 0, gV0 = 0,
    gD0 = 0, gvD0 = 0;
  const bool oin = own && in(j, i);
  if (own) {
    u0 = a.u[q], v0 = a.v[q], mW0 = a.maskW[q], mS0 = a.maskS[q];
    rhW0 = a.recip_hFacW[q], rhS0 = a.recip_hFacS[q];
    if (oin) {
      gU0 = a.gU[q], gV0 = a.gV[q], gD0 = a.guDiss[q], gvD0 = a.gvDiss[q];
    }
  }
  const T rrAw0 = sl[0].rrAw, rrAs0 = sl[0].rrAs;
  T aU0 = cot(oin, 0, rhW0, gU0, mW0, rrAw0);
  T aV0 = cot(oin, 0, rhS0, gV0, mS0, rrAs0);
  T dU0 = cot(oin, 0, rhW0, gD0, mW0, rrAw0);
  T dV0 = cot(oin, 0, rhS0, gvD0, mS0, rrAs0);
  T RvU0 = (T(0) - dU0) * rkSign, RvV0 = (T(0) - dV0) * rkSign;
  T RU0 = 0, RV0 = 0;

  auto load = [&](int k) {
    MomAdjLevel<T> L;
    const size_t lev = static_cast<size_t>(k) * plane;
    const bool deep = k == nr - 1;
    if (own) {
      const size_t p = lev + q;
      L.hW = a.hFacW[p], L.hS = a.hFacS[p], L.hC = a.hFacC[p];
      L.kRU1 = a.kappaRU[p + plane], L.kRV1 = a.kappaRV[p + plane];
      if (!deep) {
        const size_t p1 = p + plane;
        L.u1 = a.u[p1], L.v1 = a.v[p1];
        L.mW1 = a.maskW[p1], L.mS1 = a.maskS[p1];
        L.rhW1 = a.recip_hFacW[p1], L.rhS1 = a.recip_hFacS[p1];
        L.w1 = a.w[p1], L.mC1 = a.maskC[p1];
        if (oin) {
          L.gU1 = a.gU[p1], L.gV1 = a.gV[p1];
          L.gD1 = a.guDiss[p1], L.gvD1 = a.gvDiss[p1];
        }
      }
    }
    if (nslots > 1 && sl[1].valid) {
      const MomAdjSlot<T>& c = sl[1];
      const size_t p = lev + c.q;
      L.ru = a.u[p], L.rv = a.v[p], L.rmW = a.maskW[p], L.rmS = a.maskS[p];
      L.rHW = a.hFacW[p], L.rHS = a.hFacS[p];
      if (c.inner) {
        L.rrhW = a.recip_hFacW[p], L.rrhS = a.recip_hFacS[p];
        L.rgU = a.gU[p], L.rgV = a.gV[p];
        L.rgD = a.guDiss[p], L.rgvD = a.gvDiss[p];
      }
      if (c.sw >= 0 && !deep) {
        L.rw1 = a.w[p + plane];
        L.rmC1 = a.maskC[p + plane];
      }
    }
    if (ev && (task == 0 || task == 2)) L.eHC = a.hFacC[lev + eq];
    return L;
  };

  MomAdjLevel<T> cur = load(0);
  for (int k = 0; k < nr; ++k) {
    const bool deep = k == nr - 1;
    const T drF = a.drF[k];
    const size_t lev = static_cast<size_t>(k) * plane;

    // the own column's dmask, u and v at level k-1
    const T dmask0 = sl[0].mC - sl[0].mCp;
    const T uPown = sl[0].u, vPown = sl[0].v;

    // ---- stage level k ----
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n >= nslots) break;
      MomAdjSlot<T>& c = sl[n];
      T uu, vv, hw, hs, mw, ms, aU, aV, dU, dV, cU, cV, w1, mC1;
      if (n == 0) {
        uu = u0, vv = v0, hw = cur.hW, hs = cur.hS, mw = mW0, ms = mS0;
        aU = aU0, aV = aV0, dU = dU0, dV = dV0;
        cU = gU0 * mW0, cV = gV0 * mS0;
        w1 = cur.w1, mC1 = cur.mC1;
      } else {
        uu = cur.ru, vv = cur.rv, hw = cur.rHW, hs = cur.rHS;
        mw = cur.rmW, ms = cur.rmS;
        aU = cot(c.inner, k, cur.rrhW, cur.rgU, mw, c.rrAw);
        aV = cot(c.inner, k, cur.rrhS, cur.rgV, ms, c.rrAs);
        dU = cot(c.inner, k, cur.rrhW, cur.rgD, mw, c.rrAw);
        dV = cot(c.inner, k, cur.rrhS, cur.rgvD, ms, c.rrAs);
        cU = cur.rgU * mw, cV = cur.rgV * ms;
        w1 = cur.rw1, mC1 = cur.rmC1;
      }
      s.u[c.r] = uu;
      s.v[c.r] = vv;
      s.uT[c.r] = uu * (c.dyG * drF * hw);
      s.vT[c.r] = vv * (c.dxG * drF * hs);
      s.hW[c.r] = hw;
      s.hS[c.r] = hs;
      s.mW[c.r] = mw;
      s.mS[c.r] = ms;
      s.aU[c.r] = aU;
      s.aV[c.r] = aV;
      s.dU[c.r] = dU;
      s.dV[c.r] = dV;
      s.cu[c.r] = cU * c.fu;
      s.cv[c.r] = cV * c.fv;
      s.uP[c.r] = c.u;
      s.vP[c.r] = c.v;
      s.FvU[c.r] = (c.aU - aU) * rkSign;
      s.FvV[c.r] = (c.aV - aV) * rkSign;
      c.aU = aU, c.aV = aV, c.dU = dU, c.dV = dV, c.u = uu, c.v = vv;
      if (c.sw >= 0) {
        const T wrA = c.w * c.rA;
        s.wrA[c.sw] = wrA;
        s.wd[c.sw] = wrA * (c.mC - c.mCp);
        s.wrA1[c.sw] = w1 * c.rA;
        c.mCp = c.mC;
        c.w = w1, c.mC = mC1;
      }
    }
    // the next level's loads, in flight while this level is computed
    MomAdjLevel<T> nxt;
    if (!deep) nxt = load(k + 1);
    __syncthreads();

    // ---- hFacZ, the face cotangents and viscous products ----
    auto hfacz = [&](int c) -> T {
      const T mW = s.mW[c], mWs = s.mW[c - kRX];
      const T mS = s.mS[c], mSw = s.mS[c - 1];
      const T openJ = tmin(s.hW[c], s.hW[c - kRX]) * mW * mWs;
      const T openI = tmin(s.hS[c], s.hS[c - 1]) * mS * mSw;
      return tmin(openI, openJ) * mW * mWs;
    };
    // ZU, MU, ZV, MV: the coefficients of the viscous fluxes
    auto ZU = [&](T h, T dy, T rdx, T cf) {
      return dy * drF * h * rdx * nAhD * cf;
    };
    auto MU = [&](T h, T dx, T rdy) { return dx * drF * h * rdy * nAhZ; };
    auto ZV = [&](T h, T dy, T rdx, T cf) {
      return dy * drF * h * rdx * nAhZ * cf;
    };
    auto MV = [&](T h, T dx, T rdy) { return dx * drF * h * rdy * nAhD; };
    const int o = rg(ty + 1, tx + 1), ow = (ty + 1) * kAdjSWX + tx + 1;
    const T hZ = hfacz(o);
    s.hFacZ[ty][tx] = hZ;
    s.FzU[ty][tx + 1] = s.aU[o] - s.aU[o + 1];
    s.PzU[ty][tx + 1] = (s.dU[o] - s.dU[o + 1]) * ZU(cur.hC, dyF, rdxF, cosU);
    s.FmU[ty][tx] = s.aU[o - kRX] - s.aU[o];
    s.PmU[ty][tx] = (s.dU[o - kRX] - s.dU[o]) * MU(hZ, dxV, rdyU);
    s.FzV[ty][tx] = s.aV[o - 1] - s.aV[o];
    s.PzV[ty][tx] = (s.dV[o - 1] - s.dV[o]) * ZV(hZ, dyU, rdxV, cosV);
    s.FmV[ty + 1][tx] = s.aV[o] - s.aV[o + kRX];
    s.PmV[ty + 1][tx] = (s.dV[o] - s.dV[o + kRX]) * MV(cur.hC, dxF, rdyF);
    const int ec = rg(ey, ex);
    if (task == 0) {
      s.FmV[0][tx] = s.aV[ec] - s.aV[ec + kRX];
      s.PmV[0][tx] = (s.dV[ec] - s.dV[ec + kRX]) * MV(cur.eHC, e0, e1);
    } else if (task == 1) {
      const T h = hfacz(ec);
      s.hFacZ[kTY][tx] = h;
      s.FmU[kTY][tx] = s.aU[ec - kRX] - s.aU[ec];
      s.PmU[kTY][tx] = (s.dU[ec - kRX] - s.dU[ec]) * MU(h, e0, e1);
      s.FzV[kTY][tx] = s.aV[ec - 1] - s.aV[ec];
    } else if (task == 2) {
      s.FzU[tx][0] = s.aU[ec] - s.aU[ec + 1];
      s.PzU[tx][0] = (s.dU[ec] - s.dU[ec + 1]) * ZU(cur.eHC, e0, e1, e2);
    } else if (task == 3) {
      const T h = hfacz(ec);
      s.hFacZ[tx][kTX] = h;
      s.FmU[tx][kTX] = s.aU[ec - kRX] - s.aU[ec];
      s.FzV[tx][kTX] = s.aV[ec - 1] - s.aV[ec];
      s.PzV[tx][kTX] = (s.dV[ec - 1] - s.dV[ec]) * ZV(h, e0, e1, e2);
    }

    // the own column at interface k+1: its cotangents at level k+1 and the
    // vertical flux cotangents and coefficients there
    const bool in1 = oin && !deep;
    const T aU1 = in1 ? cot(true, k + 1, cur.rhW1, cur.gU1, cur.mW1, rrAw0)
                      : T(0);
    const T aV1 = in1 ? cot(true, k + 1, cur.rhS1, cur.gV1, cur.mS1, rrAs0)
                      : T(0);
    const T dU1 = in1 ? cot(true, k + 1, cur.rhW1, cur.gD1, cur.mW1, rrAw0)
                      : T(0);
    const T dV1 = in1 ? cot(true, k + 1, cur.rhS1, cur.gvD1, cur.mS1, rrAs0)
                      : T(0);
    const T FvU1 = (aU0 - aU1) * rkSign, FvV1 = (aV0 - aV1) * rkSign;
    const T RvU1 = (dU0 - dU1) * rkSign, RvV1 = (dV0 - dV1) * rkSign;
    T RU1 = 0, RV1 = 0;
    if (!deep) {
      const T rdrC = a.recip_drC[k + 1];
      RU1 = -cur.kRU1 * rAw * rkSign * rdrC * cur.mW1 * mW0;
      RV1 = -cur.kRV1 * rAs * rkSign * rdrC * cur.mS1 * mS0;
    }
    __syncthreads();

    // ---- the own cell's sums ----
    if (active) {
      const T rdrF = a.recip_drF[k];
      const T hW0 = cur.hW, hS0 = cur.hS;
      // the partials of the vertical advective fluxes at interfaces k and
      // k+1 by u(k) and v(k)
      const T rTrU = T(0.5) * (s.wrA[ow] + s.wrA[ow - 1]);
      const T rTrV = T(0.5) * (s.wrA[ow] + s.wrA[ow - kAdjSWX]);
      const T dVerU =
          k == 0 ? rTrU : rTrU * T(0.5) + T(0.25) * (s.wd[ow] + s.wd[ow - 1]);
      const T dVerV = k == 0 ? rTrV
                             : rTrV * T(0.5) +
                                   T(0.25) * (s.wd[ow] + s.wd[ow - kAdjSWX]);
      const T dVerU1 = T(0.5) * (s.wrA1[ow] + s.wrA1[ow - 1]) * T(0.5);
      const T dVerV1 = T(0.5) * (s.wrA1[ow] + s.wrA1[ow - kAdjSWX]) * T(0.5);
      const T FvU0 = s.FvU[o], FvV0 = s.FvV[o];

      // ------------------------------ u_bar ------------------------------
      T ub = T(0);
      const T xA = sl[0].dyG * drF * hW0;
      // advection: fZonU at i (u(i) as its own) and at i-1 (u(i) as its
      // i+1); fMerU at j and j+1 read vTrans; fZonV at j and j+1 read
      // uTrans(j, i); fVerU at interfaces k and k+1
      if (zonU(j, i))
        ub = ub + s.FzU[ty][tx + 1] *
                      (q25 * (xA * (s.u[o] + s.u[o + 1]) +
                              (s.uT[o] + s.uT[o + 1])));
      if (zonU(j, i - 1))
        ub = ub + s.FzU[ty][tx] *
                      (q25 * (xA * (s.u[o - 1] + s.u[o]) +
                              (s.uT[o - 1] + s.uT[o])));
      if (merU(j, i))
        ub = ub + s.FmU[ty][tx] * (q25 * (s.vT[o] + s.vT[o - 1]));
      if (merU(j + 1, i))
        ub = ub + s.FmU[ty + 1][tx] *
                      (q25 * (s.vT[o + kRX] + s.vT[o + kRX - 1]));
      if (zonV(j, i))
        ub = ub + s.FzV[ty][tx] * (q25 * xA * (s.v[o] + s.v[o - 1]));
      if (zonV(j + 1, i))
        ub = ub + s.FzV[ty + 1][tx] *
                      (q25 * xA * (s.v[o + kRX] + s.v[o + kRX - 1]));
      if (oin) ub = ub + FvU0 * dVerU;
      if (in1) ub = ub + FvU1 * dVerU1;
      // Coriolis vCf of the cells (j, i-1), (j, i), (j+1, i-1), (j+1, i)
      if (in(j, i - 1)) ub = ub + s.cv[o - 1];
      if (in(j, i)) ub = ub + s.cv[o];
      if (in(j + 1, i - 1)) ub = ub + s.cv[o + kRX - 1];
      if (in(j + 1, i)) ub = ub + s.cv[o + kRX];
      // harmonic and vertical viscous fluxes
      if (zonU(j, i)) ub = ub - s.PzU[ty][tx + 1];
      if (zonU(j, i - 1)) ub = ub + s.PzU[ty][tx];
      if (merU(j, i)) ub = ub + s.PmU[ty][tx];
      if (merU(j + 1, i)) ub = ub - s.PmU[ty + 1][tx];
      if (k > 0 && oin) ub = ub + RvU0 * RU0;
      if (in1) ub = ub - RvU1 * RU1;

      // ------------------------------ v_bar ------------------------------
      T vb = T(0);
      const T yA = sl[0].dxG * drF * hS0;
      if (merU(j, i))
        vb = vb + s.FmU[ty][tx] * (q25 * yA * (s.u[o] + s.u[o - kRX]));
      if (merU(j, i + 1))
        vb = vb + s.FmU[ty][tx + 1] *
                      (q25 * yA * (s.u[o + 1] + s.u[o - kRX + 1]));
      if (zonV(j, i))
        vb = vb + s.FzV[ty][tx] * (q25 * (s.uT[o] + s.uT[o - kRX]));
      if (zonV(j, i + 1))
        vb = vb + s.FzV[ty][tx + 1] *
                      (q25 * (s.uT[o + 1] + s.uT[o - kRX + 1]));
      if (merV(j, i))
        vb = vb + s.FmV[ty + 1][tx] *
                      (q25 * (yA * (s.v[o] + s.v[o + kRX]) +
                              (s.vT[o] + s.vT[o + kRX])));
      if (merV(j - 1, i))
        vb = vb + s.FmV[ty][tx] *
                      (q25 * (yA * (s.v[o - kRX] + s.v[o]) +
                              (s.vT[o - kRX] + s.vT[o])));
      if (oin) vb = vb + FvV0 * dVerV;
      if (in1) vb = vb + FvV1 * dVerV1;
      // Coriolis uCf of the cells (j-1, i), (j-1, i+1), (j, i), (j, i+1)
      if (in(j - 1, i)) vb = vb + s.cu[o - kRX];
      if (in(j - 1, i + 1)) vb = vb + s.cu[o - kRX + 1];
      if (in(j, i)) vb = vb + s.cu[o];
      if (in(j, i + 1)) vb = vb + s.cu[o + 1];
      if (zonV(j, i)) vb = vb + s.PzV[ty][tx];
      if (zonV(j, i + 1)) vb = vb - s.PzV[ty][tx + 1];
      if (merV(j, i)) vb = vb - s.PmV[ty + 1][tx];
      if (merV(j - 1, i)) vb = vb + s.PmV[ty][tx];
      if (k > 0 && oin) vb = vb + RvV0 * RV0;
      if (in1) vb = vb - RvV1 * RV1;

      // ---- the cell's own side and bottom drag, linear in u and v ----
      if (oin) {
        const T dragU =
            -(rhW0 * rdrF * rrAw0 *
              ((hW0 - hZ) * dxV * rdyU +
               (hW0 - s.hFacZ[ty + 1][tx]) * dxVn * rdyUn) *
              viscAhZ * drF * sideDragFactor);
        const T dragV =
            -(rhS0 * rdrF * rrAs0 *
              ((hS0 - hZ) * dyU * rdxV +
               (hS0 - s.hFacZ[ty][tx + 1]) * dyUe * rdxVe) *
              viscAhZ * cosV * drF * sideDragFactor);
        const T recDr = deep ? a.recip_drF[nr - 1] : a.recip_drC[k + 1];
        const T bottomW = mW0 * (deep ? T(1) : T(1) - cur.mW1);
        const T bottomS = mS0 * (deep ? T(1) : T(1) - cur.mS1);
        const T botU =
            -(cur.kRU1 * recDr * T(2)) * bottomW * rhW0 * rdrF;
        const T botV =
            -(cur.kRV1 * recDr * T(2)) * bottomS * rhS0 * rdrF;
        ub = ub + (gD0 * mW0) * (dragU + botU);
        vb = vb + (gvD0 * mS0) * (dragV + botV);
      }

      // ------------------------------ w_bar ------------------------------
      // fVerU at (j, i) and (j, i+1) and fVerV at (j, i) and (j+1, i)
      // average w(k, j, i) into their rTrans
      auto dVer_w = [&](T vel, T velkm1) -> T {
        if (k == 0) return T(0.5) * rA * vel;
        return T(0.5) * rA * T(0.5) * (vel + velkm1) +
               T(0.25) * rA * dmask0 * vel;
      };
      T wb = T(0);
      if (oin) {
        wb = wb + FvU0 * dVer_w(u0, k > 0 ? uPown : T(0));
        wb = wb + FvV0 * dVer_w(v0, k > 0 ? vPown : T(0));
      }
      if (in(j, i + 1))
        wb = wb + s.FvU[o + 1] *
                      dVer_w(s.u[o + 1], k > 0 ? s.uP[o + 1] : T(0));
      if (in(j + 1, i))
        wb = wb + s.FvV[o + kRX] *
                      dVer_w(s.v[o + kRX], k > 0 ? s.vP[o + kRX] : T(0));

      const size_t p = lev + q;
      b.u_bar[p] = ub;
      b.v_bar[p] = vb;
      b.w_bar[p] = wb;
    }
    __syncthreads();
    aU0 = aU1, aV0 = aV1, dU0 = dU1, dV0 = dV1;
    RvU0 = RvU1, RvV0 = RvV1, RU0 = RU1, RV0 = RV1;
    u0 = cur.u1, v0 = cur.v1, mW0 = cur.mW1, mS0 = cur.mS1;
    rhW0 = cur.rhW1, rhS0 = cur.rhS1;
    gU0 = cur.gU1, gV0 = cur.gV1, gD0 = cur.gD1, gvD0 = cur.gvD1;
    cur = nxt;
  }
}

// Kernel B''s launch from its entry point's arguments: the table's check
// and the grid (the tiles over the output region, then the halo blocks);
// start(kernel, grid, block, args...) starts it (OnStream on the card).
template <typename T, typename Start>
int launch_mom_adj(const void* const* table, int n, int nr, int ny, int nx,
                   int oly, int olx, double viscAhD, double viscAhZ,
                   double sideDragFactor, double rkSign, Start start) {
  static_assert(sizeof(MomAdjArgs<T>) == kMomAdjNumPointers * sizeof(void*),
                "MomAdjArgs must be a plain table of pointers");
  if (n != kMomAdjNumPointers || nr < 1 || ny < 1 || nx < 1 || oly < 1 ||
      olx < 1)
    return (int)cudaErrorInvalidValue;
  MomAdjArgs<T> b;
  std::memcpy(&b, table, sizeof(b));
  const TileGrid tg = tile_grid(nr, ny + 2, nx + 2, oly - 1, olx - 1);
  start(mom_fluxform_adj_kernel<T>, dim3(tg.tiles + tg.halo_blocks),
        dim3(kTX, kTY), b, nr, ny, nx, oly, olx, tg.ntx, tg.tiles,
        T(viscAhD), T(viscAhZ), T(sideDragFactor), T(rkSign));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
