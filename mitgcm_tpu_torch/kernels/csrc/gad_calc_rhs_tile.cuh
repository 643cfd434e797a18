// Kernel C's forward kernel: column-walking tiles (tile.cuh) that compute
// each face flux once, and its launch. Included by gad_calc_rhs.cu, whose
// entry points start it on the card, and by the host check of the tests,
// which runs it on the CPU.
//
// A block owns kTX x kTY columns and walks k from the surface down. Per
// level it stages the tracer over the tile and its ring (with GM also the
// level below, for dT/dx and dT/dy at the next interface, and GM_ExtraDiag's
// up and dn per column); then each thread computes fZon and fMer at its
// west and south faces, two warps the east column's and north row's, into
// shared memory with the transports the divergence needs, and each cell
// takes the differences in the order kernel C always took them. fVer at
// the cell's lower interface uses only the own column: it stays in a
// register as the next level's upper-interface flux, as do the tracer and
// maskC down the column, rTrans, and GM's dT/dx and dT/dy of the level.
// Each ring cell's thread carries its tracer down the column the same way,
// so the tracer is read once. 2-D metrics are read once per column. Each
// level's global loads (GadLevel) are issued before the level above is
// computed. Two barriers a level. Every value is produced by the
// expression of the JAX code (and of the plain twin, model/gad.py:
// _calc_rhs_plain with gmredi.py:xy_flux and r_flux) on the same operands
// in the same order, so with --fmad=false gTr is the twin's bit for bit.
#pragma once

#include <cstring>

#include "gad_calc_rhs.cuh"
#include "tile.cuh"

namespace mitgcm {

template <typename T, bool GM>
struct GadTileShared {
  // the tracer at level k over the region; with GM at level k+1, and
  // GM_ExtraDiag's up and dn at level k
  T t[kRegion], tn[GM ? kRegion : 1], up[GM ? kRegion : 1],
      dn[GM ? kRegion : 1];
  // fZon and uTrans at the west face of [row][column], one column more
  // than the tile; fMer and vTrans at the south face, one row more
  T fZon[kTY][kTX + 1], uT[kTY][kTX + 1];
  T fMer[kTY + 1][kTX], vT[kTY + 1][kTX];
};

// a cell the block stages each level: the thread's own column, or its ring
// cell; it carries the tracer and maskC of the level above (m), this level
// (c) and the level below (n)
template <typename T>
struct GadSlot {
  int r = 0;
  bool valid = false;
  size_t q = 0;
  T tc = T(0), tn = T(0), mc = T(0), mn = T(0);
};

// the global loads of level k, issued while level k-1 is computed
template <typename T>
struct GadLevel {
  // the tracer and maskC at level k+1 of each slot's column
  T tn[2] = {T(0), T(0)}, mn[2] = {T(0), T(0)};
  // the own column: its faces and recip_hFacC at level k, its lower
  // interface (k+1)
  T rhC = T(0), uT = T(0), xA = T(0), vT = T(0), yA = T(0), Kux = T(0),
    Kvy = T(0), Kuz = T(0), Kvz = T(0);
  T rT1 = T(0), kR1 = T(0), mUp1 = T(0), df1 = T(0), Kwx1 = T(0),
    Kwy1 = T(0), mW1 = T(0), mWe1 = T(0), mS1 = T(0), mSn1 = T(0);
  // the ring face of the north row or east column at level k
  T eTr = T(0), eA = T(0), eK = T(0), eKz = T(0);
};

template <typename T, bool GM>
__global__ void __launch_bounds__(kTileThreads)
    calc_rhs_c2_kernel(const GadArgs<T> a, int nr, int ny, int nx, int oly,
                       int olx, int ntx, int tiles, T diffKh, T rkSign,
                       bool implicitDiffusion, bool calcAdvection,
                       const T* df, const GmArgs<T> g, T KuxVal, T KvyVal) {
  const int nyp = ny + 2 * oly, nxp = nx + 2 * olx;
  const size_t plane = static_cast<size_t>(nyp) * nxp;
  int j0, i0;
  if (!tile_origin(ntx, tiles, oly, olx, j0, i0)) {
    T* const outs[1] = {a.gTr};
    zero_halo(outs, nr, ny, nx, oly, olx, blockIdx.x - tiles,
              gridDim.x - tiles);
    return;
  }
  __shared__ GadTileShared<T, GM> s;
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * kTX + tx;
  const int j = j0 + ty, i = i0 + tx;
  const bool own = j < nyp && i < nxp;
  const bool active = j < oly + ny && i < olx + nx;
  const size_t q = own ? static_cast<size_t>(j) * nxp + i : 0;
  const bool extraDiag = GM && g.Kuz != nullptr;

  // the staging slots: 0 the own column, 1 the ring cell (threads < kRing)
  GadSlot<T> sl[2];
  const int nslots = t < kRing ? 2 : 1;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    if (n >= nslots) break;
    int ry = ty + 1, rx = tx + 1;
    if (n == 1) ring_cell(t, ry, rx);
    GadSlot<T>& c = sl[n];
    const int cj = j0 - 1 + ry, ci = i0 - 1 + rx;
    c.r = rg(ry, rx);
    c.valid = cj < nyp && ci < nxp;
    if (c.valid) {
      c.q = static_cast<size_t>(cj) * nxp + ci;
      c.tn = a.tracer[c.q];
      if ((n == 0 && calcAdvection) || extraDiag) c.mn = a.maskC[c.q];
    }
  }

  // the own column's 2-D metrics
  T rA = 0, rrA = 0, mIn = 0, rdxC = 0, cosU = 0, rdyC = 0, rdxCe = 0,
    rdyCn = 0;
  if (own) {
    rrA = a.recip_rA[q], mIn = a.maskInC[q];
    if (!implicitDiffusion || GM) rA = a.rA[q];   // the vertical fluxes
    rdxC = a.recip_dxC[q], cosU = a.cosFacU[q], rdyC = a.recip_dyC[q];
  }
  if (GM && active) rdxCe = a.recip_dxC[q + 1], rdyCn = a.recip_dyC[q + nxp];

  // the ring's faces: warp 0 the north row's fMer, warp 1 the east
  // column's fZon
  int task = -1, ey = 0, ex = 0;
  if (ty == 0) {
    task = 0, ey = kTY + 1, ex = tx + 1;
  } else if (ty == 1 && tx < kTY) {
    task = 1, ey = tx + 1, ex = kTX + 1;
  }
  const int ej = j0 - 1 + ey, ei = i0 - 1 + ex;
  const bool ev = task >= 0 && ej < nyp && ei < nxp;
  const size_t eq = ev ? static_cast<size_t>(ej) * nxp + ei : 0;
  T eRd = 0, eCos = 0;
  if (ev) {
    if (task == 0) {
      eRd = a.recip_dyC[eq];
    } else {
      eRd = a.recip_dxC[eq], eCos = a.cosFacU[eq];
    }
  }

  // fVer at the surface: 0, or df there; and rTrans(0)
  T fVer0 = (df && own) ? df[q] : T(0);
  T rT0 = own ? a.rTrans[q] : T(0);
  T dTdx0 = 0, dTdy0 = 0;   // GM: dT/dx and dT/dy at level k

  // GM's maskW and maskS at level 0 (dT/dx, dT/dy at the first interface)
  T gmW = 0, gmWe = 0, gmS = 0, gmSn = 0;
  if (GM && active) {
    gmW = g.maskW[q], gmS = g.maskS[q];
    gmWe = g.maskW[q + 1], gmSn = g.maskS[q + nxp];
  }

  auto load = [&](int k) {
    GadLevel<T> L;
    const bool last = k == nr - 1;
    const size_t lev = static_cast<size_t>(k) * plane;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n >= nslots) break;
      if (sl[n].valid && !last) {
        L.tn[n] = a.tracer[lev + plane + sl[n].q];
        // maskC for the advective flux above the bottom level, and for
        // GM_ExtraDiag's up and dn
        if (extraDiag || (n == 0 && calcAdvection && k + 1 < nr - 1))
          L.mn[n] = a.maskC[lev + plane + sl[n].q];
      }
    }
    L.Kux = KuxVal, L.Kvy = KvyVal;
    if (own) {
      const size_t p = lev + q;
      L.rhC = a.recip_hFacC[p];
      L.uT = a.uTrans[p], L.xA = a.xA[p], L.vT = a.vTrans[p], L.yA = a.yA[p];
      if (GM) {
        if (g.Kux) L.Kux = g.Kux[p], L.Kvy = g.Kvy[p];
        if (extraDiag) L.Kuz = g.Kuz[p], L.Kvz = g.Kvz[p];
      }
      if (!last) {
        const size_t p1 = p + plane;
        L.rT1 = a.rTrans[p1];
        if (!implicitDiffusion) L.kR1 = a.kappaR[p1];
        if (!implicitDiffusion || GM) L.mUp1 = a.maskUp[p1];
        if (df) L.df1 = df[p1];
        if (GM) {
          L.Kwx1 = g.Kwx[p1], L.Kwy1 = g.Kwy[p1];
          L.mW1 = g.maskW[p1], L.mS1 = g.maskS[p1];
          if (active) L.mWe1 = g.maskW[p1 + 1], L.mSn1 = g.maskS[p1 + nxp];
        }
      }
    }
    if (ev) {
      const size_t p = lev + eq;
      if (task == 0) {
        L.eTr = a.vTrans[p], L.eA = a.yA[p], L.eK = KvyVal;
        if (GM && g.Kvy) L.eK = g.Kvy[p];
        if (extraDiag) L.eKz = g.Kvz[p];
      } else {
        L.eTr = a.uTrans[p], L.eA = a.xA[p], L.eK = KuxVal;
        if (GM && g.Kux) L.eK = g.Kux[p];
        if (extraDiag) L.eKz = g.Kuz[p];
      }
    }
    return L;
  };

  GadLevel<T> cur = load(0);
  for (int k = 0; k < nr; ++k) {
    const bool last = k == nr - 1;
    const size_t lev = static_cast<size_t>(k) * plane;

    // ---- stage level k (the tracer carried down each slot's column) ----
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n >= nslots) break;
      GadSlot<T>& c = sl[n];
      const T tm = k > 0 ? c.tc : c.tn, mm = k > 0 ? c.mc : c.mn;
      c.tc = c.tn, c.mc = c.mn;
      if (!last) c.tn = cur.tn[n], c.mn = cur.mn[n];
      s.t[c.r] = c.tc;
      if (GM) {
        s.tn[c.r] = c.tn;
        if (extraDiag) {
          // GM_ExtraDiag's up, maskC(k) maskC(k-1) (T(k-1) - T(k)), and
          // dn, maskC(k) maskC(k+1) maskp1 (T(k) - T(k+1)), the levels
          // clamped to the column
          s.up[c.r] = c.mc * mm * (tm - c.tc);
          s.dn[c.r] = c.mc * c.mn * (last ? T(0) : T(1)) * (c.tc - c.tn);
        }
      }
    }
    // the next level's loads, in flight while this level is computed
    GadLevel<T> nxt;
    if (!last) nxt = load(k + 1);
    const T rhC = cur.rhC, uTo = cur.uT, xAo = cur.xA, vTo = cur.vT,
            yAo = cur.yA, Kux = cur.Kux, Kvy = cur.Kvy, Kuz = cur.Kuz,
            Kvz = cur.Kvz, rT1 = cur.rT1, kR1 = cur.kR1, mUp1 = cur.mUp1,
            df1 = cur.df1, Kwx1 = cur.Kwx1, Kwy1 = cur.Kwy1,
            gmW1 = cur.mW1, gmWe1 = cur.mWe1, gmS1 = cur.mS1,
            gmSn1 = cur.mSn1, eTr = cur.eTr, eA = cur.eA, eK = cur.eK,
            eKz = cur.eKz;
    __syncthreads();

    // ---- the face fluxes at the thread's faces ----
    const T rdrCk = a.recip_drC[k], rdrCk1 = a.recip_drC[k + 1];
    // GM's dT/dz at the face between c and its west or south neighbour
    auto dTdz = [&](int c, int cw) -> T {
      return T(0.5) * (T(0.5) * rdrCk * (s.up[cw] + s.up[c]) +
                       T(0.5) * rdrCk1 * (s.dn[cw] + s.dn[c]));
    };
    // the zonal flux at the west face of region cell c: advection,
    // diffusion, then GM's (gmredi.py:xy_flux)
    auto fZon = [&](int c, T uT, T xA, T rdx, T cf, T K, T Kz) -> T {
      const T tt = s.t[c], tm1 = s.t[c - 1];
      const T adv = calcAdvection ? uT * T(0.5) * (tt + tm1) : T(0);
      const T f = adv - diffKh * xA * rdx * (tt - tm1) * cf;
      if constexpr (GM) {
        const T gx = -(xA * K * rdx * (tt - tm1));
        return f + (extraDiag ? gx - xA * Kz * dTdz(c, c - 1) : gx);
      }
      return f;
    };
    // the meridional flux at the south face
    auto fMer = [&](int c, T vT, T yA, T rdy, T K, T Kz) -> T {
      const T tt = s.t[c], tm1 = s.t[c - kRX];
      const T adv = calcAdvection ? vT * T(0.5) * (tt + tm1) : T(0);
      const T f = adv - diffKh * yA * rdy * (tt - tm1);
      if constexpr (GM) {
        const T gy = -(yA * K * rdy * (tt - tm1));
        return f + (extraDiag ? gy - yA * Kz * dTdz(c, c - kRX) : gy);
      }
      return f;
    };
    const int o = rg(ty + 1, tx + 1);
    s.fZon[ty][tx] = fZon(o, uTo, xAo, rdxC, cosU, Kux, Kuz);
    s.uT[ty][tx] = uTo;
    s.fMer[ty][tx] = fMer(o, vTo, yAo, rdyC, Kvy, Kvz);
    s.vT[ty][tx] = vTo;
    if (task == 0) {
      s.fMer[kTY][tx] = fMer(rg(ey, ex), eTr, eA, eRd, eK, eKz);
      s.vT[kTY][tx] = eTr;
    } else if (task == 1) {
      s.fZon[tx][kTX] = fZon(rg(ey, ex), eTr, eA, eRd, eCos, eK, eKz);
      s.uT[tx][kTX] = eTr;
    }

    // the vertical flux at the own column's lower interface (k+1):
    // advection, explicit diffusion, GM's (gmredi.py:r_flux), then df; zero
    // below the bottom
    T fVer1 = 0;
    if (!last) {
      const T tt = sl[0].tn, tkm1 = sl[0].tc;
      T f = calcAdvection ? sl[0].mc * rT1 * T(0.5) * (tt + tkm1) * mIn
                          : T(0);
      if (!implicitDiffusion)
        f = f + -kR1 * mUp1 * rA * rdrCk1 * (tt - tkm1) * rkSign;
      if constexpr (GM) {
        // GM's dT/dx and dT/dy at levels k and k+1, and its flux
        auto dTdx_at = [&](const T* tr, T mW, T mWe) -> T {
          return T(0.5) * (mWe * rdxCe * (tr[o + 1] - tr[o]) +
                           mW * rdxC * (tr[o] - tr[o - 1]));
        };
        auto dTdy_at = [&](const T* tr, T mS, T mSn) -> T {
          return T(0.5) * (mSn * rdyCn * (tr[o + kRX] - tr[o]) +
                           mS * rdyC * (tr[o] - tr[o - kRX]));
        };
        if (k == 0) {
          dTdx0 = dTdx_at(s.t, gmW, gmWe);
          dTdy0 = dTdy_at(s.t, gmS, gmSn);
        }
        const T dTdx1 = dTdx_at(s.tn, gmW1, gmWe1);
        const T dTdy1 = dTdy_at(s.tn, gmS1, gmSn1);
        const T dTdx = T(0.5) * (dTdx1 + dTdx0);
        const T dTdy = T(0.5) * (dTdy1 + dTdy0);
        f = f + -(rA * mIn * (Kwx1 * dTdx + Kwy1 * dTdy) * mUp1);
        dTdx0 = dTdx1, dTdy0 = dTdy1;
      }
      fVer1 = df ? f + df1 : f;
    }
    __syncthreads();

    // ---- the cell's tendency ----
    if (active) {
      // advFac (gad.py:1104-1109); x * 1 is x, so with advection the sum
      // rounds as the plain divergence does
      const T advFac = calcAdvection ? T(1) : T(0);
      const T rTransKp = last ? T(0) : rT1;
      const T divTrans = (s.uT[ty][tx + 1] - s.uT[ty][tx]) * advFac +
                         (s.vT[ty + 1][tx] - s.vT[ty][tx]) * advFac +
                         (rTransKp - rT0) * (rkSign * advFac);
      a.gTr[lev + q] =
          -(rhC * a.recip_drF[k] * rrA *
            (((s.fZon[ty][tx + 1] - s.fZon[ty][tx]) +
              (s.fMer[ty + 1][tx] - s.fMer[ty][tx])) * mIn +
             (fVer1 - fVer0) * rkSign - sl[0].tc * divTrans * mIn));
    }
    fVer0 = fVer1, rT0 = rT1;
    cur = nxt;
  }
}

// Kernel C's launch from its entry points' arguments: the tables' checks,
// the grid and the variant; gm_table null: kernel C, else its GM branch,
// gm_table the n_gm pointers of GmArgs and KuxVal/KvyVal the constant Kux
// and Kvy where those are null. start(kernel, grid, block, args...) starts
// it (OnStream on the card).
template <typename T, typename Start>
int launch_calc_rhs(const void* const* table, int n, int nr, int ny, int nx,
                    int oly, int olx, double diffKh, double rkSign,
                    int implicitDiffusion, int calcAdvection, const void* df,
                    const void* const* gm_table, int n_gm, double KuxVal,
                    double KvyVal, Start start) {
  static_assert(sizeof(GadArgs<T>) == kGadNumPointers * sizeof(void*),
                "GadArgs must be a plain table of pointers");
  static_assert(sizeof(GmArgs<T>) == kGmNumPointers * sizeof(void*),
                "GmArgs must be a plain table of pointers");
  if (n != kGadNumPointers || (gm_table && n_gm != kGmNumPointers))
    return (int)cudaErrorInvalidValue;
  GadArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  GmArgs<T> gm{};
  if (gm_table) {
    std::memcpy(&gm, gm_table, sizeof(gm));
    if (!gm.Kwx || !gm.Kwy || !gm.maskW || !gm.maskS ||
        (gm.Kux == nullptr) != (gm.Kvy == nullptr) ||
        (gm.Kuz == nullptr) != (gm.Kvz == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  const TileGrid tg = tile_grid(nr, ny, nx, oly, olx);
  auto run = [&](auto kernel, T Kux, T Kvy) {
    start(kernel, dim3(tg.tiles + tg.halo_blocks), dim3(kTX, kTY), a, nr,
          ny, nx, oly, olx, tg.ntx, tg.tiles, T(diffKh), T(rkSign),
          implicitDiffusion != 0, calcAdvection != 0, (const T*)df, gm, Kux,
          Kvy);
  };
  if (gm_table)
    run(calc_rhs_c2_kernel<T, true>, T(KuxVal), T(KvyVal));
  else
    run(calc_rhs_c2_kernel<T, false>, T(0), T(0));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
