// Kernel B's forward kernel: column-walking tiles (tile.cuh) that compute
// each face flux once, and its launch. Included by mom_fluxform.cu, whose
// entry point starts it on the card, and by the host check of the tests,
// which runs it on the CPU.
//
// A block owns kTX x kTY columns and walks k from the surface down. Per
// level it stages u, v, the transports uTrans and vTrans, hFacW, hFacS,
// maskW and maskS over the tile and its ring;
// then each thread computes hFacZ and the eight face fluxes (fZonU, fMerU,
// fZonV, fMerV and the viscous vZonU, vMerU, vZonV, vMerV) at its own
// faces, four warps the ring's faces, into shared memory; each cell takes
// the differences in the order kernel B always took them. The fluxes at the
// cell's lower interface (fVerU/V, rViscU/V) need w rA and its dmask
// product at level k+1 on the south-west ring, staged with level k; they
// stay in registers as the next level's upper-interface fluxes, as do u, v,
// maskW and maskS of the level below and the kappas of the bottom drag.
// 2-D metrics are read once per column into registers. Each level's
// global loads (MomLevel) are issued before the level above is computed, so
// that their latency hides behind its arithmetic. Two barriers a level.
// Every value is produced by the expression of the JAX code (and of the
// plain twin, model/mom_fluxform.py:_mom_fluxform_plain) on the same
// operands in the same order, so with --fmad=false the outputs are the
// twin's bit for bit.
#pragma once

#include <cstring>
#include <type_traits>

#include "mom_fluxform.cuh"
#include "tile.cuh"

namespace mitgcm {

// the tile and its south and west ring: where level k+1's w rA is staged
constexpr int kSWX = kTX + 1;
constexpr int kSW = kSWX * (kTY + 1);

template <typename T, bool Coriolis3d, bool Ext>
struct MomTileShared {
  // level k over the region
  T u[kRegion], v[kRegion], uT[kRegion], vT[kRegion], hW[kRegion],
      hS[kRegion], mW[kRegion], mS[kRegion];
  // level k+1 over the south-west region: w rA and w rA dmask; the 3-D
  // Coriolis term's fCoriCos angleCosC wbar at level k
  T wrA[kSW], wd[kSW], fcw[Coriolis3d ? kSW : 1];
  // the face fluxes of level k: [row][column] of the face's cell, one
  // column (zonal) or row (meridional) more than the tile
  T fZonU[kTY][kTX + 1], vZonU[kTY][kTX + 1], fZonV[kTY][kTX + 1],
      vZonV[kTY][kTX + 1];
  T fMerU[kTY + 1][kTX], vMerU[kTY + 1][kTX], fMerV[kTY + 1][kTX],
      vMerV[kTY + 1][kTX];
  T hFacZ[kTY + 1][kTX + 1];
  // the dissipation variant's fields of level k over the region: X's
  // viscosities (or the constants), Y's Laplacian
  T AhD[Ext ? kRegion : 1], AhZ[Ext ? kRegion : 1], A4D[Ext ? kRegion : 1],
      A4Z[Ext ? kRegion : 1], d2u[Ext ? kRegion : 1], d2v[Ext ? kRegion : 1];
};

// a cell the block stages each level: the thread's own column, or its ring
// cell
template <typename T>
struct MomSlot {
  int r = 0, sw = -1;  // region index; index in the south-west region or -1
  bool valid = false;  // inside the padded array
  size_t q = 0;        // 2-D index
  T dyG = T(0), dxG = T(0), rA = T(0), cc = T(0);
  T w = T(0), mC = T(0);  // w and maskC at the level being staged
};

// the global loads of level k, issued while level k-1 is computed
template <typename T>
struct MomLevel {
  // the own column at level k, and at k+1 (the kappas: k+1 of nr+1)
  T hW = T(0), hS = T(0), hC = T(0), rhW = T(0), rhS = T(0);
  T u1 = T(0), v1 = T(0), mW1 = T(0), mS1 = T(0), kRU1 = T(0), kRV1 = T(0);
  // the ring cell at level k: u, v, maskW, maskS, hFacW, hFacS
  T ru = T(0), rv = T(0), rmW = T(0), rmS = T(0), rHW = T(0), rHS = T(0);
  // w and maskC at level k+1 of the slots in the south-west region
  T w1[2] = {T(0), T(0)}, mC1[2] = {T(0), T(0)};
  // hFacC at level k of the ring face of the south row or west column
  T eHC = T(0);
};

// Ext: the dissipation variant, which reads X's viscosities and Y's
// Laplacian (`va`, each null when not given) and applies the drags of `dp`
// Cd: the CD scheme's variant, without the 2-D Coriolis term (the D-grid
// velocities give it, model/cd_code.py; mom_fluxform.py:410-419)
template <typename T, bool NoSlipSides, bool Coriolis3d, bool Ext, bool Cd>
__global__ void __launch_bounds__(kTileThreads)
    mom_fluxform_kernel(const MomArgs<T> a, int nr, int ny, int nx, int oly,
                        int olx, int ntx, int tiles, T viscAhD, T viscAhZ,
                        T sideDragFactor, T rkSign, T gravitySign,
                        const MomViscArgs<T> va, const MomViscParams<T> dp) {
  const int nyp = ny + 2 * oly, nxp = nx + 2 * olx;
  const size_t plane = static_cast<size_t>(nyp) * nxp;
  int j0, i0;
  if (!tile_origin(ntx, tiles, oly, olx, j0, i0)) {
    T* const outs[4] = {a.gU, a.gV, a.guDiss, a.gvDiss};
    zero_halo(outs, nr, ny, nx, oly, olx, blockIdx.x - tiles,
              gridDim.x - tiles);
    return;
  }
  __shared__ MomTileShared<T, Coriolis3d, Ext> s;
  const bool var = Ext && va.viscAh_D != nullptr;
  const bool var4 = Ext && va.viscA4_D != nullptr;
  const bool bih = Ext && va.del2u != nullptr;
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * kTX + tx;
  const int j = j0 + ty, i = i0 + tx;
  const bool own = j < nyp && i < nxp;
  const bool active = j < oly + ny && i < olx + nx;
  const size_t q = own ? static_cast<size_t>(j) * nxp + i : 0;
  const T nAhD = -viscAhD, nAhZ = -viscAhZ;

  // the staging slots: 0 the own column, 1 the ring cell (threads < kRing)
  MomSlot<T> sl[2];
  const int nslots = t < kRing ? 2 : 1;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    if (n >= nslots) break;
    int ry = ty + 1, rx = tx + 1;
    if (n == 1) ring_cell(t, ry, rx);
    MomSlot<T>& c = sl[n];
    const int cj = j0 - 1 + ry, ci = i0 - 1 + rx;
    c.r = rg(ry, rx);
    c.valid = cj < nyp && ci < nxp;
    if (ry <= kTY && rx <= kTX) c.sw = ry * kSWX + rx;
    if (c.valid) {
      c.q = static_cast<size_t>(cj) * nxp + ci;
      c.dyG = a.dyG[c.q];
      c.dxG = a.dxG[c.q];
      if (c.sw >= 0) {
        c.rA = a.rA[c.q];
        if (Coriolis3d) c.cc = a.fCoriCos[c.q] * a.angleCosC[c.q];
      }
    }
  }

  // the own column's 2-D metrics
  T rrAw = 0, rrAs = 0, rAw = 0, rAs = 0, cU = 0, cV = 0, dyF = 0, rdxF = 0,
    cosU = 0, dxV = 0, rdyU = 0, dyU = 0, rdxV = 0, cosV = 0, dxF = 0,
    rdyF = 0, dxVn = 0, rdyUn = 0, dyUe = 0, rdxVe = 0;
  if (own) {
    rrAw = a.recip_rAw[q];
    rrAs = a.recip_rAs[q];
    rAw = a.rAw[q];
    rAs = a.rAs[q];
    const T fC = a.fCori[q];
    cU = T(0.5) * (fC + a.fCori[q - 1]) * T(0.25);
    cV = T(-0.5) * (fC + a.fCori[q - nxp]) * T(0.25);
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
  if (NoSlipSides && active) {
    dxVn = a.dxV[q + nxp];
    rdyUn = a.recip_dyU[q + nxp];
    dyUe = a.dyU[q + 1];
    rdxVe = a.recip_dxV[q + 1];
  }

  // the ring's faces, a task per warp: 0 the south row's meridional V
  // fluxes, 1 the north row's meridional U fluxes (and hFacZ), 2 the west
  // column's zonal U fluxes, 3 the east column's zonal V fluxes (and hFacZ)
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
  const bool ev = task >= 0 && ej < nyp && ei < nxp;
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

  // level 0: the own column's u, v, maskW, maskS, and the surface fluxes
  T u0 = 0, v0 = 0, mW0 = 0, mS0 = 0;
  if (own) {
    u0 = a.u[q], v0 = a.v[q], mW0 = a.maskW[q], mS0 = a.maskS[q];
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    if (n >= nslots) break;
    MomSlot<T>& c = sl[n];
    if (c.sw < 0) continue;
    if (c.valid) c.w = a.w[c.q], c.mC = a.maskC[c.q];
    s.wrA[c.sw] = c.w * c.rA;
  }
  __syncthreads();
  const int o = rg(ty + 1, tx + 1), ow = (ty + 1) * kSWX + tx + 1;
  // fVerU/V at the surface: rTrans u(0)
  T fVerU0 = T(0.5) * (s.wrA[ow] + s.wrA[ow - 1]) * u0;
  T fVerV0 = T(0.5) * (s.wrA[ow] + s.wrA[ow - kSWX]) * v0;
  T rViscU0 = 0, rViscV0 = 0;
  __syncthreads();

  auto load = [&](int k) {
    MomLevel<T> L;
    const size_t lev = static_cast<size_t>(k) * plane;
    const bool deep = k == nr - 1;
    if (own) {
      const size_t p = lev + q;
      L.hW = a.hFacW[p], L.hS = a.hFacS[p], L.hC = a.hFacC[p];
      L.rhW = a.recip_hFacW[p], L.rhS = a.recip_hFacS[p];
      L.kRU1 = a.kappaRU[p + plane], L.kRV1 = a.kappaRV[p + plane];
      if (!deep) {
        L.u1 = a.u[p + plane], L.v1 = a.v[p + plane];
        L.mW1 = a.maskW[p + plane], L.mS1 = a.maskS[p + plane];
      }
    }
    if (nslots > 1 && sl[1].valid) {
      const size_t p = lev + sl[1].q;
      L.ru = a.u[p], L.rv = a.v[p], L.rmW = a.maskW[p], L.rmS = a.maskS[p];
      L.rHW = a.hFacW[p], L.rHS = a.hFacS[p];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n >= nslots) break;
      if (sl[n].sw >= 0 && sl[n].valid && !deep) {
        L.w1[n] = a.w[lev + plane + sl[n].q];
        L.mC1[n] = a.maskC[lev + plane + sl[n].q];
      }
    }
    if (ev && (task == 0 || task == 2)) L.eHC = a.hFacC[lev + eq];
    return L;
  };

  MomLevel<T> cur = load(0);
  for (int k = 0; k < nr; ++k) {
    const bool deep = k == nr - 1;
    const T drF = a.drF[k];
    const size_t lev = static_cast<size_t>(k) * plane;

    // ---- stage level k, and w rA at level k+1 ----
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n >= nslots) break;
      MomSlot<T>& c = sl[n];
      const T uu = n == 0 ? u0 : cur.ru, vv = n == 0 ? v0 : cur.rv;
      const T hw = n == 0 ? cur.hW : cur.rHW;
      const T hs = n == 0 ? cur.hS : cur.rHS;
      s.u[c.r] = uu;
      s.v[c.r] = vv;
      s.uT[c.r] = uu * (c.dyG * drF * hw);
      s.vT[c.r] = vv * (c.dxG * drF * hs);
      s.hW[c.r] = hw;
      s.hS[c.r] = hs;
      s.mW[c.r] = n == 0 ? mW0 : cur.rmW;
      s.mS[c.r] = n == 0 ? mS0 : cur.rmS;
      if (Ext) {
        const size_t gp = lev + c.q;
        s.AhD[c.r] = var ? (c.valid ? va.viscAh_D[gp] : T(0)) : viscAhD;
        s.AhZ[c.r] = var ? (c.valid ? va.viscAh_Z[gp] : T(0)) : viscAhZ;
        if (bih) {
          s.A4D[c.r] = var4 ? (c.valid ? va.viscA4_D[gp] : T(0))
                            : dp.viscA4D;
          s.A4Z[c.r] = var4 ? (c.valid ? va.viscA4_Z[gp] : T(0))
                            : dp.viscA4Z;
          s.d2u[c.r] = c.valid ? va.del2u[gp] : T(0);
          s.d2v[c.r] = c.valid ? va.del2v[gp] : T(0);
        }
      }
      if (c.sw >= 0) {
        const T w1 = cur.w1[n], mC1 = cur.mC1[n];
        const T wrA1 = w1 * c.rA;
        s.wrA[c.sw] = wrA1;
        s.wd[c.sw] = wrA1 * (mC1 - c.mC);
        if (Coriolis3d)
          s.fcw[c.sw] = c.cc * (T(0.5) * (c.w + (deep ? T(0) : w1)));
        c.w = w1, c.mC = mC1;
      }
    }
    // the next level's loads, in flight while this level is computed
    MomLevel<T> nxt;
    if (!deep) nxt = load(k + 1);
    const T hW0 = cur.hW, hS0 = cur.hS, hC = cur.hC, rhW = cur.rhW,
            rhS = cur.rhS, kRU1 = cur.kRU1, kRV1 = cur.kRV1, u1 = cur.u1,
            v1 = cur.v1, mW1 = cur.mW1, mS1 = cur.mS1, eHC = cur.eHC;
    __syncthreads();

    // ---- hFacZ and the face fluxes at the thread's faces ----
    auto hfacz = [&](int c) -> T {
      const T mW = s.mW[c], mWs = s.mW[c - kRX];
      const T mS = s.mS[c], mSw = s.mS[c - 1];
      const T openJ = tmin(s.hW[c], s.hW[c - kRX]) * mW * mWs;
      const T openI = tmin(s.hS[c], s.hS[c - 1]) * mS * mSw;
      return tmin(openI, openJ) * mW * mWs;
    };
    auto fZonU = [&](int c) -> T {
      return T(0.25) * (s.uT[c] + s.uT[c + 1]) * (s.u[c] + s.u[c + 1]);
    };
    auto fMerU = [&](int c) -> T {
      return T(0.25) * (s.vT[c] + s.vT[c - 1]) * (s.u[c] + s.u[c - kRX]);
    };
    auto fZonV = [&](int c) -> T {
      return T(0.25) * (s.uT[c] + s.uT[c - kRX]) * (s.v[c] + s.v[c - 1]);
    };
    auto fMerV = [&](int c) -> T {
      return T(0.25) * (s.vT[c] + s.vT[c + kRX]) * (s.v[c] + s.v[c + kRX]);
    };
    // the viscous fluxes: harmonic, and under Ext biharmonic, with the
    // viscosities of the face's point
    auto vZonU = [&](int c, T h, T dy, T rdx, T cf) -> T {
      if (!Ext)
        return dy * drF * h * rdx * (nAhD * (s.u[c + 1] - s.u[c]) * cf);
      T f = -s.AhD[c] * (s.u[c + 1] - s.u[c]) * cf;
      if (bih) f = f + s.A4D[c] * (s.d2u[c + 1] - s.d2u[c]) * cf;
      return dy * drF * h * rdx * f;
    };
    auto vMerU = [&](int c, T h, T dx, T rdy) -> T {
      if (!Ext)
        return dx * drF * h * rdy * (nAhZ * (s.u[c] - s.u[c - kRX]));
      T f = -s.AhZ[c] * (s.u[c] - s.u[c - kRX]);
      if (bih) f = f + s.A4Z[c] * (s.d2u[c] - s.d2u[c - kRX]);
      return dx * drF * h * rdy * f;
    };
    auto vZonV = [&](int c, T h, T dy, T rdx, T cf) -> T {
      if (!Ext)
        return dy * drF * h * rdx * (nAhZ * (s.v[c] - s.v[c - 1]) * cf);
      T f = -s.AhZ[c] * (s.v[c] - s.v[c - 1]) * cf;
      if (bih) f = f + s.A4Z[c] * (s.d2v[c] - s.d2v[c - 1]) * cf;
      return dy * drF * h * rdx * f;
    };
    auto vMerV = [&](int c, T h, T dx, T rdy) -> T {
      if (!Ext)
        return dx * drF * h * rdy * (nAhD * (s.v[c + kRX] - s.v[c]));
      T f = -s.AhD[c] * (s.v[c + kRX] - s.v[c]);
      if (bih) f = f + s.A4D[c] * (s.d2v[c + kRX] - s.d2v[c]);
      return dx * drF * h * rdy * f;
    };
    const T hZ = hfacz(o);
    s.hFacZ[ty][tx] = hZ;
    s.fZonU[ty][tx + 1] = fZonU(o);
    s.vZonU[ty][tx + 1] = vZonU(o, hC, dyF, rdxF, cosU);
    s.fMerU[ty][tx] = fMerU(o);
    s.vMerU[ty][tx] = vMerU(o, hZ, dxV, rdyU);
    s.fZonV[ty][tx] = fZonV(o);
    s.vZonV[ty][tx] = vZonV(o, hZ, dyU, rdxV, cosV);
    s.fMerV[ty + 1][tx] = fMerV(o);
    s.vMerV[ty + 1][tx] = vMerV(o, hC, dxF, rdyF);
    const int ec = rg(ey, ex);
    if (task == 0) {
      s.fMerV[0][tx] = fMerV(ec);
      s.vMerV[0][tx] = vMerV(ec, eHC, e0, e1);
    } else if (task == 1) {
      const T h = hfacz(ec);
      s.hFacZ[kTY][tx] = h;
      s.fMerU[kTY][tx] = fMerU(ec);
      s.vMerU[kTY][tx] = vMerU(ec, h, e0, e1);
    } else if (task == 2) {
      s.fZonU[tx][0] = fZonU(ec);
      s.vZonU[tx][0] = vZonU(ec, eHC, e0, e1, e2);
    } else if (task == 3) {
      const T h = hfacz(ec);
      s.hFacZ[tx][kTX] = h;
      s.fZonV[tx][kTX] = fZonV(ec);
      s.vZonV[tx][kTX] = vZonV(ec, h, e0, e1, e2);
    }

    // the lower interface (k+1) of the own column, below the bottom zero
    T fVerU1 = 0, fVerV1 = 0, rViscU1 = 0, rViscV1 = 0;
    if (!deep) {
      const T rTransU = T(0.5) * (s.wrA[ow] + s.wrA[ow - 1]);
      const T rTransV = T(0.5) * (s.wrA[ow] + s.wrA[ow - kSWX]);
      fVerU1 = rTransU * T(0.5) * (u1 + u0) +
               T(0.25) * (s.wd[ow] + s.wd[ow - 1]) * u1;
      fVerV1 = rTransV * T(0.5) * (v1 + v0) +
               T(0.25) * (s.wd[ow] + s.wd[ow - kSWX]) * v1;
      const T rdrC = a.recip_drC[k + 1];
      rViscU1 = -kRU1 * rAw * (u1 - u0) * rkSign * rdrC * mW1 * mW0;
      rViscV1 = -kRV1 * rAs * (v1 - v0) * rkSign * rdrC * mS1 * mS0;
    }
    // Coriolis, scheme 0 (mom_u_coriolis.F), and the 3-D term
    // (mom_u_coriolis_nh.F)
    const T uCf = cU * (s.v[o] + s.v[o + kRX] + s.v[o - 1] + s.v[o + kRX - 1]);
    const T vCf = cV * (s.u[o] + s.u[o + 1] + s.u[o - kRX] + s.u[o - kRX + 1]);
    T cori3 = 0;
    if (Coriolis3d)
      cori3 = T(0.5) * (s.fcw[ow] + s.fcw[ow - 1]) * gravitySign;
    // the dissipation variant's side-drag terms (viscAh_Z, and viscA4_Z
    // times the Laplacian, at each wall's vorticity point) and the
    // quadratic drag's KE sums, read from the staging before the next
    // level's overwrites it
    T eAhu = 0, eAhuN = 0, eAhv = 0, eAhvE = 0, keS = 0, keSv = 0;
    if (Ext) {
      if (NoSlipSides) {
        eAhu = s.AhZ[o] * u0, eAhuN = s.AhZ[o + kRX] * u0;
        eAhv = s.AhZ[o] * v0 * cosV, eAhvE = s.AhZ[o + 1] * v0 * cosV;
        if (bih) {
          const T du = s.d2u[o], dv = s.d2v[o];
          eAhu = eAhu - s.A4Z[o] * du;
          eAhuN = eAhuN - s.A4Z[o + kRX] * du;
          eAhv = eAhv - s.A4Z[o] * dv * cosV;
          eAhvE = eAhvE - s.A4Z[o + 1] * dv * cosV;
        }
      }
      if (dp.drag && dp.bottomDragQuadratic != T(0)) {
        // KE (mom_calc_ke.F, selectKEscheme 0) at the cell and its west
        // and south neighbours
        auto ke = [&](int c) -> T {
          return T(0.25) * ((s.u[c] * s.u[c] + s.u[c + 1] * s.u[c + 1]) +
                            (s.v[c] * s.v[c] + s.v[c + kRX] * s.v[c + kRX]));
        };
        const T ke0 = ke(o);
        keS = ke0 + ke(o - 1), keSv = ke0 + ke(o - kRX);
      }
    }
    __syncthreads();

    // ---- the cell's tendencies ----
    if (active) {
      const T rdrF = a.recip_drF[k];
      // advection (mom_fluxform.F:355-905)
      T gU = -(rhW * rdrF * rrAw *
               ((s.fZonU[ty][tx + 1] - s.fZonU[ty][tx]) +
                (s.fMerU[ty + 1][tx] - s.fMerU[ty][tx]) +
                (fVerU1 - fVerU0) * rkSign));
      T gV = -(rhS * rdrF * rrAs *
               ((s.fZonV[ty][tx + 1] - s.fZonV[ty][tx]) +
                (s.fMerV[ty + 1][tx] - s.fMerV[ty][tx]) +
                (fVerV1 - fVerV0) * rkSign));
      // harmonic viscosity + explicit vertical viscosity
      const T dVrU = (rViscU1 - rViscU0) * rkSign;
      const T dVrV = (rViscV1 - rViscV0) * rkSign;
      T guDiss = -(rhW * rdrF * rrAw *
                   ((s.vZonU[ty][tx + 1] - s.vZonU[ty][tx]) +
                    (s.vMerU[ty + 1][tx] - s.vMerU[ty][tx]) + dVrU));
      T gvDiss = -(rhS * rdrF * rrAs *
                   ((s.vZonV[ty][tx + 1] - s.vZonV[ty][tx]) +
                    (s.vMerV[ty + 1][tx] - s.vMerV[ty][tx]) + dVrV));
      // no-slip side drag (mom_u_sidedrag.F); none under free slip
      if (NoSlipSides) {
        // under Ext, the per-wall terms formed above
        T Ahu = viscAhZ * u0, AhuN = Ahu;
        T Ahv = viscAhZ * v0 * cosV, AhvE = Ahv;
        if (Ext) Ahu = eAhu, AhuN = eAhuN, Ahv = eAhv, AhvE = eAhvE;
        const T uDrag =
            -(rhW * rdrF * rrAw *
              ((hW0 - hZ) * dxV * rdyU * Ahu +
               (hW0 - s.hFacZ[ty + 1][tx]) * dxVn * rdyUn * AhuN) *
              drF * sideDragFactor);
        const T vDrag =
            -(rhS * rdrF * rrAs *
              ((hS0 - hZ) * dyU * rdxV * Ahv +
               (hS0 - s.hFacZ[ty][tx + 1]) * dyUe * rdxVe * AhvE) *
              drF * sideDragFactor);
        guDiss = guDiss + uDrag;
        gvDiss = gvDiss + vDrag;
      }
      // bottom drag (mom_u_botdrag_coeff.F): only where the cell below is
      // dry, or at k = Nr; no-slip, and under Ext linear and quadratic
      const T recDr = deep ? a.recip_drF[nr - 1] : a.recip_drC[k + 1];
      const T bottomW = mW0 * (deep ? T(1) : T(1) - mW1);
      const T bottomS = mS0 * (deep ? T(1) : T(1) - mS1);
      if (!Ext) {
        const T cDragU = kRU1 * recDr * T(2);
        const T cDragV = kRV1 * recDr * T(2);
        guDiss = guDiss - cDragU * bottomW * u0 * rhW * rdrF;
        gvDiss = gvDiss - cDragV * bottomS * v0 * rhS * rdrF;
      } else if (dp.drag) {
        T cDragU = dp.bottomDragLinear, cDragV = dp.bottomDragLinear;
        if (dp.noSlipBottom) {
          cDragU = cDragU + kRU1 * recDr * T(2);
          cDragV = cDragV + kRV1 * recDr * T(2);
        }
        if (dp.bottomDragQuadratic != T(0)) {
          cDragU = cDragU + (keS > T(0) ? dp.bottomDragQuadratic * sqrt(keS)
                                        : T(0));
          cDragV = cDragV + (keSv > T(0)
                                 ? dp.bottomDragQuadratic * sqrt(keSv)
                                 : T(0));
        }
        guDiss = guDiss - cDragU * bottomW * u0 * rhW * rdrF;
        gvDiss = gvDiss - cDragV * bottomS * v0 * rhS * rdrF;
      }
      if (!Cd) {
        gU = gU + uCf;
        gV = gV + vCf;
      }
      if (Coriolis3d) gU = gU + cori3;
      const size_t p = lev + q;
      a.gU[p] = gU * mW0;
      a.gV[p] = gV * mS0;
      a.guDiss[p] = guDiss * mW0;
      a.gvDiss[p] = gvDiss * mS0;
    }
    fVerU0 = fVerU1, fVerV0 = fVerV1, rViscU0 = rViscU1, rViscV0 = rViscV1;
    u0 = u1, v0 = v1, mW0 = mW1, mS0 = mS1;
    cur = nxt;
  }
}

// Kernel B's Coriolis flags (the entry points' `coriolis`): the 3-D term,
// and the CD scheme's variant without the 2-D term
constexpr int kCoriolis3d = 1;
constexpr int kCoriolisCd = 2;

// Kernel B's launch from its entry point's arguments: the table's check,
// the grid, and the variant that the flags pick (ext: the dissipation
// variant, with its second table `va` and numbers `dp`); start(kernel,
// grid, block, args...) starts it (OnStream on the card).
template <typename T, bool Ext, typename Start>
int start_mom(const void* const* table, int n, int nr, int ny, int nx,
              int oly, int olx, int no_slip_sides, int coriolis,
              double viscAhD, double viscAhZ, double sideDragFactor,
              double rkSign, double gravitySign, const MomViscArgs<T>& va,
              const MomViscParams<T>& dp, Start start) {
  static_assert(sizeof(MomArgs<T>) == kMomNumPointers * sizeof(void*),
                "MomArgs must be a plain table of pointers");
  if (n != kMomNumPointers) return (int)cudaErrorInvalidValue;
  MomArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  const TileGrid tg = tile_grid(nr, ny, nx, oly, olx);
  if (coriolis < 0 || coriolis > (kCoriolis3d | kCoriolisCd))
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto kernel) {
    start(kernel, dim3(tg.tiles + tg.halo_blocks), dim3(kTX, kTY), a, nr,
          ny, nx, oly, olx, tg.ntx, tg.tiles, T(viscAhD), T(viscAhZ),
          T(sideDragFactor), T(rkSign), T(gravitySign), va, dp);
  };
  auto by_sides = [&](auto cori3d, auto cd) {
    constexpr bool C3 = decltype(cori3d)::value, CD = decltype(cd)::value;
    if (no_slip_sides)
      run(mom_fluxform_kernel<T, true, C3, Ext, CD>);
    else
      run(mom_fluxform_kernel<T, false, C3, Ext, CD>);
  };
  auto by_cori3d = [&](auto cd) {
    if (coriolis & kCoriolis3d)
      by_sides(std::true_type{}, cd);
    else
      by_sides(std::false_type{}, cd);
  };
  if (coriolis & kCoriolisCd)
    by_cori3d(std::true_type{});
  else
    by_cori3d(std::false_type{});
  return (int)cudaGetLastError();
}

template <typename T, typename Start>
int launch_mom(const void* const* table, int n, int nr, int ny, int nx,
               int oly, int olx, int no_slip_sides, int coriolis,
               double viscAhD, double viscAhZ, double sideDragFactor,
               double rkSign, double gravitySign, Start start) {
  return start_mom<T, false>(table, n, nr, ny, nx, oly, olx, no_slip_sides,
                             coriolis, viscAhD, viscAhZ, sideDragFactor,
                             rkSign, gravitySign, MomViscArgs<T>{},
                             MomViscParams<T>{}, start);
}

// B's dissipation variant: B's arguments, then the table of MomViscArgs
// (the viscosities given in pairs, the Laplacian both or neither, the
// biharmonic viscosities only with it), the numbers of MomViscParams,
// no_slip_bottom and drag
template <typename T, typename Start>
int launch_mom_visc(const void* const* table, int n, int nr, int ny, int nx,
                    int oly, int olx, int no_slip_sides, int coriolis,
                    double viscAhD, double viscAhZ, double sideDragFactor,
                    double rkSign, double gravitySign,
                    const void* const* vtable, int nv, const double* params,
                    int np, int no_slip_bottom, int drag, Start start) {
  static_assert(sizeof(MomViscArgs<T>) == kMomViscNumPointers * sizeof(void*),
                "MomViscArgs must be a plain table of pointers");
  if (nv != kMomViscNumPointers || np != kMomViscNumParams ||
      no_slip_bottom < 0 || no_slip_bottom > 1 || drag < 0 || drag > 1)
    return (int)cudaErrorInvalidValue;
  MomViscArgs<T> va;
  std::memcpy(&va, vtable, sizeof(va));
  const bool bih = va.del2u != nullptr;
  if ((va.viscAh_D == nullptr) != (va.viscAh_Z == nullptr) ||
      (va.viscA4_D == nullptr) != (va.viscA4_Z == nullptr) ||
      (va.del2v == nullptr) == bih || (va.viscA4_D && !bih))
    return (int)cudaErrorInvalidValue;
  const MomViscParams<T> dp{T(params[0]), T(params[1]), T(params[2]),
                            T(params[3]), no_slip_bottom != 0, drag != 0};
  return start_mom<T, true>(table, n, nr, ny, nx, oly, olx, no_slip_sides,
                            coriolis, viscAhD, viscAhZ, sideDragFactor,
                            rkSign, gravitySign, va, dp, start);
}

}  // namespace mitgcm
