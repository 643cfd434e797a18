// Kernel V: column-walking tiles (tile.cuh) that form each vorticity,
// divergence and kinetic energy once, and their launch. Included by
// mom_vecinv.cu, whose entry points start the kernel on the card, and by the
// host check of the tests, which runs it on the CPU.
//
// A block owns kTX x kTY columns and walks k from the surface down. Per
// level:
//  1. it stages u^2, v^2, hFacW, hFacS, maskW, maskS and the products
//     u dyG, v dxG, u dyG hFacW, v dxG hFacS, v dyC and u dxC over the tile
//     and its one-cell ring, corners included (V reaches (j+1, i-1) and
//     (j-1, i+1)), with w rA of level k masked by maskC of level k-1 and
//     w rA of level k+1 over the south-west region;
//  2. each thread forms, at its own column, hFacZ, the relative vorticity
//     (times sideDragFactor where hFacZ is 0), zeta = hFacZ vorticity,
//     1 / hFacZ (vorticity schemes 0 and 2), the divergence and KE into
//     shared memory, four warps the ring's (hFacZ and vorticity on the north
//     row and east column, divergence and KE on the south row and west
//     column), and the terms that read only the staging: the planetary
//     Coriolis term, the transports that the vorticity advection averages
//     and the vertical shear;
//  3. each cell forms its four outputs from those, in the parent's order.
// What a column carries from one level to the next stays in registers: u
// and v of the level above (the shear), maskW and maskS of the level below
// (the bottom drag) and, under explicit viscosity, the interface's viscous
// flux rViscU/V(k+1), which is the next level's rViscU/V(k). The 2-D
// metrics are read once per walk, each thread's own into registers. Each
// level's global loads (VecLevel) are issued before the level above is
// computed. Two barriers a level. The discrete flags are template
// parameters, so each variant carries no branch it does not take.
//
// Every value is produced by the expression of the JAX code (and of the
// plain twin, model/mom_vecinv.py:_mom_vecinv_plain) on the same operands
// in the same order, selects included, so with --fmad=false the outputs are
// the twin's bit for bit. Halo outputs are 0, written by the blocks past
// the tiles.
#pragma once

#include <cstring>
#include <type_traits>

#include "tile.cuh"

namespace mitgcm {

template <typename T>
struct VecinvArgs {
  // [nr, nyp, nxp]
  const T *u, *v, *w, *hFacW, *hFacS, *maskC, *maskW, *maskS, *recip_hFacC,
      *recip_hFacW, *recip_hFacS;
  // [nr+1, nyp, nxp]
  const T *kappaRU, *kappaRV;
  // [nyp, nxp]
  const T *dxC, *dyC, *dxG, *dyG, *dxV, *dyU, *rA, *rAw, *rAs, *recip_dxC,
      *recip_dyC, *recip_dxG, *recip_dyG, *recip_rA, *recip_rAw, *recip_rAs,
      *recip_rAz, *recip_dxV, *recip_dyU, *cosFacU, *cosFacV, *fCoriG;
  // [nr], [nr], [nr+1]
  const T *drF, *recip_drF, *recip_drC;
  // outputs [nr, nyp, nxp]
  T *gU, *gV, *guDiss, *gvDiss;
};
constexpr int kVecinvNumPointers = 42;

// The second table of V's dissipation variant (mom_vecinv_visc), each
// [nr, nyp, nxp] or null: kernel X's viscosities (null: the constants of
// VecViscParams), kernel Y's Laplacian (null: no biharmonic viscosity);
// and dyF, dxF [nyp, nxp] (the strain-tension form's, null else)
template <typename T>
struct VecViscArgs {
  const T *viscAh_D, *viscAh_Z, *viscA4_D, *viscA4_Z, *d2u, *d2v, *dyF,
      *dxF;
};
constexpr int kVecViscNumPointers = 8;

// its numbers: viscAhD and viscAhZ (the strain-tension form's constants;
// the side drag's viscAhZ), viscA4 (the constant biharmonic dissipation's),
// viscA4Z (its side drag's), the quadratic drag coefficient (0 unless
// selectBotDragQuadr is 0); the strain-tension form
template <typename T>
struct VecViscParams {
  T viscAhD, viscAhZ, viscA4, viscA4Z, bottomDragQuadratic;
  bool strainTension;
};
constexpr int kVecViscNumParams = 5;

template <typename T>
__device__ __forceinline__ T vmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }

// wet-point average guard of the schemes 1
constexpr double kEps = 1.0e-9;

// the south-west region (the tile, its south row and west column), where
// w rA is staged
constexpr int kVSWX = kTX + 1;
constexpr int kVSW = kVSWX * (kTY + 1);

template <typename T, bool WithRHz, bool Ext>
struct VecinvShared {
  // level k over the region
  T uu[kRegion], vv[kRegion], hW[kRegion], hS[kRegion], mW[kRegion],
      mS[kRegion], udy[kRegion], vdx[kRegion], uTr[kRegion], vTr[kRegion],
      vdyC[kRegion], udxC[kRegion];
  // the vorticity points of the tile, its north row and east column
  T hFacZ[kRegion], omega[kRegion], zeta[kRegion], rHz[WithRHz ? kRegion : 1];
  // the cell centres of the tile, its south row and west column
  T hDiv[kRegion], KE[kRegion];
  // w rA at level k times maskC at k-1, and w rA at k+1
  T wrAup[kVSW], wrAkp1[kVSW];
  // the dissipation variant's: under biharmonic viscosity the staged
  // Laplacian's products d2u dyG hFacW, d2v dxG hFacS, d2v dyC, d2u dxC
  // (0-3), its divergence dStar at the cell centres (4) and hFacZ times its
  // vorticity zStar at the vorticity points (5); under the strain-tension
  // form the fluxes ft and ft2 at the cell centres (0, 1), fs and fs2 at
  // the vorticity points (2, 3)
  T ex[6][Ext ? kRegion : 1];
};

// a cell the block stages each level: the thread's own column, or its ring
// cell
template <typename T>
struct VecSlot {
  int r = 0, sw = -1;  // region index; index in the south-west region or -1
  bool valid = false;  // inside the padded array
  size_t q = 0;        // 2-D index
  T dyG = T(0), dxG = T(0), dyC = T(0), dxC = T(0), rA = T(0);
  T wrA = T(0), mC = T(0);  // w rA at the level staged, maskC above it
};

// the global loads of level k, issued while level k-1 is computed
template <typename T>
struct VecLevel {
  // the own column at level k, and at k+1 (the kappas: interface k+1)
  T hW = T(0), hS = T(0), rhW = T(0), rhS = T(0), rhC = T(0);
  T u1 = T(0), v1 = T(0), mW1 = T(0), mS1 = T(0), kRU1 = T(0), kRV1 = T(0);
  // the ring cell at level k
  T ru = T(0), rv = T(0), rmW = T(0), rmS = T(0), rHW = T(0), rHS = T(0);
  // w at k+1 and maskC at k of the slots in the south-west region
  T w1[2] = {T(0), T(0)}, mC[2] = {T(0), T(0)};
  // recip_hFacC at level k of the ring cell of the south row or west column
  T eRhC = T(0);
};

// Ext: the dissipation variant, which reads X's viscosities and Y's
// Laplacian (`va`, each null when not given), and forms the strain-tension
// dissipation or the quadratic drag when `vp` asks for them
template <typename T, int Vort, int Cori, bool Implicit, bool Drag,
          bool Ext>
__global__ void __launch_bounds__(kTileThreads)
    mom_vecinv_kernel(const VecinvArgs<T> a, int nr, int ny, int nx, int oly,
                      int olx, int ntx, int tiles, bool noSlipBottom,
                      T viscAh, T sideDragFactor, T bottomDragLinear,
                      T rkSign, const VecViscArgs<T> va,
                      const VecViscParams<T> vp) {
  constexpr bool WithRHz = Vort != 1;
  const int nyp = ny + 2 * oly, nxp = nx + 2 * olx;
  const size_t plane = static_cast<size_t>(nyp) * nxp;
  int j0, i0;
  if (!tile_origin(ntx, tiles, oly, olx, j0, i0)) {
    T* const outs[4] = {a.gU, a.gV, a.guDiss, a.gvDiss};
    zero_halo(outs, nr, ny, nx, oly, olx, blockIdx.x - tiles,
              gridDim.x - tiles);
    return;
  }
  __shared__ VecinvShared<T, WithRHz, Ext> s;
  const bool var = Ext && va.viscAh_D != nullptr;
  const bool var4 = Ext && va.viscA4_D != nullptr;
  const bool bih = Ext && va.d2u != nullptr;
  const bool st = Ext && vp.strainTension;
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * kTX + tx;
  const int j = j0 + ty, i = i0 + tx;
  const bool own = j < nyp && i < nxp;
  const bool active = j < oly + ny && i < olx + nx;
  const size_t q = own ? static_cast<size_t>(j) * nxp + i : 0;
  const T AhD = viscAh, AhZ = viscAh;
  const bool kappas = !Implicit || (Drag && noSlipBottom);

  // the staging slots: 0 the own column, 1 the ring cell (threads < kRing)
  VecSlot<T> sl[2];
  const int nslots = t < kRing ? 2 : 1;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    if (n >= nslots) break;
    int ry = ty + 1, rx = tx + 1;
    if (n == 1) ring_cell(t, ry, rx);
    VecSlot<T>& c = sl[n];
    const int cj = j0 - 1 + ry, ci = i0 - 1 + rx;
    c.r = rg(ry, rx);
    c.valid = cj < nyp && ci < nxp;
    if (ry <= kTY && rx <= kTX) c.sw = ry * kVSWX + rx;
    if (c.valid) {
      c.q = static_cast<size_t>(cj) * nxp + ci;
      c.dyG = a.dyG[c.q];
      c.dxG = a.dxG[c.q];
      c.dyC = a.dyC[c.q];
      c.dxC = a.dxC[c.q];
      if (c.sw >= 0) {
        c.rA = a.rA[c.q];
        c.wrA = a.w[c.q] * c.rA;  // level 0; maskC above it is 0
      }
    }
  }

  // the own column's 2-D metrics
  T rrA = 0, rrAz = 0, rdxC = 0, rdyC = 0, rdxG = 0, rdyG = 0, rrAw = 0,
    rrAs = 0, rAw = 0, rAs = 0, cosU = 0, cosV = 0, fU = 0, fV = 0, dxV = 0,
    rdyU = 0, dyU = 0, rdxV = 0, dxVn = 0, rdyUn = 0, dyUe = 0, rdxVe = 0;
  if (own) {
    rrA = a.recip_rA[q];
    rrAz = a.recip_rAz[q];
    rdxC = a.recip_dxC[q];
    rdyC = a.recip_dyC[q];
    rrAw = a.recip_rAw[q];
    rrAs = a.recip_rAs[q];
  }
  if (active) {
    rdxG = a.recip_dxG[q];
    rdyG = a.recip_dyG[q];
    if (!Implicit) rAw = a.rAw[q], rAs = a.rAs[q];
    cosU = a.cosFacU[q];
    cosV = a.cosFacV[q];
    const T fG = a.fCoriG[q];
    fU = T(0.5) * (fG + a.fCoriG[q + nxp]);
    fV = T(-0.5) * (fG + a.fCoriG[q + 1]);
    dxV = a.dxV[q];
    rdyU = a.recip_dyU[q];
    dyU = a.dyU[q];
    rdxV = a.recip_dxV[q];
    dxVn = a.dxV[q + nxp];
    rdyUn = a.recip_dyU[q + nxp];
    dyUe = a.dyU[q + 1];
    rdxVe = a.recip_dxV[q + 1];
  }

  // the ring's points, a task per warp: 0 the south row's divergence and
  // KE, 1 the north row's vorticity, 2 the west column's divergence and KE,
  // 3 the east column's vorticity
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
  const bool centre = task == 0 || task == 2;
  const size_t eq = ev ? static_cast<size_t>(ej) * nxp + ei : 0;
  T e0 = 0;
  if (ev) e0 = centre ? a.recip_rA[eq] : a.recip_rAz[eq];

  // level 0 of the own column
  T u0 = 0, v0 = 0, mW0 = 0, mS0 = 0;
  if (own) {
    u0 = a.u[q], v0 = a.v[q], mW0 = a.maskW[q], mS0 = a.maskS[q];
  }
  T ukm1 = 0, vkm1 = 0, rViscU0 = 0, rViscV0 = 0;

  auto load = [&](int k) {
    VecLevel<T> L;
    const size_t lev = static_cast<size_t>(k) * plane;
    const bool deep = k == nr - 1;
    if (own) {
      const size_t p = lev + q;
      L.hW = a.hFacW[p], L.hS = a.hFacS[p], L.rhC = a.recip_hFacC[p];
      L.rhW = a.recip_hFacW[p], L.rhS = a.recip_hFacS[p];
      if (kappas && (!deep || (Drag && noSlipBottom))) {
        L.kRU1 = a.kappaRU[p + plane], L.kRV1 = a.kappaRV[p + plane];
      }
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
        L.mC[n] = a.maskC[lev + sl[n].q];
      }
    }
    if (ev && centre) L.eRhC = a.recip_hFacC[lev + eq];
    return L;
  };

  // hFacZ at a vorticity point (mom_calc_hfacz.F)
  auto hfacz = [&](int c) -> T {
    const T mW = s.mW[c], mWs = s.mW[c - kRX];
    const T mS = s.mS[c], mSw = s.mS[c - 1];
    const T openJ = vmin(s.hW[c], s.hW[c - kRX]) * mW * mWs;
    const T openI = vmin(s.hS[c], s.hS[c - 1]) * mS * mSw;
    return vmin(openI, openJ) * mW * mWs;
  };
  // the vorticity point's hFacZ, vorticity, zeta and 1 / hFacZ; under Ext
  // hFacZ zStar, or the strain-tension fluxes fs and fs2 (p2: the point's
  // 2-D index, p3 its 3-D one)
  auto vort_point = [&](int c, T recip_rAz, size_t p2, size_t p3) {
    const T hz = hfacz(c);
    const T vort = recip_rAz * ((s.vdyC[c] - s.vdyC[c - 1]) -
                                (s.udxC[c] - s.udxC[c - kRX]));
    const T om = hz == T(0) ? sideDragFactor * vort : vort;
    s.hFacZ[c] = hz;
    s.omega[c] = om;
    s.zeta[c] = hz * om;
    if (WithRHz) s.rHz[c] = hz == T(0) ? T(0) : T(1) / hz;
    if (Ext && bih) {
      const T zs = recip_rAz * ((s.ex[2][c] - s.ex[2][c - 1]) -
                                (s.ex[3][c] - s.ex[3][c - kRX]));
      s.ex[5][c] = hz * zs;
    }
    if (Ext && st) {
      const T sr = ((s.vdyC[c] - s.vdyC[c - 1]) +
                    (s.udxC[c] - s.udxC[c - kRX])) * recip_rAz;
      const T s0 = hz == T(0) ? T(0) : sr;
      const T vs = var ? va.viscAh_Z[p3] : vp.viscAhZ;
      const T dxV = a.dxV[p2], dyU = a.dyU[p2];
      s.ex[2][c] = dxV * dxV * vs * s0;
      s.ex[3][c] = dyU * dyU * vs * s0;
    }
  };
  // the cell centre's divergence (hDivScheme 2) and KE (selectKEscheme 0);
  // under Ext dStar, or the strain-tension fluxes ft and ft2
  auto centre_point = [&](int c, T recip_rA, T recip_hFacC, size_t p2,
                          size_t p3) {
    s.hDiv[c] = ((s.uTr[c + 1] - s.uTr[c]) + (s.vTr[c + kRX] - s.vTr[c])) *
                recip_rA * recip_hFacC;
    s.KE[c] = T(0.25) * ((s.uu[c] + s.uu[c + 1]) + (s.vv[c] + s.vv[c + kRX]));
    if (Ext && bih)
      s.ex[4][c] = ((s.ex[0][c + 1] - s.ex[0][c]) +
                    (s.ex[1][c + kRX] - s.ex[1][c])) *
                   recip_rA * recip_hFacC;
    if (Ext && st) {
      const T ten = ((s.udy[c + 1] - s.udy[c]) - (s.vdx[c + kRX] - s.vdx[c])) *
                    recip_rA;
      const T vt = var ? va.viscAh_D[p3] : vp.viscAhD;
      const T dyF = va.dyF[p2], dxF = va.dxF[p2];
      s.ex[0][c] = dyF * dyF * vt * ten;
      s.ex[1][c] = dxF * dxF * vt * ten;
    }
  };

  VecLevel<T> cur = load(0);
  for (int k = 0; k < nr; ++k) {
    const bool deep = k == nr - 1;
    const size_t lev = static_cast<size_t>(k) * plane;

    // ---- stage level k, and w rA at levels k and k+1 ----
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n >= nslots) break;
      VecSlot<T>& c = sl[n];
      const T uc = n == 0 ? u0 : cur.ru, vc = n == 0 ? v0 : cur.rv;
      const T hw = n == 0 ? cur.hW : cur.rHW;
      const T hs = n == 0 ? cur.hS : cur.rHS;
      const T udy = uc * c.dyG, vdx = vc * c.dxG;
      s.uu[c.r] = uc * uc;
      s.vv[c.r] = vc * vc;
      s.hW[c.r] = hw;
      s.hS[c.r] = hs;
      s.mW[c.r] = n == 0 ? mW0 : cur.rmW;
      s.mS[c.r] = n == 0 ? mS0 : cur.rmS;
      s.udy[c.r] = udy;
      s.vdx[c.r] = vdx;
      s.uTr[c.r] = udy * hw;
      s.vTr[c.r] = vdx * hs;
      s.vdyC[c.r] = vc * c.dyC;
      s.udxC[c.r] = uc * c.dxC;
      if (Ext && bih) {
        const T du = c.valid ? va.d2u[lev + c.q] : T(0);
        const T dv = c.valid ? va.d2v[lev + c.q] : T(0);
        s.ex[0][c.r] = du * c.dyG * hw;
        s.ex[1][c.r] = dv * c.dxG * hs;
        s.ex[2][c.r] = dv * c.dyC;
        s.ex[3][c.r] = du * c.dxC;
      }
      if (c.sw >= 0) {
        // w rA masked by the cell above (0 at the surface); w rA of the
        // level below, 0 below the bottom
        s.wrAup[c.sw] = c.wrA * c.mC;
        const T wrA1 = cur.w1[n] * c.rA;
        s.wrAkp1[c.sw] = deep ? T(0) : wrA1;
        c.wrA = wrA1, c.mC = cur.mC[n];
      }
    }
    // the next level's loads, in flight while this level is computed
    VecLevel<T> nxt;
    if (!deep) nxt = load(k + 1);
    const T hW0 = cur.hW, hS0 = cur.hS, rhW = cur.rhW, rhS = cur.rhS,
            kRU1 = cur.kRU1, kRV1 = cur.kRV1, u1 = cur.u1, v1 = cur.v1,
            mW1 = cur.mW1, mS1 = cur.mS1;
    const T drF = a.drF[k], rdrF = a.recip_drF[k];
    __syncthreads();

    // ---- the points, and the terms that read only the staging ----
    const int o = rg(ty + 1, tx + 1), ow = (ty + 1) * kVSWX + tx + 1;
    vort_point(o, rrAz, q, lev + q);
    centre_point(o, rrA, cur.rhC, q, lev + q);
    const int ec = rg(ey, ex);
    if (ev) {
      if (centre)
        centre_point(ec, e0, cur.eRhC, eq, lev + eq);
      else
        vort_point(ec, e0, eq, lev + eq);
    }
    // planetary Coriolis (mom_vi_coriolis.F); none under the CD scheme
    // (Cori 2: the D-grid velocities give it, model/cd_code.py)
    T gU, gV;
    if (Cori == 2) {
      gU = T(0);
      gV = T(0);
    } else if (Cori == 0) {
      const T vBarXY = T(0.25) * ((s.vdx[o] + s.vdx[o - 1]) +
                                  (s.vdx[o + kRX] + s.vdx[o + kRX - 1]));
      gU = fU * vBarXY * rdxC * mW0;
      const T uBarXY = T(0.25) * ((s.udy[o] + s.udy[o - kRX]) +
                                  (s.udy[o + 1] + s.udy[o - kRX + 1]));
      gV = fV * uBarXY * rdyC * mS0;
    } else {
      const T numU = (s.vTr[o] + s.vTr[o - 1]) +
                     (s.vTr[o + kRX] + s.vTr[o + kRX - 1]);
      const T denU = vmax((s.hS[o] + s.hS[o - 1]) +
                              (s.hS[o + kRX] + s.hS[o + kRX - 1]),
                          T(kEps));
      gU = fU * numU / denU * rdxC * mW0;
      const T numV = (s.uTr[o] + s.uTr[o - kRX]) +
                     (s.uTr[o + 1] + s.uTr[o - kRX + 1]);
      const T denV = vmax((s.hW[o] + s.hW[o - kRX]) +
                              (s.hW[o + 1] + s.hW[o - kRX + 1]),
                          T(kEps));
      gV = fV * numV / denV * rdyC * mS0;
    }
    // the transports that the vorticity advection averages: scheme 1 the
    // four v dxG / u dyG (weighted by hFacZ below), scheme 0 their plain
    // averages, scheme 2 the two half averages of each
    T aU0 = 0, aU1 = 0, aU2 = 0, aU3 = 0, aV0 = 0, aV1 = 0, aV2 = 0, aV3 = 0;
    if (Vort == 1) {
      aU0 = s.vdx[o], aU1 = s.vdx[o - 1], aU2 = s.vdx[o + kRX],
      aU3 = s.vdx[o + kRX - 1];
      aV0 = s.udy[o], aV1 = s.udy[o - kRX], aV2 = s.udy[o + 1],
      aV3 = s.udy[o - kRX + 1];
    } else if (Vort == 0) {
      aU0 = T(0.25) * ((s.vTr[o] + s.vTr[o - 1]) +
                       (s.vTr[o + kRX] + s.vTr[o + kRX - 1]));
      aV0 = T(0.25) * ((s.uTr[o] + s.uTr[o - kRX]) +
                       (s.uTr[o + 1] + s.uTr[o - kRX + 1]));
    } else {
      aU0 = T(0.5) * (s.vTr[o] + s.vTr[o - 1]);
      aU1 = T(0.5) * (s.vTr[o + kRX] + s.vTr[o + kRX - 1]);
      aV0 = T(0.5) * (s.uTr[o] + s.uTr[o - kRX]);
      aV1 = T(0.5) * (s.uTr[o + 1] + s.uTr[o - kRX + 1]);
    }
    // vertical shear -w du/dz (mom_vi_u_vertshear.F)
    const T mkm1 = k == 0 ? T(0) : T(1);
    const T mkp1 = deep ? T(0) : T(1);
    T shU, shV;
    {
      const T ukp1 = deep ? T(0) : u1, vkp1 = deep ? T(0) : v1;
      const T wBarXm =
          T(0.5) * (s.wrAup[ow] + s.wrAup[ow - 1]) * mkm1 * rrAw;
      const T wBarXp =
          T(0.5) * (s.wrAkp1[ow] + s.wrAkp1[ow - 1]) * mkp1 * rrAw;
      const T uZm = (u0 - mkm1 * ukm1) * rkSign;
      const T uZp = (mkp1 * ukp1 - u0) * rkSign;
      shU = T(0.5) * (wBarXp * uZp + wBarXm * uZm) * rhW * rdrF;
      const T wBarYm =
          T(0.5) * (s.wrAup[ow] + s.wrAup[ow - kVSWX]) * mkm1 * rrAs;
      const T wBarYp =
          T(0.5) * (s.wrAkp1[ow] + s.wrAkp1[ow - kVSWX]) * mkp1 * rrAs;
      const T vZm = (v0 - mkm1 * vkm1) * rkSign;
      const T vZp = (mkp1 * vkp1 - v0) * rkSign;
      shV = T(0.5) * (wBarYp * vZp + wBarYm * vZm) * rhS * rdrF;
    }
    // the explicit viscous flux at the lower interface (k+1): 0 below the
    // bottom (mom_u_rviscflux.F)
    T rViscU1 = 0, rViscV1 = 0;
    if (!Implicit && !deep) {
      const T rdrC = a.recip_drC[k + 1];
      rViscU1 = -kRU1 * rAw * (u1 - u0) * rkSign * rdrC * mW1 * mW0;
      rViscV1 = -kRV1 * rAs * (v1 - v0) * rkSign * rdrC * mS1 * mS0;
    }
    T recDr = 0;
    if (Drag && noSlipBottom)
      recDr = deep ? a.recip_drF[nr - 1] : a.recip_drC[k + 1];
    __syncthreads();

    // ---- the cell's tendencies ----
    if (active) {
      const T hz = s.hFacZ[o], hzN = s.hFacZ[o + kRX], hzE = s.hFacZ[o + 1];
      const T om = s.omega[o], omN = s.omega[o + kRX], omE = s.omega[o + 1];
      const size_t p = lev + q;
      T guDiss, gvDiss;
      if (st) {
        // the strain-tension form (mom_hdissip.F)
        const T uD2 = rdyG * rdyG * rdxC * (s.ex[0][o] - s.ex[0][o - 1]) +
                      rdxC * rdxC * rdyG * (s.ex[2][o + kRX] - s.ex[2][o]);
        const T vD2 = rdyC * rdyC * rdxG * (s.ex[3][o + 1] - s.ex[3][o]) -
                      rdxG * rdxG * rdyC * (s.ex[1][o] - s.ex[1][o - kRX]);
        guDiss = uD2 * mW0;
        gvDiss = vD2 * mS0;
      } else if (var) {
        // variable viscosity in divergence/vorticity form: the viscosity
        // multiplies D and Z before the differencing (mom_vi_hdissip.F)
        const T Dv = s.hDiv[o] * va.viscAh_D[p];
        const T DvW = s.hDiv[o - 1] * va.viscAh_D[p - 1];
        const T DvS = s.hDiv[o - kRX] * va.viscAh_D[p - nxp];
        const T Zv = s.zeta[o] * va.viscAh_Z[p];
        const T ZvN = s.zeta[o + kRX] * va.viscAh_Z[p + nxp];
        const T ZvE = s.zeta[o + 1] * va.viscAh_Z[p + 1];
        const T uD2 = cosU * (Dv - DvW) * rdxC - rhW * (ZvN - Zv) * rdyG * cosU;
        const T vD2 = rhS * cosV * (ZvE - Zv) * rdxG + (Dv - DvS) * rdyC * cosV;
        guDiss = uD2 * mW0;
        gvDiss = vD2 * mS0;
        if (bih) {
          const T D4 = s.ex[4][o] * va.viscA4_D[p];
          const T D4W = s.ex[4][o - 1] * va.viscA4_D[p - 1];
          const T D4S = s.ex[4][o - kRX] * va.viscA4_D[p - nxp];
          const T z4 = s.ex[5][o] * va.viscA4_Z[p];
          const T z4N = s.ex[5][o + kRX] * va.viscA4_Z[p + nxp];
          const T z4E = s.ex[5][o + 1] * va.viscA4_Z[p + 1];
          const T uD4 = cosU * (D4 - D4W) * rdxC - rhW * (z4N - z4) * rdyG;
          const T vD4 = rhS * cosV * (z4E - z4) * rdxG + (D4 - D4S) * rdyC;
          guDiss = guDiss - uD4 * mW0;
          gvDiss = gvDiss - vD4 * mS0;
        }
      } else {
        // harmonic dissipation in divergence/vorticity form
        // (mom_vi_hdissip.F)
        const T hDiv = s.hDiv[o], Z = s.zeta[o];
        const T uD2 = AhD * cosU * (hDiv - s.hDiv[o - 1]) * rdxC -
                      AhZ * rhW * (s.zeta[o + kRX] - Z) * rdyG * cosU;
        const T vD2 = AhZ * rhS * cosV * (s.zeta[o + 1] - Z) * rdxG +
                      AhD * (hDiv - s.hDiv[o - kRX]) * rdyC * cosV;
        guDiss = uD2 * mW0;
        gvDiss = vD2 * mS0;
        if (bih) {
          // constant biharmonic viscosity, from dStar and hFacZ zStar
          const T A4 = vp.viscA4, dS = s.ex[4][o], z4 = s.ex[5][o];
          const T uD4 = A4 * cosU * (dS - s.ex[4][o - 1]) * rdxC -
                        A4 * rhW * (s.ex[5][o + kRX] - z4) * rdyG;
          const T vD4 = A4 * rhS * cosV * (s.ex[5][o + 1] - z4) * rdxG +
                        A4 * (dS - s.ex[4][o - kRX]) * rdyC;
          guDiss = guDiss - uD4 * mW0;
          gvDiss = gvDiss - vD4 * mS0;
        }
      }
      if (!Implicit) {
        guDiss = guDiss -
                 (rhW * rdrF * rrAw * (rViscU1 - rViscU0) * rkSign);
        gvDiss = gvDiss -
                 (rhS * rdrF * rrAs * (rViscV1 - rViscV0) * rkSign);
      }
      // no-slip side drag (mom_u_sidedrag.F); under Ext viscAh_Z (and
      // viscA4_Z times the Laplacian) at each wall's vorticity point
      T Ahu = AhZ * u0, AhuN = Ahu;
      T Ahv = AhZ * v0 * cosV, AhvE = Ahv;
      if (Ext) {
        const T z0 = var ? va.viscAh_Z[p] : vp.viscAhZ;
        const T zN = var ? va.viscAh_Z[p + nxp] : vp.viscAhZ;
        const T zE = var ? va.viscAh_Z[p + 1] : vp.viscAhZ;
        Ahu = z0 * u0, AhuN = zN * u0;
        Ahv = z0 * v0 * cosV, AhvE = zE * v0 * cosV;
        if (bih) {
          const T f0 = var4 ? va.viscA4_Z[p] : vp.viscA4Z;
          const T fN = var4 ? va.viscA4_Z[p + nxp] : vp.viscA4Z;
          const T fE = var4 ? va.viscA4_Z[p + 1] : vp.viscA4Z;
          const T du = va.d2u[p], dv = va.d2v[p];
          Ahu = Ahu - f0 * du;
          AhuN = AhuN - fN * du;
          Ahv = Ahv - f0 * dv;
          AhvE = AhvE - fE * dv;
        }
      }
      guDiss = guDiss -
               (rhW * rdrF * rrAw *
                ((hW0 - hz) * dxV * rdyU * Ahu +
                 (hW0 - hzN) * dxVn * rdyUn * AhuN) *
                drF * sideDragFactor) *
                   mW0;
      gvDiss = gvDiss -
               (rhS * rdrF * rrAs *
                ((hS0 - hz) * dyU * rdxV * Ahv +
                 (hS0 - hzE) * dyUe * rdxVe * AhvE) *
                drF * sideDragFactor) *
                   mS0;
      // no-slip and linear bottom drag (mom_u_botdrag_coeff.F): only
      // where the cell below is dry, or at k = Nr
      if (Drag) {
        T cDragU = bottomDragLinear, cDragV = bottomDragLinear;
        if (noSlipBottom) {
          cDragU = cDragU + kRU1 * recDr * T(2);
          cDragV = cDragV + kRV1 * recDr * T(2);
        }
        if (Ext && vp.bottomDragQuadratic != T(0)) {
          // the quadratic drag, as the flux form forms it
          const T keS = s.KE[o] + s.KE[o - 1];
          const T keSv = s.KE[o] + s.KE[o - kRX];
          cDragU = cDragU + (keS > T(0) ? vp.bottomDragQuadratic * sqrt(keS)
                                        : T(0));
          cDragV = cDragV + (keSv > T(0)
                                 ? vp.bottomDragQuadratic * sqrt(keSv)
                                 : T(0));
        }
        const T bottomW = mW0 * (deep ? T(1) : T(1) - mW1);
        const T bottomS = mS0 * (deep ? T(1) : T(1) - mS1);
        guDiss = guDiss - cDragU * bottomW * u0 * rhW * rdrF;
        gvDiss = gvDiss - cDragV * bottomS * v0 * rhS * rdrF;
      }
      // vorticity advection (mom_vi_u_coriolis.F, mom_vi_v_coriolis.F)
      T vortU, vortV;
      if (Vort == 1) {
        const T numU = T(0.5) * ((aU0 * hz + aU1 * hz) +
                                 (aU2 * hzN + aU3 * hzN));
        const T vort3u = T(0.5) * (om + omN);
        vortU = vort3u * (numU / vmax(hz + hzN, T(kEps))) * rdxC * mW0;
        const T numV = T(0.5) * ((aV0 * hz + aV1 * hz) +
                                 (aV2 * hzE + aV3 * hzE));
        const T vort3v = T(0.5) * (om + omE);
        vortV = -vort3v * (numV / vmax(hz + hzE, T(kEps))) * rdyC * mS0;
      } else if (Vort == 0) {
        const T rz = s.rHz[o];
        const T vort3u = T(0.5) * (om * rz + omN * s.rHz[o + kRX]);
        vortU = vort3u * aU0 * rdxC * mW0;
        const T vort3v = T(0.5) * (om * rz + omE * s.rHz[o + 1]);
        vortV = -vort3v * aV0 * rdyC * mS0;
      } else {
        const T rz = s.rHz[o];
        const T vort3u =
            T(0.5) * (aU0 * rz * om + aU1 * (s.rHz[o + kRX] * omN));
        vortU = vort3u * rdxC * mW0;
        const T vort3v =
            T(0.5) * (aV0 * rz * om + aV1 * (s.rHz[o + 1] * omE));
        vortV = -vort3v * rdyC * mS0;
      }
      gU = gU + vortU;
      gV = gV + vortV;
      gU = gU - shU;
      gV = gV - shV;
      // -grad KE (mom_vi_u_grad_ke.F)
      const T ke = s.KE[o];
      gU = gU - rdxC * (ke - s.KE[o - 1]) * mW0;
      gV = gV - rdyC * (ke - s.KE[o - kRX]) * mS0;
      a.gU[p] = gU * mW0;
      a.gV[p] = gV * mS0;
      a.guDiss[p] = guDiss * mW0;
      a.gvDiss[p] = gvDiss * mS0;
    }
    rViscU0 = rViscU1, rViscV0 = rViscV1;
    ukm1 = u0, vkm1 = v0;
    u0 = u1, v0 = v1, mW0 = mW1, mS0 = mS1;
    cur = nxt;
  }
}

// Kernel V's launch from its entry point's arguments: the table's and the
// flags' checks, the grid, and the variant that the flags pick (Ext: the
// dissipation variant, with its second table `va`, numbers `vp` and the
// drag switch given); start(kernel, grid, block, args...) starts it
// (OnStream on the card).
template <typename T, bool Ext, typename Start>
int start_vecinv(const void* const* table, int n, int nr, int ny, int nx,
                 int oly, int olx, int vortScheme, int coriScheme,
                 int implicitViscosity, int noSlipBottom, double viscAh,
                 double sideDragFactor, double bottomDragLinear,
                 double rkSign, bool drag, const VecViscArgs<T>& va,
                 const VecViscParams<T>& vp, Start start) {
  static_assert(sizeof(VecinvArgs<T>) == kVecinvNumPointers * sizeof(void*),
                "VecinvArgs must be a plain table of pointers");
  if (n != kVecinvNumPointers || vortScheme < 0 || vortScheme > 2 ||
      coriScheme < 0 || coriScheme > 2 || implicitViscosity < 0 ||
      implicitViscosity > 1 || noSlipBottom < 0 || noSlipBottom > 1 ||
      nr < 1 || ny < 1 || nx < 1 || oly < 1 || olx < 1)
    return (int)cudaErrorInvalidValue;
  VecinvArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  const TileGrid tg = tile_grid(nr, ny, nx, oly, olx);
  auto run = [&](auto kernel) {
    start(kernel, dim3(tg.tiles + tg.halo_blocks), dim3(kTX, kTY), a, nr,
          ny, nx, oly, olx, tg.ntx, tg.tiles, noSlipBottom != 0, T(viscAh),
          T(sideDragFactor), T(bottomDragLinear), T(rkSign), va, vp);
  };
  auto by_drag = [&](auto vort, auto cori, auto implicit) {
    constexpr int V = decltype(vort)::value, C = decltype(cori)::value;
    constexpr bool I = decltype(implicit)::value;
    if (drag)
      run(mom_vecinv_kernel<T, V, C, I, true, Ext>);
    else
      run(mom_vecinv_kernel<T, V, C, I, false, Ext>);
  };
  auto by_implicit = [&](auto vort, auto cori) {
    if (implicitViscosity)
      by_drag(vort, cori, std::true_type{});
    else
      by_drag(vort, cori, std::false_type{});
  };
  auto by_cori = [&](auto vort) {
    if (coriScheme == 0)
      by_implicit(vort, std::integral_constant<int, 0>{});
    else if (coriScheme == 1)
      by_implicit(vort, std::integral_constant<int, 1>{});
    else
      by_implicit(vort, std::integral_constant<int, 2>{});
  };
  if (vortScheme == 0)
    by_cori(std::integral_constant<int, 0>{});
  else if (vortScheme == 1)
    by_cori(std::integral_constant<int, 1>{});
  else
    by_cori(std::integral_constant<int, 2>{});
  return (int)cudaGetLastError();
}

template <typename T, typename Start>
int launch_vecinv(const void* const* table, int n, int nr, int ny, int nx,
                  int oly, int olx, int vortScheme, int coriScheme,
                  int implicitViscosity, int noSlipBottom, double viscAh,
                  double sideDragFactor, double bottomDragLinear,
                  double rkSign, Start start) {
  const bool drag = noSlipBottom || bottomDragLinear != 0.0;
  return start_vecinv<T, false>(table, n, nr, ny, nx, oly, olx, vortScheme,
                                coriScheme, implicitViscosity, noSlipBottom,
                                viscAh, sideDragFactor, bottomDragLinear,
                                rkSign, drag, VecViscArgs<T>{},
                                VecViscParams<T>{}, start);
}

// V's dissipation variant: V's arguments, then the table of VecViscArgs
// (the viscosities given in pairs, the Laplacian both or neither, the
// biharmonic viscosities only with it, dyF and dxF under the
// strain-tension form, which takes no Laplacian), the numbers of
// VecViscParams, the strain-tension form and the drag switch
template <typename T, typename Start>
int launch_vecinv_visc(const void* const* table, int n, int nr, int ny,
                       int nx, int oly, int olx, int vortScheme,
                       int coriScheme, int implicitViscosity,
                       int noSlipBottom, double viscAh, double sideDragFactor,
                       double bottomDragLinear, double rkSign,
                       const void* const* vtable, int nv,
                       const double* params, int np, int strainTension,
                       int drag, Start start) {
  static_assert(sizeof(VecViscArgs<T>) == kVecViscNumPointers * sizeof(void*),
                "VecViscArgs must be a plain table of pointers");
  if (nv != kVecViscNumPointers || np != kVecViscNumParams ||
      strainTension < 0 || strainTension > 1 || drag < 0 || drag > 1)
    return (int)cudaErrorInvalidValue;
  VecViscArgs<T> va;
  std::memcpy(&va, vtable, sizeof(va));
  const bool bih = va.d2u != nullptr;
  if ((va.viscAh_D == nullptr) != (va.viscAh_Z == nullptr) ||
      (va.viscA4_D == nullptr) != (va.viscA4_Z == nullptr) ||
      (va.d2v == nullptr) == bih || (va.viscA4_D && !bih) ||
      (strainTension && (bih || !va.dyF || !va.dxF)))
    return (int)cudaErrorInvalidValue;
  const VecViscParams<T> vp{T(params[0]), T(params[1]), T(params[2]),
                            T(params[3]), T(params[4]), strainTension != 0};
  return start_vecinv<T, true>(table, n, nr, ny, nx, oly, olx, vortScheme,
                               coriScheme, implicitViscosity, noSlipBottom,
                               viscAh, sideDragFactor, bottomDragLinear,
                               rkSign, drag != 0, va, vp, start);
}

}  // namespace mitgcm
