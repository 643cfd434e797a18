// Kernel W's kernel: a column-walking tile over the padded plane that forms
// each face flux once, and its launch. Included by calc_gw.cu, whose entry
// points start it on the card, and by the host check of the tests, which
// runs it on the CPU.
//
// W writes every padded cell (its halo outputs are real values: outside the
// array a neighbour reads 0 and a face flux is 0, as the JAX code's
// zero-filled shifts give), so the tiles of kTX x kTY columns (tile.cuh)
// cover the whole nyp x nxp plane, and there are no halo blocks. A block
// walks k from the surface down. Per level k:
//  1. it stages w of level k over the tile and its one-cell ring (no
//     corners: the W and S faces reach i-1 and j-1, the ring's east column
//     and north row form the tile's east and north faces) and, with the
//     3-D Coriolis term, u over the tile and its east column and v over the
//     tile and its north row; a ring cell outside the array stages 0;
//  2. each thread forms its own cell's W and S face fluxes once into shared
//     memory, harmonic (dissEW, dissNS) and advective (advEW, advNS, the
//     transports from levels k-1 and k), the east ring column the tile's
//     east faces and the north ring row its north faces (0 on a face
//     outside the array); with the 3-D Coriolis term each thread forms the
//     sums u + u(i+1) and v + v(j+1) of its column;
//  3. each cell forms gwDiss and gW from those differences and from the
//     vertical fluxes at its two interfaces.
// Carried in registers from level k to k+1: the lower interface's viscous
// and advective fluxes (dissDn(k), advDn(k): level k+1's upper ones; the
// upper viscous flux at k = 1 is dissTop), the face transports' level-k
// products drF hFacW u and drF hFacS v (the ring cells' too), the four
// kappas at interface k+1 (the column's and its east / north neighbour's),
// maskC of level k, w of levels k-1 and k, and the Coriolis sums. The
// column's 2-D metrics are read once a walk, the ring cells' too. The next
// level's loads are issued before a level is computed; w of the column runs
// one level further ahead, since the lower interface's fluxes read w(k+1).
// Two barriers a level.
//
// Every value is the JAX code's expression (and the plain twin's,
// model/calc_gw.py:_calc_gw_plain) on the same operands in the same order,
// the viscosity's eight-term sum included, so with --fmad=false the outputs
// are the twin's bit for bit. Both outputs are 0 at k = 0.
#pragma once

#include <cstring>

#include "tile.cuh"

namespace mitgcm {

template <typename T>
struct GwArgs {
  // [nr, nyp, nxp]
  const T *u, *v, *w, *maskC, *hFacW, *hFacS;
  // [nr+1, nyp, nxp]
  const T *kappaRU, *kappaRV;
  // [nyp, nxp]
  const T *dxG, *dyG, *recip_dxC, *recip_dyC, *rA, *recip_rA, *Ro_surf,
      *R_low, *rSurfW, *rLowW, *rSurfS, *rLowS, *fCoriCos, *angleCosC,
      *angleSinC;
  // [nr]
  const T *rC, *drF, *recip_drF;
  // outputs [nr, nyp, nxp]
  T *gW, *gwDiss;
};
constexpr int kGwNumPointers = 28;

template <typename T>
__device__ __forceinline__ T gmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T gmax(T a, T b) { return a > b ? a : b; }

// the global loads of level k, issued while level k-1 is computed
template <typename T>
struct GwLevel {
  // the column: w of level k+1; u, v, hFacW, hFacS and maskC of level k;
  // the kappas at interface k+1 here, one cell east (kappaRU) and one cell
  // north (kappaRV)
  T wn = T(0), u = T(0), v = T(0), hW = T(0), hS = T(0), mC = T(0),
    kU = T(0), kUe = T(0), kV = T(0), kVn = T(0);
  // the ring cell at level k: w, and u and hFacW (east column) or v and
  // hFacS (north row)
  T rw = T(0), rv = T(0), rh = T(0);
};

template <typename T, bool Coriolis3d>
__global__ void __launch_bounds__(kTileThreads)
    calc_gw_kernel(const GwArgs<T> a, int nr, int nyp, int nxp, int ntx,
                   T viscAhW, T rkSign, T gravitySign) {
  constexpr int kU3 = Coriolis3d ? kRegion : 1;
  __shared__ T sw[kRegion], su[kU3], sv[kU3];
  __shared__ T dEW[kRegion], dNS[kRegion], aEW[kRegion], aNS[kRegion];
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * kTX + tx;
  const int j0 = (blockIdx.x / ntx) * kTY, i0 = (blockIdx.x % ntx) * kTX;
  const int j = j0 + ty, i = i0 + tx;
  const bool own = j < nyp && i < nxp;
  const size_t plane = static_cast<size_t>(nyp) * nxp;
  const size_t q = own ? static_cast<size_t>(j) * nxp + i : 0;
  const int o = rg(ty + 1, tx + 1);

  // the thread's ring cell (threads < kRing; the corners stage nothing)
  int ry = 1, rx = 1;
  if (t < kRing) ring_cell(t, ry, rx);
  const bool corner =
      (ry == 0 || ry == kRY - 1) && (rx == 0 || rx == kRX - 1);
  const bool ring = t < kRing && !corner;
  const bool east = ring && rx == kRX - 1, north = ring && ry == kRY - 1;
  const int rj = j0 - 1 + ry, ri = i0 - 1 + rx, rc = rg(ry, rx);
  const bool rin = ring && rj >= 0 && rj < nyp && ri >= 0 && ri < nxp;
  const size_t rq = rin ? static_cast<size_t>(rj) * nxp + ri : 0;

  // the 2-D metrics: the column's, and the east or north ring cell's face
  T rA = 0, rrA = 0, Ro = 0, Rl = 0, dyG = 0, dxG = 0, rdxC = 0, rdyC = 0,
    rSW = 0, rLW = 0, rSS = 0, rLS = 0, fCC = 0, aCC = 0, aSC = 0;
  if (own) {
    rA = a.rA[q], rrA = a.recip_rA[q], Ro = a.Ro_surf[q], Rl = a.R_low[q];
    dyG = a.dyG[q], dxG = a.dxG[q], rdxC = a.recip_dxC[q];
    rdyC = a.recip_dyC[q];
    rSW = a.rSurfW[q], rLW = a.rLowW[q], rSS = a.rSurfS[q];
    rLS = a.rLowS[q];
    if (Coriolis3d) {
      fCC = a.fCoriCos[q], aCC = a.angleCosC[q], aSC = a.angleSinC[q];
    }
  }
  T eG = 0, eRd = 0, eRS = 0, eRL = 0;   // dyG, recip_dxC, rSurfW, rLowW
  if (rin && east) {
    eG = a.dyG[rq], eRd = a.recip_dxC[rq];
    eRS = a.rSurfW[rq], eRL = a.rLowW[rq];
  } else if (rin && north) {                // dxG, recip_dyC, rSurfS, rLowS
    eG = a.dxG[rq], eRd = a.recip_dyC[rq];
    eRS = a.rSurfS[rq], eRL = a.rLowS[rq];
  }

  auto load = [&](int k) {
    GwLevel<T> L;
    const size_t lev = static_cast<size_t>(k) * plane;
    if (own) {
      const size_t p = lev + q, p1 = p + plane;
      if (k + 1 < nr) L.wn = a.w[p1];
      L.u = a.u[p], L.v = a.v[p], L.hW = a.hFacW[p], L.hS = a.hFacS[p];
      L.mC = a.maskC[p];
      L.kU = a.kappaRU[p1], L.kV = a.kappaRV[p1];
      if (i + 1 < nxp) L.kUe = a.kappaRU[p1 + 1];
      if (j + 1 < nyp) L.kVn = a.kappaRV[p1 + nxp];
    }
    if (rin) {
      const size_t p = lev + rq;
      L.rw = a.w[p];
      if (east) L.rv = a.u[p], L.rh = a.hFacW[p];
      if (north) L.rv = a.v[p], L.rh = a.hFacS[p];
    }
    return L;
  };

  // carried from level k-1 (see the header)
  T wk = own ? a.w[q] : T(0), wm = T(0);
  T tWm = 0, tSm = 0, rtm = 0, suM = 0, svM = 0, mCm = 0, dUp = 0, aUp = 0;
  T kI[4] = {T(0), T(0), T(0), T(0)};
  T rCm = 0, rdrFm = 0;
  GwLevel<T> cur = load(0);
  for (int k = 0; k < nr; ++k) {
    const bool deep = k == nr - 1;
    const T drFk = a.drF[k], rCk = a.rC[k], rdrFk = a.recip_drF[k];

    // ---- stage level k ----
    sw[o] = wk;
    if (ring) sw[rc] = cur.rw;
    if (Coriolis3d) {
      su[o] = cur.u;
      sv[o] = cur.v;
      if (east) su[rc] = cur.rv;
      if (north) sv[rc] = cur.rv;
    }
    // the next level's loads, in flight while this level is computed
    GwLevel<T> nxt;
    if (!deep) nxt = load(k + 1);
    __syncthreads();

    // ---- the W and S faces of the column, the ring's E and N faces ----
    const T tW = drFk * cur.hW * cur.u, tS = drFk * cur.hS * cur.v;
    const T rt = drFk * cur.rh * cur.rv;
    T suK = 0, svK = 0;
    if (Coriolis3d) {
      suK = cur.u + su[o + 1];
      svK = cur.v + sv[o + kRX];
    }
    if (k > 0) {
      T fdE = 0, fdN = 0, faE = 0, faN = 0;
      if (own) {
        const T wc = sw[o], wW = sw[o - 1], wS = sw[o - kRX];
        const T vw = i - 1 >= 0 ? viscAhW : T(0);
        const T xA = dyG * gmax(gmin(rSW, rCm) - gmax(rLW, rCk), T(0));
        fdE = -(viscAhW + vw) * T(0.5) * (wc - wW) * rdxC * xA;
        const T vs = j - 1 >= 0 ? viscAhW : T(0);
        const T yA = dxG * gmax(gmin(rSS, rCm) - gmax(rLS, rCk), T(0));
        fdN = -(viscAhW + vs) * T(0.5) * (wc - wS) * rdyC * yA;
        const T uTrans = (tWm + tW) * T(0.5) * dyG;
        faE = uTrans * (wc + wW) * T(0.5);
        const T vTrans = (tSm + tS) * T(0.5) * dxG;
        faN = vTrans * (wc + wS) * T(0.5);
      }
      dEW[o] = fdE, dNS[o] = fdN, aEW[o] = faE, aNS[o] = faN;
      if (east || north) {
        T fd = 0, fa = 0;
        if (rin) {
          // the face's cell and the cell behind it (west or south)
          const T wc = sw[rc], wb = sw[east ? rc - 1 : rc - kRX];
          const T vb = (east ? ri : rj) - 1 >= 0 ? viscAhW : T(0);
          const T A = eG * gmax(gmin(eRS, rCm) - gmax(eRL, rCk), T(0));
          fd = -(viscAhW + vb) * T(0.5) * (wc - wb) * eRd * A;
          const T trans = (rtm + rt) * T(0.5) * eG;
          fa = trans * (wc + wb) * T(0.5);
        }
        if (east) {
          dEW[rc] = fd, aEW[rc] = fa;
        } else {
          dNS[rc] = fd, aNS[rc] = fa;
        }
      }
    }
    __syncthreads();

    // ---- the cell's outputs ----
    const T wn = deep ? wk : cur.wn;
    const T mskP1 = deep ? T(0) : T(1);
    T dDn = 0;
    const T sA = wk + wn * mskP1;
    const T rTrans = T(0.5) * sA * rA;
    const T aDn = rTrans * (T(0.5) * sA);
    if (k > 0) {
      const T viscLoc = (kI[0] + kI[1] + cur.kU + cur.kUe + kI[2] + kI[3] +
                         cur.kV + cur.kVn) *
                        T(0.125);
      dDn = -viscLoc * (wn * mskP1 - wk) * rkSign * rdrFk * rA;
      if (k == 1) {
        const T visc2 = (kI[0] + kI[1] + kI[2] + kI[3]) * T(0.25);
        dUp = -visc2 * (wk - wm) * rkSign * rdrFm * rA;
      }
    }
    if (own) {
      const size_t p = static_cast<size_t>(k) * plane + q;
      if (k == 0) {
        a.gW[p] = T(0);
        a.gwDiss[p] = T(0);
      } else {
        T rThick = T(0);
        if (!(mCm == T(0) || cur.mC == T(0))) {
          const T thick = gmin(Ro, rCm) - gmax(Rl, rCk);
          rThick = T(1) / (thick == T(0) ? T(1) : thick);
        }
        a.gwDiss[p] = -((dEW[o + 1] - dEW[o]) + (dNS[o + kRX] - dNS[o]) +
                        (dDn - dUp) * rkSign) *
                      rrA * rThick;
        T gW = -((aEW[o + 1] - aEW[o]) + (aNS[o + kRX] - aNS[o]) +
                 (aDn - aUp) * rkSign) *
               rrA * rThick;
        if (Coriolis3d) {
          const T ubar = T(0.25) * (suM + suK);
          const T vbar = T(0.25) * (svM + svK);
          gW = gW + -gravitySign * fCC * (aCC * ubar - aSC * vbar);
        }
        a.gW[p] = gW;
      }
    }

    // ---- carry to level k+1 ----
    dUp = dDn, aUp = aDn;
    kI[0] = cur.kU, kI[1] = cur.kUe, kI[2] = cur.kV, kI[3] = cur.kVn;
    mCm = cur.mC;
    tWm = tW, tSm = tS, rtm = rt, suM = suK, svM = svK;
    wm = wk, wk = wn;
    rCm = rCk, rdrFm = rdrFk;
    cur = nxt;
  }
}

// Kernel W's launch from its entry point's arguments: the table's and the
// flag's checks, the tiles of the padded plane, and the variant the flag
// picks; start(kernel, grid, block, args...) starts it (OnStream on the
// card).
template <typename T, typename Start>
int launch_calc_gw(const void* const* table, int n, int nr, int nyp, int nxp,
                   int coriolis_3d, double viscAhW, double rkSign,
                   double gravitySign, Start start) {
  static_assert(sizeof(GwArgs<T>) == kGwNumPointers * sizeof(void*),
                "GwArgs must be a plain table of pointers");
  if (n != kGwNumPointers || nr < 1 || nyp < 1 || nxp < 1 ||
      coriolis_3d < 0 || coriolis_3d > 1)
    return (int)cudaErrorInvalidValue;
  GwArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  const int ntx = (nxp + kTX - 1) / kTX, nty = (nyp + kTY - 1) / kTY;
  const dim3 grid(ntx * nty), block(kTX, kTY);
  if (coriolis_3d)
    start(calc_gw_kernel<T, true>, grid, block, a, nr, nyp, nxp, ntx,
          T(viscAhW), T(rkSign), T(gravitySign));
  else
    start(calc_gw_kernel<T, false>, grid, block, a, nr, nyp, nxp, ntx,
          T(viscAhW), T(rkSign), T(gravitySign));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
