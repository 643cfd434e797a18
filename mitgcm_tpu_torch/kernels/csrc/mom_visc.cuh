// Kernels X (mom_calc_visc) and Y (mom_del2uv), and their launches.
// Included by mom_visc.cu, whose entry points start them on the card, and
// by the host check of the tests, which runs them on the CPU.
//
// One thread a padded cell (cell_grid, the level the fastest block index),
// each recomputing from u and v the neighbour quantities it reads: simple,
// and right first. Each intermediate is formed as the plain twin forms it
// on the whole padded array: a shifted field is zero past the array's edge
// (ops/stencil.py:shift), and so is every product or difference built on
// it, so every padded cell is written as the twin writes it, halo cells
// included (kernels B and V read X's and Y's outputs one cell into the
// halo). Each expression keeps the twin's operation order, and maxima and
// minima propagate NaN as torch.maximum and torch.minimum do, so with
// --fmad=false the outputs are the twins' bit for bit.
#pragma once

#include <cmath>
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace mitgcm {

template <typename T>
__device__ __forceinline__ T vis_min(T a, T b) { return a < b ? a : b; }

// The padded grid around one cell: 3-D reads at the cell's level and 2-D
// reads, each 0 past the array's edge.
template <typename T>
struct Padded {
  int nyp, nxp;
  size_t lev;
  __device__ bool in(int j, int i) const {
    return j >= 0 && j < nyp && i >= 0 && i < nxp;
  }
  __device__ size_t q(int j, int i) const {
    return static_cast<size_t>(j) * nxp + i;
  }
  __device__ T f3(const T* f, int j, int i) const {
    return in(j, i) ? f[lev + q(j, i)] : T(0);
  }
  __device__ T f2(const T* f, int j, int i) const {
    return in(j, i) ? f[q(j, i)] : T(0);
  }
};

// hFacZ (mom_calc_hfacz.F; mom_fluxform.py:calc_hfacz), 0 past the edge
template <typename T>
__device__ T padded_hfacz(const Padded<T>& g, const T* hFacW, const T* hFacS,
                          const T* maskW, const T* maskS, int j, int i) {
  if (!g.in(j, i)) return T(0);
  const T mW = g.f3(maskW, j, i), mWs = g.f3(maskW, j - 1, i);
  const T mS = g.f3(maskS, j, i), mSw = g.f3(maskS, j, i - 1);
  const T openJ =
      vis_min(g.f3(hFacW, j, i), g.f3(hFacW, j - 1, i)) * mW * mWs;
  const T openI =
      vis_min(g.f3(hFacS, j, i), g.f3(hFacS, j, i - 1)) * mS * mSw;
  return vis_min(openI, openJ) * mW * mWs;
}

// The velocity-derived quantities of both kernels at a padded point: the
// fields they read and the stencils of mom_vecinv.py's calc_relvort3 and
// calc_hdiv, mom_visc.py's calc_tension and calc_strain, calc_ke; each 0
// past the edge.
template <typename T>
struct VelPoint {
  Padded<T> g;
  const T *u, *v, *hFacW, *hFacS, *maskW, *maskS, *recip_hFacC;
  const T *dyG, *dxG, *dyC, *dxC, *recip_rA, *recip_rAz;
  T fac;  // sideMaskFac

  __device__ T hfacz(int j, int i) const {
    return padded_hfacz(g, hFacW, hFacS, maskW, maskS, j, i);
  }
  __device__ T vdyC(int j, int i) const {
    return g.f3(v, j, i) * g.f2(dyC, j, i);
  }
  __device__ T udxC(int j, int i) const {
    return g.f3(u, j, i) * g.f2(dxC, j, i);
  }
  // the relative vorticity, times sideMaskFac where hFacZ is 0
  __device__ T vort(int j, int i) const {
    if (!g.in(j, i)) return T(0);
    const T w = g.f2(recip_rAz, j, i) * ((vdyC(j, i) - vdyC(j, i - 1)) -
                                         (udxC(j, i) - udxC(j - 1, i)));
    return hfacz(j, i) == T(0) ? fac * w : w;
  }
  // the strain, times sideMaskFac where hFacZ is 0
  __device__ T strain(int j, int i) const {
    if (!g.in(j, i)) return T(0);
    const T s = ((g.f2(dyC, j, i) * g.f3(v, j, i) -
                  g.f2(dyC, j, i - 1) * g.f3(v, j, i - 1)) +
                 (g.f2(dxC, j, i) * g.f3(u, j, i) -
                  g.f2(dxC, j - 1, i) * g.f3(u, j - 1, i))) *
                g.f2(recip_rAz, j, i);
    return hfacz(j, i) == T(0) ? fac * s : s;
  }
  __device__ T uT(int j, int i) const {
    return g.f3(u, j, i) * g.f2(dyG, j, i) * g.f3(hFacW, j, i);
  }
  __device__ T vT(int j, int i) const {
    return g.f3(v, j, i) * g.f2(dxG, j, i) * g.f3(hFacS, j, i);
  }
  __device__ T hdiv(int j, int i) const {
    if (!g.in(j, i)) return T(0);
    return ((uT(j, i + 1) - uT(j, i)) + (vT(j + 1, i) - vT(j, i))) *
           g.f2(recip_rA, j, i) * g.f3(recip_hFacC, j, i);
  }
  __device__ T tension(int j, int i) const {
    if (!g.in(j, i)) return T(0);
    return ((g.f2(dyG, j, i + 1) * g.f3(u, j, i + 1) -
             g.f2(dyG, j, i) * g.f3(u, j, i)) -
            (g.f2(dxG, j + 1, i) * g.f3(v, j + 1, i) -
             g.f2(dxG, j, i) * g.f3(v, j, i))) *
           g.f2(recip_rA, j, i);
  }
  __device__ T ke(int j, int i) const {
    if (!g.in(j, i)) return T(0);
    const T u0 = g.f3(u, j, i), u1 = g.f3(u, j, i + 1);
    const T v0 = g.f3(v, j, i), v1 = g.f3(v, j + 1, i);
    return T(0.25) * ((u0 * u0 + u1 * u1) + (v0 * v0 + v1 * v1));
  }
};

// ---------------------------------------------------------------------------
// Kernel X: mom_calc_visc
// ---------------------------------------------------------------------------

template <typename T>
struct ViscArgs {
  // [nr, nyp, nxp]
  const T *u, *v, *hFacW, *hFacS, *maskW, *maskS, *recip_hFacC;
  // [nyp, nxp]
  const T *dyG, *dxG, *dyC, *dxC, *recip_rA, *recip_rAz, *recip_dxC,
      *recip_dyC, *recip_dxG, *recip_dyG;
  const T *L2_D, *L3_D, *L4rdt_D, *L2_Z, *L3_Z, *L4rdt_Z;
  // outputs [nr, nyp, nxp]; the biharmonic pair null without biharmonic
  // viscosity
  T *viscAh_Z, *viscAh_D, *viscA4_Z, *viscA4_D;
};
constexpr int kViscNumPointers = 27;

// mom_visc.py:factors and the configuration's limits, in the order of
// model/mom_visc.py:x_params
enum ViscParam {
  kSideMaskFac, kReAh, kReA4, kSmag2, kSmag4, kLeith2, kLeithD2, kLeith4,
  kLeithD4, kL2rdtFac, kAhD, kAhZ, kA4D, kA4Z, kAhGrid, kAhGridMin,
  kAhGridMax, kAhMax, kA4Grid, kA4GridMin, kA4GridMax, kA4Max,
  kViscNumParams
};

template <typename T>
struct ViscParams {
  T p[kViscNumParams];
};

// mom_visc.py:limits: the grid-scaled and nonlinear viscosities summed,
// floored by the grid and Reynolds minima, capped by the grid maximum
template <typename T>
__device__ T visc_limits(T base, T Lth, T Smg, T Uscl, T gridVisc, T Lrdt,
                         T gmin, T gmax, T vmax) {
  const T Alin = base + gridVisc * Lrdt + Lth + Smg;
  const T vMin = max_nan(gmin * Lrdt, Uscl);
  const T out = max_nan(vMin, Alin);
  const T vMax = min_nan(gmax * Lrdt, vmax);
  return min_nan(vMax, out);
}

template <typename T>
__device__ __forceinline__ T sq(T x) { return x * x; }

template <typename T>
__device__ __forceinline__ T grad_max(T a, T b, T c, T d) {
  return max_nan(max_nan(fabs(a), fabs(b)),
                 max_nan(fabs(c), fabs(d)));
}

template <typename T>
__device__ __forceinline__ T grad_sq(T a, T b, T c, T d) {
  return T(0.25) * ((sq(a) + sq(b)) + (sq(c) + sq(d)));
}

// Smag: Smagorinsky; Leith: 0 none, 1 Leith, 2 full Leith; Re: the
// Reynolds limits; Bih: the biharmonic viscosities too
template <typename T, bool Smag, int Leith, bool Re, bool Bih>
__global__ void __launch_bounds__(kCellX * kCellY)
    mom_calc_visc_kernel(const ViscArgs<T> a, const ViscParams<T> pr,
                         int nyp, int nxp) {
  GridCell c;
  if (!grid_cell_of(nyp, nxp, c)) return;
  const T* P = pr.p;
  const int j = c.j, i = c.i;
  VelPoint<T> x{{nyp, nxp, static_cast<size_t>(c.k) * nyp * nxp},
                a.u, a.v, a.hFacW, a.hFacS, a.maskW, a.maskS, a.recip_hFacC,
                a.dyG, a.dxG, a.dyC, a.dxC, a.recip_rA, a.recip_rAz,
                P[kSideMaskFac]};
  const Padded<T>& g = x.g;

  // Leith's gradients of the vorticity and the divergence
  T vxN = 0, vx = 0, vyE = 0, vy = 0, vxW = 0, vyS = 0;
  T dxE = 0, dx = 0, dyN = 0, dy = 0, dxS = 0, dyW = 0;
  if (Leith) {
    const T w0 = x.vort(j, i), wE = x.vort(j, i + 1), wN = x.vort(j + 1, i),
            wNE = x.vort(j + 1, i + 1), wW = x.vort(j, i - 1),
            wS = x.vort(j - 1, i);
    // vrtDx = (vort(i+1) - vort) recip_dxG maskS, vrtDy = (vort(j+1) -
    // vort) recip_dyG maskW
    auto vrtDx = [&](int jj, int ii, T e, T o) -> T {
      return g.in(jj, ii) ? (e - o) * g.f2(a.recip_dxG, jj, ii) *
                                g.f3(a.maskS, jj, ii)
                          : T(0);
    };
    auto vrtDy = [&](int jj, int ii, T n, T o) -> T {
      return g.in(jj, ii) ? (n - o) * g.f2(a.recip_dyG, jj, ii) *
                                g.f3(a.maskW, jj, ii)
                          : T(0);
    };
    vx = vrtDx(j, i, wE, w0);
    vxN = vrtDx(j + 1, i, wNE, wN);
    vxW = vrtDx(j, i - 1, w0, wW);
    vy = vrtDy(j, i, wN, w0);
    vyE = vrtDy(j, i + 1, wNE, wE);
    vyS = vrtDy(j - 1, i, w0, wS);
    const T h0 = x.hdiv(j, i), hW = x.hdiv(j, i - 1), hE = x.hdiv(j, i + 1),
            hS = x.hdiv(j - 1, i), hN = x.hdiv(j + 1, i),
            hSW = x.hdiv(j - 1, i - 1);
    // divDx = (hDiv - hDiv(i-1)) recip_dxC, divDy = (hDiv - hDiv(j-1))
    // recip_dyC
    auto divDx = [&](int jj, int ii, T o, T w) -> T {
      return g.in(jj, ii) ? (o - w) * g.f2(a.recip_dxC, jj, ii) : T(0);
    };
    auto divDy = [&](int jj, int ii, T o, T s) -> T {
      return g.in(jj, ii) ? (o - s) * g.f2(a.recip_dyC, jj, ii) : T(0);
    };
    dx = divDx(j, i, h0, hW);
    dxE = divDx(j, i + 1, hE, h0);
    dxS = divDx(j - 1, i, hS, hSW);
    dy = divDy(j, i, h0, hS);
    dyN = divDy(j + 1, i, hN, h0);
    dyW = divDy(j, i - 1, hW, hSW);
  }

  const T ke = x.ke(j, i);
  const size_t p = c.p;
  const T L2rdtFac = P[kL2rdtFac];
  for (int tag = 0; tag < 2; ++tag) {   // 0: the D point, 1: the Z point
    const bool D = tag == 0;
    const T L2 = g.f2(D ? a.L2_D : a.L2_Z, j, i);
    const T L2rdt = L2rdtFac * L2;
    const T L3 = g.f2(D ? a.L3_D : a.L3_Z, j, i);
    const T L4rdt = g.f2(D ? a.L4rdt_D : a.L4rdt_Z, j, i);
    const T L5 = L2 * L3;
    // the grid-Reynolds floors
    T Uscl = 0, U4scl = 0;
    if (Re) {
      if (D) {
        if (P[kReAh] > T(0) && ke > T(0))
          Uscl = sqrt(ke * L2) * P[kReAh];
        if (P[kReA4] > T(0) && ke > T(0))
          U4scl = sqrt(ke) * L3 * P[kReA4];
      } else {
        const T keZ = T(0.25) * ((ke + x.ke(j - 1, i - 1)) +
                                 (x.ke(j, i - 1) + x.ke(j - 1, i)));
        if (keZ > T(0)) {
          Uscl = sqrt(keZ * L2) * P[kReAh];
          U4scl = sqrt(keZ) * L3 * P[kReA4];
        }
      }
    }
    // Leith
    T AhLth = 0, A4Lth = 0;
    if (Leith) {
      T gv, gd;
      if (Leith == 2) {
        gv = D ? grad_sq(vxN, vx, vyE, vy) : grad_sq(vxW, vx, vyS, vy);
        gd = D ? grad_sq(dxE, dx, dyN, dy) : grad_sq(dxS, dx, dyW, dy);
        AhLth = sqrt(P[kLeith2] * gv + P[kLeithD2] * gd) * L3;
        if (Bih) A4Lth = sqrt(P[kLeith4] * gv + P[kLeithD4] * gd) * L5;
      } else {
        gv = D ? grad_max(vxN, vx, vyE, vy) : grad_max(vxW, vx, vyS, vy);
        gd = D ? grad_max(dxE, dx, dyN, dy) : grad_max(dxS, dx, dyW, dy);
        AhLth = (P[kLeith2] * gv + P[kLeithD2] * gd) * L3;
        if (Bih) A4Lth = (P[kLeith4] * gv + P[kLeithD4] * gd) * L5;
      }
    }
    // Smagorinsky
    T AhSmg = 0, A4Smg = 0;
    if (Smag) {
      T s;
      if (D) {
        s = sq(x.tension(j, i)) +
            T(0.25) * (sq(x.strain(j, i + 1)) + sq(x.strain(j + 1, i)) +
                       sq(x.strain(j, i)) + sq(x.strain(j + 1, i + 1)));
      } else {
        s = sq(x.strain(j, i)) +
            T(0.25) * (sq(x.tension(j, i)) + sq(x.tension(j - 1, i)) +
                       sq(x.tension(j, i - 1)) +
                       sq(x.tension(j - 1, i - 1)));
      }
      const T base = L2 * sqrt(s);
      AhSmg = P[kSmag2] * base;
      A4Smg = P[kSmag4] * L2 * base;
    }
    const T Ah = visc_limits(D ? P[kAhD] : P[kAhZ], AhLth, AhSmg, Uscl,
                             P[kAhGrid], L2rdt, P[kAhGridMin],
                             P[kAhGridMax], P[kAhMax]);
    (D ? a.viscAh_D : a.viscAh_Z)[p] = Ah;
    if (Bih) {
      const T A4 = visc_limits(D ? P[kA4D] : P[kA4Z], A4Lth, A4Smg, U4scl,
                               P[kA4Grid], L4rdt, P[kA4GridMin],
                               P[kA4GridMax], P[kA4Max]);
      (D ? a.viscA4_D : a.viscA4_Z)[p] = A4;
    }
  }
}

// Kernel X's launch: the table's and the flags' checks, the variant;
// start(kernel, grid, block, args...) starts it (OnStream on the card).
template <typename T, typename Start>
int launch_calc_visc(const void* const* table, int n, const double* params,
                     int n_params, int nr, int nyp, int nxp, int smag,
                     int leith, int re, int bih, Start start) {
  static_assert(sizeof(ViscArgs<T>) == kViscNumPointers * sizeof(void*),
                "ViscArgs must be a plain table of pointers");
  if (n != kViscNumPointers || n_params != kViscNumParams || nr < 1 ||
      nyp < 1 || nxp < 1 || smag < 0 || smag > 1 || leith < 0 ||
      leith > 2 || re < 0 || re > 1 || bih < 0 || bih > 1)
    return (int)cudaErrorInvalidValue;
  ViscArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  if (!a.viscAh_Z || !a.viscAh_D ||
      (bih != 0) != (a.viscA4_Z != nullptr && a.viscA4_D != nullptr) ||
      (!bih && (a.viscA4_Z || a.viscA4_D)))
    return (int)cudaErrorInvalidValue;
  ViscParams<T> pr;
  for (int t = 0; t < kViscNumParams; ++t) pr.p[t] = T(params[t]);
  const dim3 grid = cell_grid(nr, nyp, nxp), block(kCellX, kCellY);
  auto run = [&](auto kernel) { start(kernel, grid, block, a, pr, nyp, nxp); };
  auto by_bih = [&](auto s, auto l, auto r) {
    constexpr bool S = decltype(s)::value, R = decltype(r)::value;
    constexpr int L = decltype(l)::value;
    if (bih)
      run(mom_calc_visc_kernel<T, S, L, R, true>);
    else
      run(mom_calc_visc_kernel<T, S, L, R, false>);
  };
  auto by_re = [&](auto s, auto l) {
    if (re)
      by_bih(s, l, std::true_type{});
    else
      by_bih(s, l, std::false_type{});
  };
  auto by_leith = [&](auto s) {
    if (leith == 0)
      by_re(s, std::integral_constant<int, 0>{});
    else if (leith == 1)
      by_re(s, std::integral_constant<int, 1>{});
    else
      by_re(s, std::integral_constant<int, 2>{});
  };
  if (smag)
    by_leith(std::true_type{});
  else
    by_leith(std::false_type{});
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel Y: mom_del2uv
// ---------------------------------------------------------------------------

template <typename T>
struct Del2Args {
  // [nr, nyp, nxp]
  const T *u, *v, *hFacC, *hFacW, *hFacS, *maskW, *maskS, *recip_hFacC,
      *recip_hFacW, *recip_hFacS;
  // [nyp, nxp]: the flux form's, then the vector-invariant form's
  const T *dyF, *dxF, *recip_dxF, *recip_dyF, *dxV, *dyU, *recip_dxV,
      *recip_dyU, *recip_rAw, *recip_rAs;
  const T *dyG, *dxG, *dyC, *dxC, *recip_rA, *recip_rAz, *recip_dxC,
      *recip_dyC, *recip_dxG, *recip_dyG;
  // [nr] (flux form)
  const T *drF, *recip_drF;
  // outputs [nr, nyp, nxp]
  T *del2u, *del2v;
};
constexpr int kDel2NumPointers = 34;

// the flux form's Laplacian (mom_fluxform.py:_del2uv, mom_u_del2u.F and
// mom_v_del2v.F) with the closed-wall term times `closed` (1 under no-slip
// sides, 0 else)
template <typename T>
__global__ void __launch_bounds__(kCellX * kCellY)
    mom_del2uv_flux_kernel(const Del2Args<T> a, int nyp, int nxp, T closed) {
  GridCell c;
  if (!grid_cell_of(nyp, nxp, c)) return;
  const Padded<T> g{nyp, nxp, static_cast<size_t>(c.k) * nyp * nxp};
  const int j = c.j, i = c.i, k = c.k;
  const T drF = a.drF[k], rdrF = a.recip_drF[k];
  auto hz = [&](int jj, int ii) -> T {
    return padded_hfacz(g, a.hFacW, a.hFacS, a.maskW, a.maskS, jj, ii);
  };
  auto U = [&](int jj, int ii) -> T { return g.f3(a.u, jj, ii); };
  auto V = [&](int jj, int ii) -> T { return g.f3(a.v, jj, ii); };
  auto fZon = [&](int jj, int ii) -> T {
    if (!g.in(jj, ii)) return T(0);
    return drF * g.f3(a.hFacC, jj, ii) * g.f2(a.dyF, jj, ii) *
           g.f2(a.recip_dxF, jj, ii) * (U(jj, ii + 1) - U(jj, ii));
  };
  auto fMer = [&](int jj, int ii) -> T {
    if (!g.in(jj, ii)) return T(0);
    return drF * hz(jj, ii) * g.f2(a.dxV, jj, ii) *
           g.f2(a.recip_dyU, jj, ii) * (U(jj, ii) - U(jj - 1, ii));
  };
  auto fZonV = [&](int jj, int ii) -> T {
    if (!g.in(jj, ii)) return T(0);
    return drF * hz(jj, ii) * g.f2(a.dyU, jj, ii) *
           g.f2(a.recip_dxV, jj, ii) * (V(jj, ii) - V(jj, ii - 1));
  };
  auto fMerV = [&](int jj, int ii) -> T {
    if (!g.in(jj, ii)) return T(0);
    return drF * g.f3(a.hFacC, jj, ii) * g.f2(a.dxF, jj, ii) *
           g.f2(a.recip_dyF, jj, ii) * (V(jj + 1, ii) - V(jj, ii));
  };
  const size_t p = c.p;
  const T hz0 = hz(j, i);
  const T rhW = a.recip_hFacW[p], rhS = a.recip_hFacS[p];
  const T rrAw = g.f2(a.recip_rAw, j, i), rrAs = g.f2(a.recip_rAs, j, i);
  const T mW = a.maskW[p], mS = a.maskS[p];
  const T hW = a.hFacW[p], hS = a.hFacS[p];
  T d2u = rhW * rdrF * rrAw *
          ((fZon(j, i) - fZon(j, i - 1)) + (fMer(j + 1, i) - fMer(j, i))) *
          mW;
  d2u = d2u - (rhW * rdrF * rrAw *
               ((hW - hz0) * g.f2(a.dxV, j, i) * g.f2(a.recip_dyU, j, i) +
                (hW - hz(j + 1, i)) * g.f2(a.dxV, j + 1, i) *
                    g.f2(a.recip_dyU, j + 1, i)) *
               drF * T(2) * U(j, i) * closed) *
                  mW;
  T d2v = rhS * rdrF * rrAs *
          ((fZonV(j, i + 1) - fZonV(j, i)) + (fMerV(j, i) - fMerV(j - 1, i))) *
          mS;
  d2v = d2v - (rhS * rdrF * rrAs *
               ((hS - hz0) * g.f2(a.dyU, j, i) * g.f2(a.recip_dxV, j, i) +
                (hS - hz(j, i + 1)) * g.f2(a.dyU, j, i + 1) *
                    g.f2(a.recip_dxV, j, i + 1)) *
               drF * T(2) * V(j, i) * closed) *
                  mS;
  a.del2u[p] = d2u;
  a.del2v[p] = d2v;
}

// the vector-invariant form's Laplacian from the divergence and hFacZ times
// the vorticity (mom_vecinv.py:del2uv_plain, mom_vi_del2uv.F)
template <typename T>
__global__ void __launch_bounds__(kCellX * kCellY)
    mom_del2uv_vi_kernel(const Del2Args<T> a, int nyp, int nxp,
                         T sideMaskFac) {
  GridCell c;
  if (!grid_cell_of(nyp, nxp, c)) return;
  const VelPoint<T> x{{nyp, nxp, static_cast<size_t>(c.k) * nyp * nxp},
                      a.u, a.v, a.hFacW, a.hFacS, a.maskW, a.maskS,
                      a.recip_hFacC, a.dyG, a.dxG, a.dyC, a.dxC, a.recip_rA,
                      a.recip_rAz, sideMaskFac};
  const int j = c.j, i = c.i;
  auto hv = [&](int jj, int ii) -> T {
    return x.g.in(jj, ii) ? x.hfacz(jj, ii) * x.vort(jj, ii) : T(0);
  };
  const size_t p = c.p;
  const T h0 = x.hdiv(j, i), hv0 = hv(j, i);
  a.del2u[p] = ((h0 - x.hdiv(j, i - 1)) * a.recip_dxC[c.q] -
                a.recip_hFacW[p] * (hv(j + 1, i) - hv0) * a.recip_dyG[c.q]) *
               a.maskW[p];
  a.del2v[p] = ((h0 - x.hdiv(j - 1, i)) * a.recip_dyC[c.q] +
                a.recip_hFacS[p] * (hv(j, i + 1) - hv0) * a.recip_dxG[c.q]) *
               a.maskS[p];
}

// Kernel Y's launch: vi 0 the flux form (param: the closed-wall factor),
// 1 the vector-invariant form (param: sideMaskFac); the other form's
// pointers may be null.
template <typename T, typename Start>
int launch_del2uv(const void* const* table, int n, int nr, int nyp, int nxp,
                  int vi, double param, Start start) {
  static_assert(sizeof(Del2Args<T>) == kDel2NumPointers * sizeof(void*),
                "Del2Args must be a plain table of pointers");
  if (n != kDel2NumPointers || nr < 1 || nyp < 1 || nxp < 1 || vi < 0 ||
      vi > 1)
    return (int)cudaErrorInvalidValue;
  Del2Args<T> a;
  std::memcpy(&a, table, sizeof(a));
  const bool flux_ok = a.hFacC && a.recip_hFacS && a.dyF && a.recip_rAs &&
                       a.drF && a.recip_drF;
  const bool vi_ok = a.recip_hFacC && a.recip_hFacW && a.recip_hFacS &&
                     a.dyG && a.recip_dyG;
  if (!a.u || !a.v || !a.del2u || !a.del2v || (vi ? !vi_ok : !flux_ok))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = cell_grid(nr, nyp, nxp), block(kCellX, kCellY);
  if (vi)
    start(mom_del2uv_vi_kernel<T>, grid, block, a, nyp, nxp, T(param));
  else
    start(mom_del2uv_flux_kernel<T>, grid, block, a, nyp, nxp, T(param));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
