// G9's ggl90_col: the GGL90 column of one (j, i) of the padded plane, in
// passes over the levels that keep two values a level in shared memory
// and none in per-thread arrays; and its launch. Included by ggl90.cu,
// whose entry points start it on the card, and by the host check of the
// tests, which runs it on the CPU.
//
// One thread walks one column, i fastest across a block's threads so that
// every level's loads and stores are coalesced. The levels are coupled by
// the mixing length's two sweeps and by the Thomas solve, so the column is
// walked three times:
//  1. up, from the bottom (mxlMaxFlag 2 and 3 only): the raw buoyancy
//     mixing length from tke and sigmaR, and the sweep from the bottom,
//     whose value at level k is kept in slot A[k];
//  2. down, from the surface: the raw length again from the same loads in
//     the same expression, the sweep from the surface (in a register), the
//     limiter, Langmuir's length, MLtmp and 1/MLtmp, the viscosities, the
//     shear, the Prandtl number and the sources, with visctmp and diffKr
//     written; then the forward elimination of the Thomas solve, one row
//     behind: row k-1's coef_c reads KappaE at min(k, klowC-1), so level k
//     is formed before row k-1 is eliminated (the level klowC-1 is kept in
//     a register as the walk passes it); row k-1's multiplier goes to slot
//     B[k-1] and its eliminated right-hand side to A[k-1], whose swept
//     length level k-1 has read;
//  3. up: the back substitution, the TKE floor, tke' written.
// Each pass reads each input once a level: sqrt(tke) and mskLoc are formed
// once a level, the level above's u, v, maskC, recip_hFacC and hFacC are
// carried in registers, and the next level's loads are issued before a
// level is computed. The two slots a level live in dynamic shared memory,
// [2][nr][the block's 32 columns], so nr is bounded only by a block's
// shared memory (ggl90_max_nr).
//
// Each expression keeps the twin's (and the JAX code's) operation order, and
// exp and sqrt are the CUDA math library's, which PyTorch's elementwise
// kernels call; built with --fmad=false the outputs are bit-equal to the
// twin (model/ggl90.py:_ggl90_col_plain). IDEMIX and Langmuir are template
// flags. The discrete choices (the Prandtl switch Ri >= 0.2 or IDEMIX's
// clip to [1, 10], Langmuir's equality test ML == its limit, the bottom
// level klowC-1 of the Dirichlet fold and of the kp1 clip, the zero-pivot
// rule) follow the JAX code's semantics.
#pragma once

#include <cstring>

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct Ggl90Args {
  // [nr, nyp, nxp]
  const T *u, *v, *tke, *sigmaR, *maskC, *recip_hFacC;
  // [nr, nyp, nxp], read with IDEMIX only: hFacC (for 1/hFacI) and IDEMIX's
  // TKE source
  const T *hFacC, *gTKE;
  // [nyp, nxp]: the surface stress / rhoConst, the column's surface and
  // bottom r
  const T *sfU, *sfV, *Ro_surf, *R_low;
  // [nr], [nr], [nr+1], [nr+1]
  const T *drF, *recip_drF, *recip_drC, *rF;
  // [nyp, nxp]: the number of wet levels of each column
  const int* klowC;
  // outputs [nr, nyp, nxp]
  T *tkeNew, *diffKr, *visctmp;
};
constexpr int kGgl90Pointers = 20;

// the scalars, in the order of model/ggl90.py:ggl90_col
struct Ggl90Params {
  double dt, nsqFac, sqrtTwo, eps, mlMin, ck, diffKrS, viscAr, alpha,
      dtCeps, m2, tkeSurfMin, tkeBottom, tkeMin, diffMax, lcGamma, recipLD,
      recipLasq;
};
constexpr int kGgl90Params = 18;

// torch.minimum / maximum (a NaN in either gives NaN) and torch.clamp
template <typename T>
__device__ __forceinline__ T g9min(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T g9max(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// The columns a block walks: one warp (at 1024 x 1024 x 32 float32 on an
// H100, 64 and 128 were up to 1 % slower and 256 16-18 %,
// probe_ggl90_col.py).
constexpr int kG9Columns = 32;
// The most levels a launch takes: a block's slots within max_shared bytes.
inline int ggl90_max_nr(size_t max_shared, size_t bytes) {
  return static_cast<int>(max_shared / (2 * kG9Columns * bytes));
}

// the levels of a group of the up passes, whose loads are in flight
// together
constexpr int kG9Group = 4;

// the down pass' global loads of level k, issued while level k-1 is
// computed
template <typename T>
struct G9Level {
  T tke = T(0), sig = T(0), mC = T(0), u = T(0), v = T(0), uE = T(0),
    vN = T(0), rhC = T(0), hC = T(0), gT = T(0);
};

template <typename T, bool IDEMIX, bool LANGMUIR>
__global__ void ggl90_col_kernel(const Ggl90Args<T> a, const Ggl90Params q,
                                 int nr, int nyp, int nxp, int flag,
                                 bool meanShear, bool dirichlet) {
  constexpr int C = kG9Columns;
  const int c = threadIdx.x, col = blockIdx.x * C + c;
  const int plane = nyp * nxp;
  if (col >= plane) return;
  // the column's slots: A[k] the swept length, then row k's eliminated
  // right-hand side; B[k] row k's multiplier
  T* const A = dynamic_shared<T>() + c;
  T* const B = A + static_cast<size_t>(nr) * C;
  const int j = col / nxp, i = col - j * nxp;
  const size_t P = static_cast<size_t>(plane);
  const bool hasE = i + 1 < nxp, hasN = j + 1 < nyp;
  const T dt = T(q.dt), mlMin = T(q.mlMin), eps = T(q.eps);
  const T nsqFac = T(q.nsqFac), sqrtTwo = T(q.sqrtTwo);
  // the raw buoyancy mixing length of a level below the surface
  auto raw = [&](T st, T sig, T msk) -> T {
    return sqrtTwo * st / sqrt(g9max(nsqFac * sig, eps)) * msk;
  };

  // ---- 1. up: the sweep from the bottom (flags 2 and 3) ----
  // The levels go up in groups of kG9Group: the next group's tke, sigmaR
  // and maskC of the level above are loaded while this group is computed.
  if (flag >= 2) {
    T tg[kG9Group], sg[kG9Group], mg[kG9Group];
    auto load_up = [&](int top) {
#pragma unroll
      for (int d = 0; d < kG9Group; ++d) {
        const int k = top - d;
        tg[d] = sg[d] = mg[d] = T(0);
        if (k >= 1) {
          const size_t p = static_cast<size_t>(k) * P + col;
          tg[d] = a.tke[p], sg[d] = a.sigmaR[p], mg[d] = a.maskC[p - P];
        }
      }
    };
    T mk = a.maskC[(nr - 1) * P + col], up = T(0);
    load_up(nr - 1);
    for (int top = nr - 1; top >= 1; top -= kG9Group) {
      T tc[kG9Group], sc[kG9Group], mc[kG9Group];
#pragma unroll
      for (int d = 0; d < kG9Group; ++d)
        tc[d] = tg[d], sc[d] = sg[d], mc[d] = mg[d];
      load_up(top - kG9Group);
#pragma unroll
      for (int d = 0; d < kG9Group; ++d) {
        const int k = top - d;
        if (k < 1) break;
        const T mlr = raw(sqrt(tc[d]), sc[d], mk * mc[d]);
        up = k == nr - 1 ? g9min(mlr, mlMin + a.drF[nr - 1])
                         : g9min(mlr, up + a.drF[k]);
        A[static_cast<size_t>(k) * C] = up;
        mk = mc[d];
      }
    }
  }

  // ---- 2. down: the column's mixing, then the elimination a row behind ----
  T Ro = T(0), Rl = T(0);
  if (flag < 2) Ro = a.Ro_surf[col], Rl = a.R_low[col];
  // Langmuir's Stokes drift: u* = sign(sfU) sqrt|sfU| here and one cell
  // east (0 past the array's edge), v* here and one cell north
  auto ustar = [](T s) -> T {
    return T((T(0) < s) - (s < T(0))) * sqrt(fabs(s));
  };
  T uS = T(0), uSe = T(0), vS = T(0), vSn = T(0);
  const T sU = a.sfU[col], sV = a.sfV[col];
  const T sUe = hasE ? a.sfU[col + 1] : T(0);
  const T sVn = hasN ? a.sfV[col + nxp] : T(0);
  if constexpr (LANGMUIR) {
    uS = ustar(sU);
    vS = ustar(sV);
    if (hasE) uSe = ustar(sUe);
    if (hasN) vSn = ustar(sVn);
  }
  // the surface value, folded into row 1 (ggl90.py:540-543)
  T usq;
  if (meanShear) {
    usq = ((sU * sU + sUe * sUe) + (sV * sV + sVn * sVn)) * T(0.5);
  } else {
    const T ua = T(0.5) * (sU + sUe), va = T(0.5) * (sV + sVn);
    usq = ua * ua + va * va;
  }
  const T tkeSurf = g9max(T(q.m2) * sqrt(usq), T(q.tkeSurfMin));
  const int klow = a.klowC[col];
  const int kBot = klow - 1 > 0 ? klow - 1 : 0;

  auto load = [&](int k) {
    G9Level<T> L;
    const size_t p = static_cast<size_t>(k) * P + col;
    L.tke = a.tke[p], L.mC = a.maskC[p], L.u = a.u[p], L.v = a.v[p];
    L.rhC = a.recip_hFacC[p];
    if (k > 0) L.sig = a.sigmaR[p];
    if (hasE) L.uE = a.u[p + 1];
    if (hasN) L.vN = a.v[p + nxp];
    if constexpr (IDEMIX) {
      L.hC = a.hFacC[p];
      if (k > 0) L.gT = a.gTKE[p];
    }
    return L;
  };

  // the level above's values
  T mCm = T(0), um = T(0), uEm = T(0), vm = T(0), vNm = T(0), rhCm = T(0),
    hCm = T(0), rmlD = mlMin;
  // the row waiting for its elimination (row k-1 at level k): KappaE at it
  // and at max(k-2, 1), its coefficients' factors before and after the
  // KappaE sum, its diagonal's dissipation term and its right-hand side
  T KEr = T(0), KEa = T(0), pa = T(0), pc = T(0), rdrCr = T(0), mCr = T(0),
    mCmr = T(0), rhIr = T(0), dr = T(0), yr = T(0);
  T KEb = T(0);   // KappaE at max(klowC-1, 0)
  T tke1 = T(0);
  T cpm1 = T(0), ypm1 = T(0);
  // eliminate row r with KappaE at its kp1 (solve_tridiagonal.F on the
  // folded system)
  auto eliminate = [&](int r, T KEp1) {
    T ak = T(0), ck = T(0);
    if (r > 0) {
      ak = pa * (KEr + KEa) * rdrCr * mCr;
      ck = pc * (KEr + KEp1) * rdrCr * mCmr;
      if constexpr (IDEMIX) {
        ak = ak * rhIr;
        ck = ck * rhIr;
      }
      if (!dirichlet && r == kBot) ck = T(0);
    }
    const T bk = T(1) - ck - ak + dr;
    T yk = yr;
    if (r == 0) yk = tke1;
    if (r == 1) {
      yk = yk + -ak * tke1;
      ak = T(0);
    }
    if (dirichlet && r == kBot) {
      yk = yk - T(q.tkeBottom) * ck;
      ck = T(0);
    }
    const T den = bk - ak * cpm1;
    const T rec = den != T(0) ? T(1) / den : T(0);
    cpm1 = ck * rec;
    ypm1 = (yk - ak * ypm1) * rec;
  };

  G9Level<T> cur = load(0);
  for (int k = 0; k < nr; ++k) {
    G9Level<T> nxt;
    if (k + 1 < nr) nxt = load(k + 1);
    const size_t p = static_cast<size_t>(k) * P + col;
    const T st = sqrt(cur.tke);
    const T msk = cur.mC * (k > 0 ? mCm : cur.mC);
    const T nsqk = k == 0 ? T(0) : nsqFac * cur.sig;
    if (k == 0) tke1 = cur.mC * tkeSurf;

    // the mixing length the mixing uses, and 1 / MLtmp (ggl90.py:109-206)
    T mlUse = mlMin, rInv = T(0);
    if (k > 0) {
      const T mlr = raw(st, cur.sig, msk);
      T ml;
      if (flag >= 2) {
        rmlD = g9min(mlr, rmlD + a.drF[k - 1]);
        ml = g9min(A[static_cast<size_t>(k) * C], rmlD);
      } else if (flag == 1) {
        ml = g9min(mlr, g9min(Ro - a.rF[k], a.rF[k] - Rl));
      } else {
        ml = g9min(mlr, Ro - Rl);
      }
      T lcml = ml;
      if constexpr (LANGMUIR) {
        // LC_Gamma ML where ML reached its limit (an exact comparison, as
        // in the JAX code), clipped below by MLmin for flags 1 and 2
        const bool atMax = flag == 1 ? ml == Ro - a.rF[k] : ml == rmlD;
        if (atMax) lcml = T(q.lcGamma) * ml;
        if (flag != 3) lcml = g9max(lcml, mlMin);
      }
      const T mlTmp = flag == 3 ? g9max(sqrt(ml * rmlD), mlMin)
                                : g9max(ml, mlMin);
      mlUse = LANGMUIR ? lcml : flag != 3 ? mlTmp : ml;
      rInv = T(1) / mlTmp;
    }

    // viscosities, shear, Prandtl number, sources (ggl90.py:386-470)
    T kappaM = T(q.ck) * mlUse * st;
    const T visc = g9max(kappaM, T(q.diffKrS)) * msk;
    kappaM = g9max(kappaM, T(q.viscAr)) * msk;
    T shear2 = T(0), stokes = T(0), rdrC = T(0);
    if (k > 0) {
      rdrC = a.recip_drC[k];
      // the Stokes drift's profile at this interface (ggl90.py:443-451)
      T dU = T(0), dUe = T(0), dV = T(0), dVn = T(0);
      if constexpr (LANGMUIR) {
        const T recipLD = T(q.recipLD);
        const T depthFac = T(q.recipLasq) * exp(recipLD * a.rF[k]);
        dU = recipLD * uS * depthFac;
        dV = recipLD * vS * depthFac;
        if (hasE) dUe = recipLD * uSe * depthFac;
        if (hasN) dVn = recipLD * vSn * depthFac;
      }
      if (meanShear) {
        const T du = um - cur.u, dup = uEm - cur.uE;
        const T dv = vm - cur.v, dvp = vNm - cur.vN;
        shear2 = ((du * du + dup * dup) + (dv * dv + dvp * dvp)) * T(0.5) *
                 (rdrC * rdrC);
        if constexpr (LANGMUIR)
          stokes = ((du * dU + dup * dUe) + (dv * dV + dvp * dVn)) * T(0.5) *
                   rdrC;
      } else {
        const T ucm = T(0.5) * (um + uEm), uc = T(0.5) * (cur.u + cur.uE);
        const T vcm = T(0.5) * (vm + vNm), vc = T(0.5) * (cur.v + cur.vN);
        const T du = (ucm - uc) * rdrC, dv = (vcm - vc) * rdrC;
        shear2 = du * du + dv * dv;
        if constexpr (LANGMUIR)
          stokes = T(0.5) * (du * (dU + dUe) + dv * (dV + dVn));
      }
    }
    T pr = T(1);
    if (k > 0) {
      const T ri = g9max(nsqk, T(0)) / (shear2 + eps);
      if constexpr (IDEMIX) {
        // IDEMIX's Prandtl number (ggl90.py:423-428)
        const T iri = g9max(kappaM * nsqk, T(0)) / (eps + cur.gT);
        pr = g9max(g9min(T(6.6) * g9min(ri, iri), T(10.0)), T(1));
      } else {
        pr = g9min(ri >= T(0.2) ? T(5.0) * ri : T(1), T(10.0));
      }
    }
    const T kappaH = kappaM / pr;
    const T KE = T(q.alpha) * kappaM * msk;   // KappaE
    T rhs = cur.tke;
    if (k > 0) {
      rhs = cur.tke + dt * (kappaM * shear2 - kappaH * nsqk);
      if constexpr (IDEMIX) rhs = rhs + dt * cur.gT;
      if constexpr (LANGMUIR) rhs = rhs + dt * kappaM * stokes;
    }
    a.visctmp[p] = visc;
    a.diffKr[p] =
        k == 0 ? T(0) : g9max(g9min(visc / pr, T(q.diffMax)), T(q.diffKrS));

    // row k-1, now that KappaE at its kp1 = max(min(k, klowC-1), 0) is
    // formed
    if (k == kBot) KEb = KE;
    if (k > 0) {
      eliminate(k - 1, k <= klow - 1 ? KE : KEb);
      B[static_cast<size_t>(k - 1) * C] = cpm1;
      A[static_cast<size_t>(k - 1) * C] = ypm1;
    }
    // row k waits: its coefficients' factors (coef_a, coef_c)
    KEa = k >= 2 ? KEr : KE;
    KEr = KE;
    if (k > 0) {
      pa = -dt * a.recip_drF[k - 1] * rhCm * T(0.5);
      pc = -dt * a.recip_drF[k] * cur.rhC * T(0.5);
      rdrCr = rdrC, mCr = cur.mC, mCmr = mCm;
      if constexpr (IDEMIX) {
        // 1/hFacI of the interface (0 where closed)
        const T hI = g9min(hCm, T(0.5)) + g9min(cur.hC, T(0.5));
        rhIr = hI != T(0) ? T(1) / hI : T(0);
      }
    }
    dr = T(q.dtCeps) * st * rInv * msk;
    yr = rhs;
    mCm = cur.mC, um = cur.u, uEm = cur.uE, vm = cur.v, vNm = cur.vN;
    rhCm = cur.rhC, hCm = cur.hC;
    cur = nxt;
  }
  // the bottom row: its kp1 is max(klowC-1, 0)
  eliminate(nr - 1, KEb);

  // ---- 3. up: back substitution and the TKE floor below the surface ----
  // in groups of kG9Group levels, the next group's maskC of the level
  // above loaded while this group is computed
  T x = ypm1, mk = mCm;
  T mg[kG9Group];
  auto load_back = [&](int top) {
#pragma unroll
    for (int d = 0; d < kG9Group; ++d) {
      const int k = top - d;
      mg[d] = k >= 1 ? a.maskC[static_cast<size_t>(k - 1) * P + col] : T(0);
    }
  };
  load_back(nr - 1);
  for (int top = nr - 1; top >= 1; top -= kG9Group) {
    T mc[kG9Group];
#pragma unroll
    for (int d = 0; d < kG9Group; ++d) mc[d] = mg[d];
    load_back(top - kG9Group);
#pragma unroll
    for (int d = 0; d < kG9Group; ++d) {
      const int k = top - d;
      if (k < 1) break;
      if (k < nr - 1)
        x = A[static_cast<size_t>(k) * C] - B[static_cast<size_t>(k) * C] * x;
      a.tkeNew[static_cast<size_t>(k) * P + col] =
          mk * mc[d] * g9max(x, T(q.tkeMin));
      mk = mc[d];
    }
  }
  a.tkeNew[col] = A[0] - B[0] * x;
}

// G9's ggl90_col launch from its entry point's arguments: the tables' and
// the flags' checks, the columns a block and its shared memory, and the
// variant the flags pick; start.shared(kernel, bytes, grid, block, args...)
// starts it (OnStream on the card), start.max_shared() is the card's limit
// of a block's shared memory.
template <typename T, typename Start>
int launch_ggl90_col(const void* const* table, int n, const double* params,
                     int np, int nr, int nyp, int nxp, int flag,
                     int meanShear, int dirichlet, int idemix, int langmuir,
                     Start start) {
  static_assert(sizeof(Ggl90Args<T>) == kGgl90Pointers * sizeof(void*),
                "Ggl90Args must be a plain table of pointers");
  static_assert(sizeof(Ggl90Params) == kGgl90Params * sizeof(double),
                "Ggl90Params must be a plain array of doubles");
  if (n != kGgl90Pointers || np != kGgl90Params || nr < 2 ||
      nr > ggl90_max_nr(start.max_shared(), sizeof(T)) || nyp < 1 ||
      nxp < 1 || flag < 0 || flag > 3)
    return (int)cudaErrorInvalidValue;
  Ggl90Args<T> a;
  std::memcpy(&a, table, sizeof(a));
  Ggl90Params q;
  std::memcpy(&q, params, sizeof(q));
  const size_t bytes = 2 * static_cast<size_t>(nr) * kG9Columns * sizeof(T);
  const long long plane = static_cast<long long>(nyp) * nxp;
  const dim3 grid(static_cast<unsigned>((plane + kG9Columns - 1) /
                                        kG9Columns)),
      block(kG9Columns);
  const bool ms = meanShear != 0, dc = dirichlet != 0;
  auto run = [&](auto kernel) {
    start.shared(kernel, bytes, grid, block, a, q, nr, nyp, nxp, flag, ms,
                 dc);
  };
  if (idemix && langmuir)
    run(ggl90_col_kernel<T, true, true>);
  else if (idemix)
    run(ggl90_col_kernel<T, true, false>);
  else if (langmuir)
    run(ggl90_col_kernel<T, false, true>);
  else
    run(ggl90_col_kernel<T, false, false>);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
