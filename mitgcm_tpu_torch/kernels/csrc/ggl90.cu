// Kernel G9: GGL90 TKE vertical mixing (Gaspar, Gregoris & Lefevre 1990),
// with IDEMIX's TKE source and the Langmuir parameterization.
//
// Replaces: mitgcm_tpu/model/ggl90.py:GGL90.calc (:358-574) in
// z-coordinates, with GGL90.mixinglength (:109-206) and solve_tridiagonal
// (:590-612), which XLA ran as fused passes over [nr, nyp, nxp] arrays and
// two lax.scan's over the levels. IDEMIX itself (GGL90.idemix) is kernel
// H-IDEMIX (idemix.cu), which runs first and hands this kernel its TKE
// source gTKE.
//
// Two launches per step:
//   ggl90_col  one thread per (j, i) column of the whole padded plane: Nsq
//              from sigmaR, the buoyancy mixing length with its mxlMaxFlag
//              limiter (the down and up sweeps of flags 2 and 3) and, with
//              Langmuir, the length LCML the mixing uses (LC_Gamma times ML
//              where the limiter set ML, :178-196), KappaM and visctmp, the
//              vertical shear (either calcMeanVertShear branch), the
//              Richardson and Prandtl numbers (with IDEMIX its own Prandtl
//              number, :423-428), the explicit TKE sources (with IDEMIX's
//              gTKE and the Stokes-drift production, :441-465), the
//              tridiagonal coefficients (with IDEMIX scaled by 1/hFacI,
//              :474) with the surface and bottom Dirichlet folds (or the
//              Neumann bottom), the Thomas solve with its zero-pivot rule, the
//              TKE floor and diffKr.
//   ggl90_visc one thread per cell: viscArU / viscArV, the averages of
//              visctmp to U and V points with their clips (:560-569).
//
// Bound: bytes. ggl90_col reads 6 3-D fields (u, v, tke, sigmaR, maskC,
// recip_hFacC; 8 with IDEMIX's hFacC and gTKE; the u(i+1), v(j+1)
// neighbours hit L1/L2) and writes 3 (tke', diffKr, visctmp), ~36 B/cell in
// float32, for ~120 flops (~150 and one exp per level with Langmuir) and two
// divisions and square roots per cell; ggl90_visc reads 3 fields and writes
// 2. Design: a column's levels are coupled (the sweeps, the tridiagonal
// solve), so one thread walks one column, i fastest so that every level's
// loads and stores are coalesced. The mixing length (then LCML, then
// KappaE), the right-hand side and the sweep's multipliers live in
// per-thread arrays of length kMaxNr (local memory, cached in L1/L2); the
// wrapper refuses a larger nr. Columns outside the interior are computed
// like the interior ones, with zero for neighbours outside the padded array,
// exactly as the JAX code's zero-filled shifts do; so every output cell,
// halos included, is the plain twin's. Each expression keeps the twin's (and
// the JAX code's) operation order, and exp and sqrt are the CUDA math
// library's, which PyTorch's elementwise kernels call; built with
// --fmad=false the outputs are bit-equal to the twins
// (model/ggl90.py:_ggl90_col_plain, _ggl90_visc_plain). IDEMIX and Langmuir
// are template flags, so the kernel without them compiles to the code it
// was before them. The
// discrete choices (the Prandtl switch Ri >= 0.2 or IDEMIX's clip to [1,
// 10], Langmuir's equality test ML == its limit, the bottom level klowC-1
// of the Dirichlet fold and of the kp1 clip, the zero-pivot rule) follow the
// JAX code's semantics.

#include <cstring>

#include "common.cuh"

namespace mitgcm {

constexpr int kMaxNr = 64;   // model/ggl90.py:MAX_NR

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
__device__ __forceinline__ T tmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}

template <typename T, bool IDEMIX, bool LANGMUIR>
__global__ void ggl90_col_kernel(const Ggl90Args<T> a, const Ggl90Params q,
                                 int nr, int nyp, int nxp, int flag,
                                 bool meanShear, bool dirichlet) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int plane = nyp * nxp;
  if (col >= plane) return;
  const int j = col / nxp, i = col - j * nxp;
  const size_t P = static_cast<size_t>(plane);
  const bool hasE = i + 1 < nxp, hasN = j + 1 < nyp;
  const T dt = T(q.dt), mlMin = T(q.mlMin), eps = T(q.eps);
  // per-level arrays: ml holds the mixing length (with Langmuir then
  // LCML), then KappaE; rml the down sweep, then 1/MLtmp; rhs the
  // right-hand side, then yp; cp the sweep's multipliers
  T ml[kMaxNr], rml[kMaxNr], rhs[kMaxNr], cp[kMaxNr];

  auto mskLoc = [&](int k) -> T {
    return a.maskC[k * P + col] * a.maskC[(k > 0 ? k - 1 : 0) * P + col];
  };
  auto nsq = [&](int k) -> T {
    return k == 0 ? T(0) : T(q.nsqFac) * a.sigmaR[k * P + col];
  };

  // the buoyancy mixing length, and the down sweep of flags 2 and 3
  ml[0] = mlMin;
  rml[0] = mlMin;
  for (int k = 1; k < nr; ++k) {
    const T st = sqrt(a.tke[k * P + col]);
    ml[k] = T(q.sqrtTwo) * st / sqrt(tmax(nsq(k), eps)) * mskLoc(k);
    if (flag >= 2) rml[k] = tmin(ml[k], rml[k - 1] + a.drF[k - 1]);
  }
  // the limiters (ggl90_mixinglength.F, z-coordinates)
  if (flag == 0) {
    const T maxLength = a.Ro_surf[col] - a.R_low[col];
    for (int k = 1; k < nr; ++k) ml[k] = tmin(ml[k], maxLength);
  } else if (flag == 1) {
    for (int k = 1; k < nr; ++k)
      ml[k] = tmin(ml[k], tmin(a.Ro_surf[col] - a.rF[k],
                               a.rF[k] - a.R_low[col]));
  } else {
    T up = tmin(ml[nr - 1], mlMin + a.drF[nr - 1]);
    ml[nr - 1] = up;
    for (int k = nr - 2; k >= 1; --k) {
      up = tmin(ml[k], up + a.drF[k]);
      ml[k] = up;
    }
    for (int k = 1; k < nr; ++k) ml[k] = tmin(ml[k], rml[k]);
  }
  for (int k = 1; k < nr; ++k) {
    // Langmuir's length: LC_Gamma ML where ML reached its limit (an exact
    // comparison, as in the JAX code), clipped below by MLmin for flags 1
    // and 2
    T lcml = ml[k];
    if constexpr (LANGMUIR) {
      const bool atMax = flag == 1 ? ml[k] == a.Ro_surf[col] - a.rF[k]
                                   : ml[k] == rml[k];
      if (atMax) lcml = T(q.lcGamma) * ml[k];
      if (flag != 3) lcml = tmax(lcml, mlMin);
    }
    const T mlTmp = flag == 3 ? tmax(sqrt(ml[k] * rml[k]), mlMin)
                              : tmax(ml[k], mlMin);
    ml[k] = LANGMUIR ? lcml : flag != 3 ? mlTmp : ml[k];
    rml[k] = T(1) / mlTmp;
  }
  rml[0] = T(0);

  // Langmuir's Stokes drift: u* = sign(sfU) sqrt|sfU| here and one cell
  // east (0 past the array's edge), v* here and one cell north
  auto ustar = [](T s) -> T {
    return T((T(0) < s) - (s < T(0))) * sqrt(fabs(s));
  };
  T uS = T(0), uSe = T(0), vS = T(0), vSn = T(0);
  if constexpr (LANGMUIR) {
    uS = ustar(a.sfU[col]);
    vS = ustar(a.sfV[col]);
    if (hasE) uSe = ustar(a.sfU[col + 1]);
    if (hasN) vSn = ustar(a.sfV[col + nxp]);
  }

  // viscosities, shear, Prandtl number, sources; KappaE replaces ml
  for (int k = 0; k < nr; ++k) {
    const size_t p = k * P + col;
    const T st = sqrt(a.tke[p]);
    const T msk = mskLoc(k);
    T kappaM = T(q.ck) * ml[k] * st;
    const T visc = tmax(kappaM, T(q.diffKrS)) * msk;
    kappaM = tmax(kappaM, T(q.viscAr)) * msk;
    T shear2 = T(0), stokes = T(0);
    if (k > 0) {
      const size_t pm = p - P;
      const T rdrC = a.recip_drC[k];
      const T uE = hasE ? a.u[p + 1] : T(0), uEm = hasE ? a.u[pm + 1] : T(0);
      const T vN = hasN ? a.v[p + nxp] : T(0);
      const T vNm = hasN ? a.v[pm + nxp] : T(0);
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
        const T du = a.u[pm] - a.u[p], dup = uEm - uE;
        const T dv = a.v[pm] - a.v[p], dvp = vNm - vN;
        shear2 = ((du * du + dup * dup) + (dv * dv + dvp * dvp)) * T(0.5) *
                 (rdrC * rdrC);
        if constexpr (LANGMUIR)
          stokes = ((du * dU + dup * dUe) + (dv * dV + dvp * dVn)) * T(0.5) *
                   rdrC;
      } else {
        const T ucm = T(0.5) * (a.u[pm] + uEm), uc = T(0.5) * (a.u[p] + uE);
        const T vcm = T(0.5) * (a.v[pm] + vNm), vc = T(0.5) * (a.v[p] + vN);
        const T du = (ucm - uc) * rdrC, dv = (vcm - vc) * rdrC;
        shear2 = du * du + dv * dv;
        if constexpr (LANGMUIR)
          stokes = T(0.5) * (du * (dU + dUe) + dv * (dV + dVn));
      }
    }
    const T ri = tmax(nsq(k), T(0)) / (shear2 + eps);
    T pr;
    if constexpr (IDEMIX) {
      // IDEMIX's Prandtl number (ggl90.py:423-428)
      const T iri = tmax(kappaM * nsq(k), T(0)) / (eps + a.gTKE[p]);
      pr = tmax(tmin(T(6.6) * tmin(ri, iri), T(10.0)), T(1));
    } else {
      pr = tmin(ri >= T(0.2) ? T(5.0) * ri : T(1), T(10.0));
    }
    if (k == 0) pr = T(1);
    const T kappaH = kappaM / pr;
    ml[k] = T(q.alpha) * kappaM * msk;   // KappaE
    if (k == 0) {
      rhs[k] = a.tke[p];
    } else {
      T r = a.tke[p] + dt * (kappaM * shear2 - kappaH * nsq(k));
      if constexpr (IDEMIX) r = r + dt * a.gTKE[p];
      if constexpr (LANGMUIR) r = r + dt * kappaM * stokes;
      rhs[k] = r;
    }
    a.visctmp[p] = visc;
    a.diffKr[p] =
        k == 0 ? T(0) : tmax(tmin(visc / pr, T(q.diffMax)), T(q.diffKrS));
  }

  // the surface value, folded into row 1 (ggl90.py:540-543)
  T usq;
  {
    const T sU = a.sfU[col], sV = a.sfV[col];
    const T sUe = hasE ? a.sfU[col + 1] : T(0);
    const T sVn = hasN ? a.sfV[col + nxp] : T(0);
    if (meanShear) {
      usq = ((sU * sU + sUe * sUe) + (sV * sV + sVn * sVn)) * T(0.5);
    } else {
      const T ua = T(0.5) * (sU + sUe), va = T(0.5) * (sV + sVn);
      usq = ua * ua + va * va;
    }
  }
  const T tkeSurf = tmax(T(q.m2) * sqrt(usq), T(q.tkeSurfMin));
  const T tke1 = a.maskC[col] * tkeSurf;
  const int klow = a.klowC[col];
  const int kBot = klow - 1 > 0 ? klow - 1 : 0;

  // with IDEMIX the rows carry 1/hFacI of the interface (0 where closed)
  auto rhI = [&](int k) -> T {
    const size_t p = k * P + col;
    const T hI = tmin(a.hFacC[p - P], T(0.5)) + tmin(a.hFacC[p], T(0.5));
    return hI != T(0) ? T(1) / hI : T(0);
  };
  // coefficients of row k (a3d and c3d before the folds)
  auto coef_a = [&](int k) -> T {
    if (k == 0) return T(0);
    const size_t p = k * P + col;
    const T keKm1 = ml[k - 1 > 1 ? k - 1 : 1];
    T c = -dt * a.recip_drF[k - 1] * a.recip_hFacC[p - P] * T(0.5) *
          (ml[k] + keKm1) * a.recip_drC[k] * a.maskC[p];
    if constexpr (IDEMIX) c = c * rhI(k);
    return c;
  };
  auto coef_c = [&](int k) -> T {
    if (k == 0) return T(0);
    const size_t p = k * P + col;
    int kp1 = k + 1 < klow - 1 ? k + 1 : klow - 1;
    kp1 = kp1 > 0 ? kp1 : 0;
    T c = -dt * a.recip_drF[k] * a.recip_hFacC[p] * T(0.5) *
          (ml[k] + ml[kp1]) * a.recip_drC[k] * a.maskC[p - P];
    if constexpr (IDEMIX) c = c * rhI(k);
    if (!dirichlet && k == kBot) c = T(0);
    return c;
  };

  // forward sweep of the Thomas solve (solve_tridiagonal.F) on the folded
  // system; yp overwrites rhs
  T cpm1 = T(0), ypm1 = T(0);
  for (int k = 0; k < nr; ++k) {
    const size_t p = k * P + col;
    T ak = coef_a(k), ck = coef_c(k);
    const T bk = T(1) - ck - ak +
                 T(q.dtCeps) * sqrt(a.tke[p]) * rml[k] * mskLoc(k);
    T yk = rhs[k];
    if (k == 0) yk = tke1;
    if (k == 1) {
      yk = yk + -ak * tke1;
      ak = T(0);
    }
    if (dirichlet && k == kBot) {
      yk = yk - T(q.tkeBottom) * ck;
      ck = T(0);
    }
    const T den = bk - ak * cpm1;
    const T rec = den != T(0) ? T(1) / den : T(0);
    cpm1 = ck * rec;
    ypm1 = (yk - ak * ypm1) * rec;
    cp[k] = cpm1;
    rhs[k] = ypm1;
  }
  // back substitution and the TKE floor below the surface
  T x = rhs[nr - 1];
  for (int k = nr - 1; k >= 0; --k) {
    if (k < nr - 1) x = rhs[k] - cp[k] * x;
    a.tkeNew[k * P + col] =
        k == 0 ? x : mskLoc(k) * tmax(x, T(q.tkeMin));
  }
}

template <typename T>
__global__ void ggl90_visc_kernel(const T* __restrict__ visctmp,
                                  const T* __restrict__ maskW,
                                  const T* __restrict__ maskS,
                                  T* __restrict__ viscU, T* __restrict__ viscV,
                                  int nr, int nyp, int nxp, T viscMax,
                                  T viscAr) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t p = k * P + static_cast<size_t>(j) * nxp + i;
  if (k == 0) {
    viscU[p] = T(0);
    viscV[p] = T(0);
    return;
  }
  const T vt = visctmp[p];
  const T vW = i > 0 ? visctmp[p - 1] : T(0);
  const T vS = j > 0 ? visctmp[p - nxp] : T(0);
  const T mW = maskW[p] * maskW[p - P], mS = maskS[p] * maskS[p - P];
  viscU[p] = tmax(tmin(mW * T(0.5) * (vt + vW), viscMax), viscAr);
  viscV[p] = tmax(tmin(mS * T(0.5) * (vt + vS), viscMax), viscAr);
}

template <typename T>
int launch_ggl90_col(const void* const* table, int n, const double* params,
                     int np, int nr, int nyp, int nxp, int flag, int meanShear,
                     int dirichlet, int idemix, int langmuir, void* stream) {
  static_assert(sizeof(Ggl90Args<T>) == kGgl90Pointers * sizeof(void*),
                "Ggl90Args must be a plain table of pointers");
  static_assert(sizeof(Ggl90Params) == kGgl90Params * sizeof(double),
                "Ggl90Params must be a plain array of doubles");
  if (n != kGgl90Pointers || np != kGgl90Params || nr < 2 || nr > kMaxNr ||
      flag < 0 || flag > 3)
    return (int)cudaErrorInvalidValue;
  Ggl90Args<T> a;
  std::memcpy(&a, table, sizeof(a));
  Ggl90Params q;
  std::memcpy(&q, params, sizeof(q));
  const int plane = nyp * nxp, threads = 128;
  const dim3 g((plane + threads - 1) / threads);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool ms = meanShear != 0, dc = dirichlet != 0;
  if (idemix && langmuir)
    ggl90_col_kernel<T, true, true><<<g, threads, 0, s>>>(a, q, nr, nyp, nxp,
                                                         flag, ms, dc);
  else if (idemix)
    ggl90_col_kernel<T, true, false><<<g, threads, 0, s>>>(a, q, nr, nyp,
                                                          nxp, flag, ms, dc);
  else if (langmuir)
    ggl90_col_kernel<T, false, true><<<g, threads, 0, s>>>(a, q, nr, nyp,
                                                          nxp, flag, ms, dc);
  else
    ggl90_col_kernel<T, false, false><<<g, threads, 0, s>>>(a, q, nr, nyp,
                                                           nxp, flag, ms, dc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ggl90_visc(const void* visctmp, const void* maskW,
                      const void* maskS, void* viscU, void* viscV, int nr,
                      int nyp, int nxp, double viscMax, double viscAr,
                      void* stream) {
  const dim3 g((nxp + BX - 1) / BX, (nyp + BY - 1) / BY, nr);
  ggl90_visc_kernel<T><<<g, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      (const T*)visctmp, (const T*)maskW, (const T*)maskS, (T*)viscU,
      (T*)viscV, nr, nyp, nxp, T(viscMax), T(viscAr));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define MITGCM_GGL90_ENTRY(SUF, T)                                             \
  extern "C" int mitgcm_ggl90_col_##SUF(                                       \
      const void* const* table, int n, const double* params, int np, int nr, \
      int nyp, int nxp, int flag, int meanShear, int dirichlet, int idemix,   \
      int langmuir, void* stream) {                                            \
    return mitgcm::launch_ggl90_col<T>(table, n, params, np, nr, nyp, nxp,    \
                                       flag, meanShear, dirichlet, idemix,     \
                                       langmuir, stream);                      \
  }                                                                            \
  extern "C" int mitgcm_ggl90_visc_##SUF(                                      \
      const void* visctmp, const void* maskW, const void* maskS, void* viscU, \
      void* viscV, int nr, int nyp, int nxp, double viscMax, double viscAr,   \
      void* stream) {                                                          \
    return mitgcm::launch_ggl90_visc<T>(visctmp, maskW, maskS, viscU, viscV,  \
                                        nr, nyp, nxp, viscMax, viscAr,        \
                                        stream);                               \
  }

MITGCM_GGL90_ENTRY(f32, float)
MITGCM_GGL90_ENTRY(f64, double)
