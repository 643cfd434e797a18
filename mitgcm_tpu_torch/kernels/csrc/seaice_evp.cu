// Kernel H-seaice EVP: one subcycle of the sea ice's elastic-viscous-plastic
// dynamics in two launches.
//
// Replaces: mitgcm_tpu/model/seaice.py:SeaIce.evp (:1059-1243), the body of
// its lax.fori_loop (:1114-1227: strainrates :513, the e12^2 average, zeta,
// the adaptive alpha, the stresses sigma1, sigma2 and sigma12 relaxed by
// EVP*, revised or adaptive EVP, their divergence, oceandrag :593, the
// forcing, the implicit velocity update and fill_uv) and its post-loop
// divergence (:1235-1242), which XLA ran on the TPU as fused 2-D passes
// nEVPstarSteps times a step.
//
//   seaice_evp_stress  one thread per padded C cell: the strain rates, zeta,
//                      alpha (adaptive: from zeta and the ice mass; else
//                      SEAICE_evpAlpha) and the new sigma1, sigma2
//   seaice_evp_uv      one thread per padded cell: the new sigma12 at its Z
//                      point, and the new u and v at its velocity points
//                      (sigma12 at the two Z points each divergence reads,
//                      recomputed in the thread, the divergence, the ocean
//                      drag dwatn, the forcing with Coriolis, the update)
// Two launches, because sigma12 at a Z point reads zeta and alpha at its
// four C points (:1143, :1160), which one launch would be computing at the
// same time; every stress is written out of place (the caller ping-pongs
// the buffers), because neighbours read the old values.
//
// The variant is a template flag: ADAPTIVE (aEVPcoeff > 0: alpha and beta
// per cell) and REV_DEN (useEVPrev or adaptive: the stresses divide by
// alpha; otherwise by alpha + 1 and alpha + e^2, :1151-1165); the
// relaxation factors of useEVPrev and useEVPstar are parameters.
// No fill launch: a thread in the halo computes u and v at the interior
// cell it wraps to (common.cuh:wrap), which is what fill_uv stores there.
// sigma, dwatn and the divergence are the JAX code's whole padded arrays,
// with every shifted read zero-filled at the outer edge (seaice.cuh:Fld).
// With `last` set (the last subcycle) the launch also writes dwatn and the
// divergence at its own cell: the post-loop divergence of the same final
// stresses, and the loop's last drag.
//
// Bound: bytes. Launch (a) reads 13 2-D fields and writes 4; launch (b)
// reads 36 and writes 3 (6 on the last subcycle).

#include "seaice.cuh"

namespace mitgcm {

// ---------------------------------------------------------------------
// seaice_evp_stress
// ---------------------------------------------------------------------
template <typename T>
struct EvpStressArgs {
  const T *u, *v, *s1, *s2, *press0, *massC, *heffm, *recip_dxF, *recip_dyF,
      *recip_dyU, *recip_dxV, *rAz, *recip_rA;
  T *s1o, *s2o, *zeta, *alpha;
};
constexpr int kEvpStressPointers = 17;

struct EvpStressParams {
  double recip_ecc2, deltaMin, pressReplFac, oneMinusPressReplFac, cFac,
      alphaMin, evpAlpha, revFac, recip_revFac, ecc2;
};

// the shear strain rate e12 at Z point (jj, ii) (seaice.py:strainrates on
// the Cartesian grid, free slip), 0 outside the array
template <typename T>
__device__ T e12_at(const Fld<T>& u, const Fld<T>& v, const Fld<T>& hm,
                    const T* recip_dyU, const T* recip_dxV, int jj, int ii) {
  if (!in2(jj, ii, u.nyp, u.nxp)) return T(0);
  const size_t r = static_cast<size_t>(jj) * u.nxp + ii;
  const T dudy = (u(jj, ii) - u(jj - 1, ii)) * recip_dyU[r];
  const T dvdx = (v(jj, ii) - v(jj, ii - 1)) * recip_dxV[r];
  return T(0.5) * (dudy + dvdx) * hm4_at(hm, jj, ii);
}

template <typename T, bool ADAPTIVE, bool REV_DEN>
__global__ void seaice_evp_stress_kernel(const EvpStressArgs<T> a,
                                         const EvpStressParams q, int nyp,
                                         int nxp) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t p = static_cast<size_t>(j) * nxp + i;
  const Fld<T> u{a.u, nyp, nxp}, v{a.v, nyp, nxp}, hm{a.heffm, nyp, nxp};
  // rAz e12 e12 at (jj, ii), 0 outside the array
  auto rze = [&](int jj, int ii) -> T {
    if (!in2(jj, ii, nyp, nxp)) return T(0);
    const T e12 = e12_at(u, v, hm, a.recip_dyU, a.recip_dxV, jj, ii);
    return a.rAz[static_cast<size_t>(jj) * nxp + ii] * e12 * e12;
  };
  const T e11 = a.recip_dxF[p] * (u(j, i + 1) - u(j, i));
  const T e22 = a.recip_dyF[p] * (v(j + 1, i) - v(j, i));
  const T ep = e11 + e22;
  const T em = e11 - e22;
  const T e12Csq = T(0.25) * a.recip_rA[p] *
                   (rze(j, i) + rze(j, i + 1) + rze(j + 1, i) +
                    rze(j + 1, i + 1));
  const T deltaSq = ep * ep + T(q.recip_ecc2) * (em * em + T(4.0) * e12Csq);
  const T deltaC = sqrt(deltaSq);
  const T press0 = a.press0[p];
  const T hmp = a.heffm[p];
  const T zetaC = T(0.5) * press0 / nmax(deltaC, T(q.deltaMin));
  T alphaC;
  if (ADAPTIVE) {
    alphaC = sqrt(zetaC * T(q.cFac) / nmax(a.massC[p], T(1.0e-4)) *
                  a.recip_rA[p]) * hmp;
    alphaC = nmax(alphaC, T(q.alphaMin));
  } else {
    alphaC = T(q.evpAlpha);
  }
  const T pressC = press0 * T(q.oneMinusPressReplFac) +
                   T(2.0) * zetaC * deltaC * T(q.pressReplFac);
  const T sdiv = (T(2.0) * zetaC * ep - pressC) * hmp;
  const T tension = T(2.0) * zetaC * em * hmp;
  const T den1 = REV_DEN ? alphaC : alphaC + T(1.0);
  const T den2 = REV_DEN ? alphaC : alphaC + T(q.ecc2);
  a.s1o[p] = (a.s1[p] * (alphaC - T(q.revFac)) + sdiv) / den1 * hmp;
  a.s2o[p] = (a.s2[p] * (alphaC - T(q.revFac)) + tension * T(q.recip_revFac)) /
             den2 * hmp;
  a.zeta[p] = zetaC;
  a.alpha[p] = alphaC;
}

// ---------------------------------------------------------------------
// seaice_evp_uv
// ---------------------------------------------------------------------
template <typename T>
struct EvpUvArgs {
  const T *u, *v, *uNm1, *vNm1, *s12, *s1, *s2, *zeta, *alpha, *uVel0,
      *vVel0, *forcex0, *forcey0, *massC, *massU, *massV, *areaW, *areaS,
      *locMaskU, *locMaskV, *sumNorm, *fCori, *yC, *maskInW, *maskInS,
      *heffm, *maskU, *maskV, *recip_dyU, *recip_dxV, *dxV, *dyU, *dyF, *dxF,
      *recip_rAw, *recip_rAs;
  T *uo, *vo, *s12o, *dwatn, *divX, *divY;
};
constexpr int kEvpUvPointers = 42;

struct EvpUvParams {
  double revFac, recip_revFac, ecc2, evpBeta, recip_dt, starFac,
      starFacRecipDt, coswat, sinwat, dragNorth, dragSouth, dWatMin,
      dWatMinSq;
};

template <typename T, bool ADAPTIVE, bool REV_DEN>
__global__ void seaice_evp_uv_kernel(const EvpUvArgs<T> a,
                                     const EvpUvParams q, int nyp, int nxp,
                                     int ny, int nx, int ol, int last) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t p = static_cast<size_t>(j) * nxp + i;
  const Fld<T> u{a.u, nyp, nxp}, v{a.v, nyp, nxp}, hm{a.heffm, nyp, nxp},
      Z{a.zeta, nyp, nxp}, A{a.alpha, nyp, nxp}, S1{a.s1, nyp, nxp},
      S2{a.s2, nyp, nxp}, u0{a.uVel0, nyp, nxp}, v0{a.vVel0, nyp, nxp};
  auto at = [&](const T* f, int jj, int ii) -> T {
    return f[static_cast<size_t>(jj) * nxp + ii];
  };
  // the new sigma12 at Z point (jj, ii) (:1142-1165), 0 outside the array
  auto s12n = [&](int jj, int ii) -> T {
    if (!in2(jj, ii, nyp, nxp)) return T(0);
    const T zetaZ = at(a.sumNorm, jj, ii) *
                    (Z(jj, ii) + Z(jj, ii - 1) + Z(jj - 1, ii) +
                     Z(jj - 1, ii - 1));
    const T shear = T(2.0) * zetaZ *
                    e12_at(u, v, hm, a.recip_dyU, a.recip_dxV, jj, ii);
    const T alphaZ = T(0.25) * (A(jj, ii) + A(jj, ii - 1) + A(jj - 1, ii) +
                                A(jj - 1, ii - 1));
    const T den12 = REV_DEN ? alphaZ : alphaZ + T(q.ecc2);
    return (at(a.s12, jj, ii) * (alphaZ - T(q.revFac)) +
            shear * T(q.recip_revFac)) / den12;
  };
  // the terms of the stress divergence (:1166-1174), 0 outside the array
  auto t11 = [&](int jj, int ii) -> T {
    if (!in2(jj, ii, nyp, nxp)) return T(0);
    return T(0.5) * (S1(jj, ii) + S2(jj, ii)) * at(a.dyF, jj, ii);
  };
  auto t22 = [&](int jj, int ii) -> T {
    if (!in2(jj, ii, nyp, nxp)) return T(0);
    return T(0.5) * (S1(jj, ii) - S2(jj, ii)) * at(a.dxF, jj, ii);
  };
  auto t12x = [&](int jj, int ii) -> T {
    if (!in2(jj, ii, nyp, nxp)) return T(0);
    return s12n(jj, ii) * at(a.dxV, jj, ii);
  };
  auto t12y = [&](int jj, int ii) -> T {
    if (!in2(jj, ii, nyp, nxp)) return T(0);
    return s12n(jj, ii) * at(a.dyU, jj, ii);
  };
  auto divX = [&](int jj, int ii) -> T {
    return (t11(jj, ii) - t11(jj, ii - 1) + t12x(jj + 1, ii) -
            t12x(jj, ii)) * at(a.recip_rAw, jj, ii);
  };
  auto divY = [&](int jj, int ii) -> T {
    return (t22(jj, ii) - t22(jj - 1, ii) + t12y(jj, ii + 1) -
            t12y(jj, ii)) * at(a.recip_rAs, jj, ii);
  };
  // oceandrag (seaice.py:593) of this subcycle's u, v, 0 outside the array
  auto dwatn = [&](int jj, int ii) -> T {
    if (!in2(jj, ii, nyp, nxp)) return T(0);
    auto du = [&](int y, int x) -> T {
      if (!in2(y, x, nyp, nxp)) return T(0);
      return (at(a.u, y, x) - at(a.uVel0, y, x)) * at(a.maskInW, y, x);
    };
    auto dv = [&](int y, int x) -> T {
      if (!in2(y, x, nyp, nxp)) return T(0);
      return (at(a.v, y, x) - at(a.vVel0, y, x)) * at(a.maskInS, y, x);
    };
    const T sa = du(jj, ii) + du(jj, ii + 1);
    const T sb = dv(jj, ii) + dv(jj + 1, ii);
    const T tempVar = T(0.25) * (sa * sa + sb * sb);
    const T dc = at(a.yC, jj, ii) < T(0) ? T(q.dragSouth) : T(q.dragNorth);
    const T cw = dc * dc * tempVar > T(q.dWatMinSq) ? dc * sqrt(tempVar)
                                                   : T(q.dWatMin);
    return cw * hm(jj, ii);
  };
  auto dvC = [&](int y, int x) -> T { return v0(y, x) - v(y, x); };
  auto duC = [&](int y, int x) -> T { return u0(y, x) - u(y, x); };
  auto mfv = [&](int y, int x) -> T {
    if (!in2(y, x, nyp, nxp)) return T(0);
    return at(a.massC, y, x) * at(a.fCori, y, x) * T(0.5) *
           (v(y, x) + v(y + 1, x));
  };
  auto mfu = [&](int y, int x) -> T {
    if (!in2(y, x, nyp, nxp)) return T(0);
    return at(a.massC, y, x) * at(a.fCori, y, x) * T(0.5) *
           (u(y, x) + u(y, x + 1));
  };

  a.s12o[p] = s12n(j, i);
  if (last) {
    a.dwatn[p] = dwatn(j, i);
    a.divX[p] = divX(j, i);
    a.divY[p] = divY(j, i);
  }
  // the new u and v at the interior cell this one wraps to (fill_uv)
  const int jw = wrap(j, ol, ny), iw = wrap(i, ol, nx);
  const size_t w = static_cast<size_t>(jw) * nxp + iw;
  const T coswat = T(q.coswat);
  const T sgn = a.fCori[w] < T(0) ? T(-1) : T(1);
  const T sgs = sgn * T(q.sinwat) * T(0.5);
  const T dw = dwatn(jw, iw), dw_im = dwatn(jw, iw - 1),
          dw_jm = dwatn(jw - 1, iw);
  const T dwU = T(0.5) * (dw + dw_im);
  const T dwV = T(0.5) * (dw + dw_jm);
  T frcU = a.forcex0[w] +
           (dwU * coswat * a.uVel0[w] -
            sgs * (dw * T(0.5) * (dvC(jw, iw) + dvC(jw + 1, iw)) +
                   dw_im * T(0.5) * (dvC(jw, iw - 1) + dvC(jw + 1, iw - 1))) *
                a.locMaskU[w]) * a.areaW[w];
  T frcV = a.forcey0[w] +
           (dwV * coswat * a.vVel0[w] +
            sgs * (dw * T(0.5) * (duC(jw, iw) + duC(jw, iw + 1)) +
                   dw_jm * T(0.5) * (duC(jw - 1, iw) + duC(jw - 1, iw + 1))) *
                a.locMaskV[w]) * a.areaS[w];
  frcU = frcU + T(0.5) * (mfv(jw, iw) + mfv(jw, iw - 1));
  frcV = frcV - T(0.5) * (mfu(jw, iw) + mfu(jw - 1, iw));
  T betaU, betaV;
  if (ADAPTIVE) {
    betaU = T(0.5) * (A(jw, iw) + A(jw, iw - 1));
    betaV = T(0.5) * (A(jw, iw) + A(jw - 1, iw));
  } else {
    betaU = betaV = T(q.evpBeta);
  }
  const T recip_dt = T(q.recip_dt);
  const T betaFacU = betaU * recip_dt;
  const T betaFacV = betaV * recip_dt;
  const T mU = a.massU[w], mV = a.massV[w];
  T denomU = mU * (betaFacU + T(q.starFacRecipDt)) + dwU * coswat * a.areaW[w];
  T denomV = mV * (betaFacV + T(q.starFacRecipDt)) + dwV * coswat * a.areaS[w];
  if (denomU == T(0)) denomU = T(1);
  if (denomV == T(0)) denomV = T(1);
  a.uo[p] = a.maskU[w] *
            (mU * betaFacU * a.u[w] + mU * recip_dt * T(q.starFac) * a.uNm1[w] +
             frcU + divX(jw, iw)) / denomU;
  a.vo[p] = a.maskV[w] *
            (mV * betaFacV * a.v[w] + mV * recip_dt * T(q.starFac) * a.vNm1[w] +
             frcV + divY(jw, iw)) / denomV;
}

template <typename T, bool ADAPTIVE, bool REV_DEN>
int launch_evp_stress_t(const EvpStressArgs<T>& a, const EvpStressParams& q,
                        int nyp, int nxp, cudaStream_t stream) {
  seaice_evp_stress_kernel<T, ADAPTIVE, REV_DEN>
      <<<grid2d(nyp, nxp), dim3(BX, BY), 0, stream>>>(a, q, nyp, nxp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_evp_stress(const void* const* table, int n, const double* params,
                      int nparams, int nyp, int nxp, int adaptive,
                      int rev_den, cudaStream_t stream) {
  EvpStressArgs<T> a;
  if (!table_of<T, EvpStressArgs<T>, kEvpStressPointers>(table, n, &a) ||
      nparams != static_cast<int>(sizeof(EvpStressParams) / sizeof(double)))
    return (int)cudaErrorInvalidValue;
  EvpStressParams q;
  std::memcpy(&q, params, sizeof(q));
  if (adaptive)
    return rev_den ? launch_evp_stress_t<T, true, true>(a, q, nyp, nxp, stream)
                   : launch_evp_stress_t<T, true, false>(a, q, nyp, nxp,
                                                         stream);
  return rev_den ? launch_evp_stress_t<T, false, true>(a, q, nyp, nxp, stream)
                 : launch_evp_stress_t<T, false, false>(a, q, nyp, nxp,
                                                        stream);
}

template <typename T, bool ADAPTIVE, bool REV_DEN>
int launch_evp_uv_t(const EvpUvArgs<T>& a, const EvpUvParams& q, int nyp,
                    int nxp, int ny, int nx, int ol, int last,
                    cudaStream_t stream) {
  seaice_evp_uv_kernel<T, ADAPTIVE, REV_DEN>
      <<<grid2d(nyp, nxp), dim3(BX, BY), 0, stream>>>(a, q, nyp, nxp, ny, nx,
                                                      ol, last);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_evp_uv(const void* const* table, int n, const double* params,
                  int nparams, int ny, int nx, int ol, int adaptive,
                  int rev_den, int last, cudaStream_t stream) {
  EvpUvArgs<T> a;
  if (!table_of<T, EvpUvArgs<T>, kEvpUvPointers>(table, n, &a) ||
      nparams != static_cast<int>(sizeof(EvpUvParams) / sizeof(double)) ||
      ny < 1 || nx < 1 || ol < 1)
    return (int)cudaErrorInvalidValue;
  EvpUvParams q;
  std::memcpy(&q, params, sizeof(q));
  const int nyp = ny + 2 * ol, nxp = nx + 2 * ol;
  if (adaptive)
    return rev_den ? launch_evp_uv_t<T, true, true>(a, q, nyp, nxp, ny, nx,
                                                    ol, last, stream)
                   : launch_evp_uv_t<T, true, false>(a, q, nyp, nxp, ny, nx,
                                                     ol, last, stream);
  return rev_den ? launch_evp_uv_t<T, false, true>(a, q, nyp, nxp, ny, nx, ol,
                                                   last, stream)
                 : launch_evp_uv_t<T, false, false>(a, q, nyp, nxp, ny, nx,
                                                    ol, last, stream);
}

}  // namespace mitgcm

#define MITGCM_SEAICE_EVP_ENTRY_POINTS(T, SUF)                                \
  extern "C" int mitgcm_seaice_evp_stress_##SUF(                              \
      const void* const* table, int n, const double* params, int nparams,     \
      int nyp, int nxp, int adaptive, int rev_den, void* stream) {            \
    return mitgcm::launch_evp_stress<T>(table, n, params, nparams, nyp, nxp,  \
                                        adaptive, rev_den,                    \
                                        (cudaStream_t)stream);                \
  }                                                                           \
  extern "C" int mitgcm_seaice_evp_uv_##SUF(                                  \
      const void* const* table, int n, const double* params, int nparams,     \
      int ny, int nx, int ol, int adaptive, int rev_den, int last,            \
      void* stream) {                                                         \
    return mitgcm::launch_evp_uv<T>(table, n, params, nparams, ny, nx, ol,    \
                                    adaptive, rev_den, last,                  \
                                    (cudaStream_t)stream);                    \
  }

MITGCM_SEAICE_EVP_ENTRY_POINTS(float, f32)
MITGCM_SEAICE_EVP_ENTRY_POINTS(double, f64)
