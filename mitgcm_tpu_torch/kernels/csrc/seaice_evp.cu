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
//   seaice_evp_uv      a tile of padded cells that forms each new sigma12
//                      and each ocean drag dwatn once, in shared memory,
//                      then the divergence, the forcing with Coriolis and
//                      the update of u and v (seaice_evp_uv.cuh, a header
//                      of its own for the tests' host check)
// Two launches, because sigma12 at a Z point reads zeta and alpha at its
// four C points (:1143, :1160), which one launch would be computing at the
// same time; every stress is written out of place (the caller ping-pongs
// the buffers), because neighbours read the old values.
//
// The variant is a template flag: ADAPTIVE (aEVPcoeff > 0: alpha and beta
// per cell) and REV_DEN (useEVPrev or adaptive: the stresses divide by
// alpha; otherwise by alpha + 1 and alpha + e^2, :1151-1165); the
// relaxation factors of useEVPrev and useEVPstar are parameters.
// No fill launch: the thread of an interior cell also writes its u and v
// to each halo cell that wraps to it (common.cuh:wrap), which is what
// fill_uv stores there.
// sigma, dwatn and the divergence are the JAX code's whole padded arrays,
// with every shifted read zero-filled at the outer edge (seaice.cuh:Fld).
// With `last` set (the last subcycle) the launch also writes dwatn and the
// divergence at its own cell: the post-loop divergence of the same final
// stresses, and the loop's last drag.
//
// Bound: bytes. Launch (a) reads 13 2-D fields and writes 4; launch (b)
// reads 36 and writes 3 (6 on the last subcycle).

#include "seaice_evp_uv.cuh"

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
                                    mitgcm::OnStream{(cudaStream_t)stream});  \
  }

MITGCM_SEAICE_EVP_ENTRY_POINTS(float, f32)
MITGCM_SEAICE_EVP_ENTRY_POINTS(double, f64)
