// Kernel G's mom_ab_step and tracer_step: the step's pointwise glue around
// the momentum and tracer tendencies, and their launches. Included by
// step_glue.cu, whose entry points start them on the card, and by the host
// check of the tests, which runs them on the CPU.
//
// Replaces the fused elementwise passes that XLA made of
//   - mom_ab_step: the total momentum tendency (mitgcm_tpu/model/step.py:
//     dynamics, gU = gU - dPhiHydX + guDiss + guExt, guExt the wind
//     stress of apply_forcing.F in the surface level, 0 below), its
//     Adams-Bashforth extrapolation (adams_bashforth2/3, :54-104) and the
//     predictor
//     uStar = u + deltaTMom * gU_ab * maskW (:318-319), for u and v in one
//     launch; with the non-hydrostatic flag also w: gW + gwDiss, its AB and
//     timestep_wvel's w* = w + (deltaTMom / nh_Am2) * gW_ab * maskC *
//     maskC[k-1] (calc_gw.py:169-176); with the CD flag the extrapolated
//     tendencies gU_ab and gV_ab themselves (:256-267), which kernel CD
//     (cd_code.cuh) turns into the predictors;
//   - mom_correction: momentum_correction_step (:509-539), the new
//     surface-pressure gradient and u = uStar - its step (mom_correction.cuh,
//     a header of its own for the tests' host check);
//   - tracer_step: the surface forcing into level ksurf0, the tracer's AB
//     (linear scheme only) and tr + deltaTTracer * gTr_ab
//     (mitgcm_tpu/model/thermodynamics.py:329-358).
// The AB coefficients are host-side numbers, as in the twins: AB-2 is
// g + abFac * (g - gNm1) with abFac = 0 on the cold start (computed, not
// skipped, as JAX does); AB-3 is g + ((ab0 g + ab1 gNm1) + ab2 gNm2).
//
// Bound: bytes. mom_ab_step reads 7 fields and writes 2 per component (36
// B/cell in float32 for u and v; the forcing is one 2-D field a
// component), tracer_step reads 3 (AB-2; 4 under AB-3, 2 without AB) and
// writes 2 (1 without AB) plus the surface level's 2-D forcing and
// recip_hFacC; a few flops per cell.
// Design: one thread per padded cell (k, j, i), i fastest; every output is
// a fresh field (never one that autograd saved). The only neighbour read is
// the level above for w's mask. Each expression keeps the twins' operation
// order (model/step.py:_mom_ab_step_plain; model/thermodynamics.py:
// _tracer_step_plain), so with --fmad=false the outputs are bit-equal.
#pragma once

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct AbCoeffs {
  int ab;  // 0: none, 2: AB-2, 3: AB-3
  T abFac, ab0, ab1, ab2;
  __device__ T operator()(T g, const T* gNm1, const T* gNm2,
                          size_t p) const {
    if (ab == 2) return g + abFac * (g - gNm1[p]);
    if (ab == 3) return g + ((ab0 * g + ab1 * gNm1[p]) + ab2 * gNm2[p]);
    return g;
  }
};

template <typename T>
struct MomAbArgs {
  // per component: the tendency's terms, its history, the velocity, the
  // mask; U, V and (non-hydrostatic) W; [nr, nyp, nxp] each but the
  // forcing guExt and gvExt, [nyp, nxp]: its surface level (below it the
  // twin adds 0)
  const T *gU, *dPhiX, *guDiss, *guExt, *guNm1, *guNm2, *u, *maskW;
  const T *gV, *dPhiY, *gvDiss, *gvExt, *gvNm1, *gvNm2, *v, *maskS;
  const T *gW, *gwDiss, *gwNm1, *gwNm2, *w, *maskC;
  // outputs: the raw tendency (the next step's gNm1) and the predictor, or
  // under the CD scheme the AB-extrapolated tendency in its place (kernel
  // CD forms the predictor with the D-grid Coriolis term)
  T *guNew, *uStar, *gvNew, *vStar, *gwNew, *wStar;
};
// mom_ab_step's mode: bit 0 the non-hydrostatic w, bit 1 the CD scheme's
// variant (gU_ab and gV_ab written in place of u* and v*)
constexpr int kMomAbNh = 1;
constexpr int kMomAbCd = 2;
constexpr int kMomAbNumPointers = 28;

template <typename T>
__global__ void mom_ab_step_kernel(MomAbArgs<T> a, int nr, int nyp, int nxp,
                                   int mode, AbCoeffs<T> ab, T deltaTMom,
                                   T wFac) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t p = k * P + static_cast<size_t>(j) * nxp + i;
  // the wind stress's surface level (kernel Q), + 0 below it
  const size_t q = static_cast<size_t>(j) * nxp + i;
  const T guExt = k == 0 ? a.guExt[q] : T(0);
  const T gvExt = k == 0 ? a.gvExt[q] : T(0);
  const bool cd = mode & kMomAbCd;
  const T gU = ((a.gU[p] - a.dPhiX[p]) + a.guDiss[p]) + guExt;
  a.guNew[p] = gU;
  const T guAb = ab(gU, a.guNm1, a.guNm2, p);
  a.uStar[p] = cd ? guAb : a.u[p] + (deltaTMom * guAb) * a.maskW[p];
  const T gV = ((a.gV[p] - a.dPhiY[p]) + a.gvDiss[p]) + gvExt;
  a.gvNew[p] = gV;
  const T gvAb = ab(gV, a.gvNm1, a.gvNm2, p);
  a.vStar[p] = cd ? gvAb : a.v[p] + (deltaTMom * gvAb) * a.maskS[p];
  if (mode & kMomAbNh) {
    const T gW = a.gW[p] + a.gwDiss[p];
    a.gwNew[p] = gW;
    const T msk = a.maskC[p] * a.maskC[k > 0 ? p - P : p];
    a.wStar[p] = a.w[p] + (wFac * ab(gW, a.gwNm1, a.gwNm2, p)) * msk;
  }
}

template <typename T>
struct TracerArgs {
  // [nr, nyp, nxp]: the tendency, the tracer, its history
  const T *gTr, *tracer, *gNm1, *gNm2;
  // [nyp, nxp]: the surface forcing and recip_hFacC at level ks; [nr]
  const T *sfc, *recip_hFacC_ks, *recip_drF;
  // outputs: the stepped tracer and, with AB, the raw tendency (the slots
  // that a launch without AB does not touch may hold any pointer)
  T *trNew, *gNew;
};
constexpr int kTracerNumPointers = 9;

template <typename T>
__global__ void tracer_step_kernel(TracerArgs<T> a, int nr, int nyp, int nxp,
                                   int ks, AbCoeffs<T> ab, T deltaT) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t q = static_cast<size_t>(j) * nxp + i;
  const size_t p = k * P + q;
  const T forc = k == ks ? (a.sfc[q] * a.recip_drF[ks]) * a.recip_hFacC_ks[q]
                         : T(0);
  const T g = a.gTr[p] + forc;
  if (ab.ab) a.gNew[p] = g;
  a.trNew[p] = a.tracer[p] + deltaT * ab(g, a.gNm1, a.gNm2, p);
}

inline dim3 step_grid3d(int nr, int nyp, int nxp) {
  dim3 g = grid2d(nyp, nxp);
  g.z = nr;
  return g;
}

template <typename T, typename Start>
int launch_mom_ab_step(const void* const* table, int n, int nr, int nyp,
                       int nxp, int ab, int mode, double abFac, double ab0,
                       double ab1, double ab2, double deltaTMom, double wFac,
                       Start start) {
  static_assert(sizeof(MomAbArgs<T>) == kMomAbNumPointers * sizeof(void*),
                "MomAbArgs must be a plain table of pointers");
  MomAbArgs<T> a;
  if (!unpack(&a, table, n, kMomAbNumPointers) || (ab != 2 && ab != 3) ||
      mode < 0 || mode > (kMomAbNh | kMomAbCd) || nr < 1 || nr > 65535)
    return (int)cudaErrorInvalidValue;
  const AbCoeffs<T> c{ab, T(abFac), T(ab0), T(ab1), T(ab2)};
  start(mom_ab_step_kernel<T>, step_grid3d(nr, nyp, nxp), dim3(BX, BY), a, nr,
        nyp, nxp, mode, c, T(deltaTMom), T(wFac));
  return (int)cudaGetLastError();
}

template <typename T, typename Start>
int launch_tracer_step(const void* const* table, int n, int nr, int nyp,
                       int nxp, int ks, int ab, double abFac, double ab0,
                       double ab1, double ab2, double deltaT, Start start) {
  static_assert(sizeof(TracerArgs<T>) == kTracerNumPointers * sizeof(void*),
                "TracerArgs must be a plain table of pointers");
  TracerArgs<T> a;
  if (!unpack(&a, table, n, kTracerNumPointers) ||
      (ab != 0 && ab != 2 && ab != 3) || ks < 0 || ks >= nr || nr > 65535)
    return (int)cudaErrorInvalidValue;
  const AbCoeffs<T> c{ab, T(abFac), T(ab0), T(ab1), T(ab2)};
  start(tracer_step_kernel<T>, step_grid3d(nr, nyp, nxp), dim3(BX, BY), a, nr,
        nyp, nxp, ks, c, T(deltaT));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
