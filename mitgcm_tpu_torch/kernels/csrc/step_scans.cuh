// Kernel E: the step's two column scans, the cg2d right-hand side and the
// vertical velocity from continuity, and their launches. Included by
// step_scans.cu, whose entry points start them on the card, and by the
// host check of the tests, which runs them on the CPU.
//
// Replaces: mitgcm_tpu/model/step.py:solve_for_pressure's right-hand side
// (:400-413, solve_for_pressure.F:146-152), the divergence of the predicted
// transport summed level by level in the order k = Nr..1 (a lax.scan),
// with, on the non-hydrostatic path, pre_cg3d's surface term (:418-431,
// oldFreeSurfTerm), and integr_continuity's bottom-up integral for w
// (:557-640, a lax.scan):
//   cg2d_rhs:   pfx = ((implicDiv2Dflow * ((dyG * drF) * hFacW)) * uStar)
//                     / deltaTMom, pfy likewise with dxG, hFacS and vStar;
//               acc = 0; for k = Nr-1..0: acc = acc + (pfx[i+1] - pfx);
//                                         acc = acc + (pfy[j+1] - pfy);
//               surfC = ((freeSurfFac * rA) / deltaTMom) / deltaTFreeSurf;
//               hydrostatic: b = (acc - surfC * etaN) * interior mask;
//               non-hydrostatic: surfT = -surfC * (etaN + (0 + phi_nh at
//               level ks) * recip_Bo), ks = kSurfC - 1 (no level of a dry
//               column: the sum is +0), b = (acc + surfT) * interior mask,
//               and each level's divergence div = (pfx[i+1] - pfx) +
//               (pfy[j+1] - pfy) + (surfT at level ks, else +0), the first
//               terms of the cg3d right-hand side (step.py:421-431);
//   continuity: uTrans = ((u * dyG) * drF) * hFacW, vTrans likewise;
//               cr = -((uTrans[i+1] - uTrans) + (vTrans[j+1] - vTrans))
//                    * recip_rA;
//               w_below = 0; for k = Nr-1..0: w_below = (w_below + cr)
//                                                        * maskC; w = w_below
//               and PmEpR = -EmPmR.
// A neighbour beyond the last column or row reads 0, as the shifts' zero
// fill does, so every padded cell comes out as the twin's.
//
// Bound: bytes. cg2d_rhs reads uStar, vStar, hFacW and hFacS once and
// writes one 2-D field (16 B/cell in float32; 20 with the non-hydrostatic
// div, which also reads phi_nh's surface level and three 2-D fields);
// continuity reads u, v, hFacW, hFacS and maskC and writes w (24 B/cell).
// About 10 flops a cell.
// Design: one thread per padded column (j, i), i fastest, walking the
// levels in the reference's order with the sum in a register; the east and
// north neighbours' transports are recomputed from their inputs (L1/L2
// hits: the neighbouring threads load the same cells), so nothing is
// written between levels. The non-hydrostatic surface term is formed at
// the column's start, so the level that takes it is written once. The
// Python twins (model/step.py:_cg2d_rhs_plain, _continuity_plain) divide
// by deltaTMom and deltaTFreeSurf as tensors, so with --fmad=false the
// kernel is bit-equal to them.
#pragma once

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct Cg2dRhsArgs {
  // [nr, nyp, nxp]: uStar, vStar, hFacW, hFacS; [nyp, nxp]: dyG, dxG, rA,
  // etaN; [nr]: drF
  const T *uStar, *vStar, *hFacW, *hFacS, *dyG, *dxG, *rA, *etaN, *drF;
  // outputs: the right-hand side [nyp, nxp] and, non-hydrostatic, each
  // level's divergence [nr, nyp, nxp]
  T *out, *div;
  // non-hydrostatic only: phi_nh [nr, nyp, nxp], kSurfC and recip_Bo
  // [nyp, nxp]
  const T *phi_nh, *kSurfC, *recip_Bo;
};
constexpr int kCg2dRhsNumPointers = 14;

template <typename T>
__global__ void cg2d_rhs_kernel(Cg2dRhsArgs<T> a, int nr, int nyp, int nxp,
                                int oly, int olx, int hydrostatic,
                                T implicDiv2Dflow, T deltaTMom,
                                T freeSurfFac, T deltaTFreeSurf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t q = static_cast<size_t>(j) * nxp + i;
  const bool east = i + 1 < nxp, north = j + 1 < nyp;
  const T dy = a.dyG[q], dx = a.dxG[q];
  const T dyE = east ? a.dyG[q + 1] : T(0);
  const T dxN = north ? a.dxG[q + nxp] : T(0);
  const T surfC = ((freeSurfFac * a.rA[q]) / deltaTMom) / deltaTFreeSurf;
  const T inner =
      j >= oly && j < nyp - oly && i >= olx && i < nxp - olx ? T(1) : T(0);
  // the non-hydrostatic surface term and the level that takes it (-1: a
  // dry column, no level)
  int ks = -1;
  T surfT = T(0);
  if (!hydrostatic) {
    const T kSurf = a.kSurfC[q];
    T phiS = T(0);
    if (kSurf <= T(nr)) {
      ks = static_cast<int>(kSurf) - 1;
      phiS = T(0) + a.phi_nh[ks * P + q];
    }
    surfT = (-surfC) * (a.etaN[q] + phiS * a.recip_Bo[q]);
  }
  T acc = T(0);
  for (int k = nr - 1; k >= 0; --k) {
    const size_t p = k * P + q;
    const T pfx = ((implicDiv2Dflow * ((dy * a.drF[k]) * a.hFacW[p])) *
                   a.uStar[p]) / deltaTMom;
    const T pfy = ((implicDiv2Dflow * ((dx * a.drF[k]) * a.hFacS[p])) *
                   a.vStar[p]) / deltaTMom;
    const T pfxE = east ? ((implicDiv2Dflow * ((dyE * a.drF[k]) *
                                               a.hFacW[p + 1])) *
                           a.uStar[p + 1]) / deltaTMom
                        : T(0);
    const T pfyN = north ? ((implicDiv2Dflow * ((dxN * a.drF[k]) *
                                                a.hFacS[p + nxp])) *
                            a.vStar[p + nxp]) / deltaTMom
                         : T(0);
    const T dbx = pfxE - pfx, dby = pfyN - pfy;
    acc = acc + dbx;
    acc = acc + dby;
    if (!hydrostatic) a.div[p] = (dbx + dby) + (k == ks ? surfT : T(0));
  }
  a.out[q] = hydrostatic ? (acc - surfC * a.etaN[q]) * inner
                         : (acc + surfT) * inner;
}

template <typename T>
struct ContinuityArgs {
  const T *u, *v, *hFacW, *hFacS, *maskC, *dyG, *dxG, *recip_rA, *EmPmR,
      *drF;
  T *w, *PmEpR;
};
constexpr int kContinuityNumPointers = 12;

template <typename T>
__global__ void continuity_kernel(ContinuityArgs<T> a, int nr, int nyp,
                                  int nxp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t q = static_cast<size_t>(j) * nxp + i;
  const bool east = i + 1 < nxp, north = j + 1 < nyp;
  const T dy = a.dyG[q], dx = a.dxG[q], rrA = a.recip_rA[q];
  const T dyE = east ? a.dyG[q + 1] : T(0);
  const T dxN = north ? a.dxG[q + nxp] : T(0);
  T w_below = T(0);
  for (int k = nr - 1; k >= 0; --k) {
    const size_t p = k * P + q;
    const T uT = ((a.u[p] * dy) * a.drF[k]) * a.hFacW[p];
    const T vT = ((a.v[p] * dx) * a.drF[k]) * a.hFacS[p];
    const T uTE =
        east ? ((a.u[p + 1] * dyE) * a.drF[k]) * a.hFacW[p + 1] : T(0);
    const T vTN =
        north ? ((a.v[p + nxp] * dxN) * a.drF[k]) * a.hFacS[p + nxp] : T(0);
    const T div2d = (uTE - uT) + (vTN - vT);
    const T cr = -div2d * rrA;
    w_below = (w_below + cr) * a.maskC[p];
    a.w[p] = w_below;
  }
  a.PmEpR[q] = -a.EmPmR[q];
}

// Start cg2d_rhs with start(kernel, grid, block, args...) (OnStream on the
// card). The hydrostatic launch reads neither phi_nh, kSurfC nor recip_Bo
// and writes no div (their slots may be null).
template <typename T, typename Start>
int launch_cg2d_rhs(const void* const* t, int n, int nr, int nyp, int nxp,
                    int oly, int olx, int hydrostatic, double implicDiv2Dflow,
                    double deltaTMom, double freeSurfFac,
                    double deltaTFreeSurf, Start start) {
  static_assert(sizeof(Cg2dRhsArgs<T>) ==
                    kCg2dRhsNumPointers * sizeof(void*),
                "Cg2dRhsArgs must be a plain table of pointers");
  Cg2dRhsArgs<T> a;
  if (!unpack(&a, t, n, kCg2dRhsNumPointers) || nr < 1 || nyp < 1 ||
      nxp < 1 || !a.out ||
      (!hydrostatic && (!a.div || !a.phi_nh || !a.kSurfC || !a.recip_Bo)))
    return (int)cudaErrorInvalidValue;
  start(cg2d_rhs_kernel<T>, grid2d(nyp, nxp), dim3(BX, BY), a, nr, nyp, nxp,
        oly, olx, hydrostatic, T(implicDiv2Dflow), T(deltaTMom),
        T(freeSurfFac), T(deltaTFreeSurf));
  return (int)cudaGetLastError();
}

template <typename T, typename Start>
int launch_continuity(const void* const* t, int n, int nr, int nyp, int nxp,
                      Start start) {
  static_assert(sizeof(ContinuityArgs<T>) ==
                    kContinuityNumPointers * sizeof(void*),
                "ContinuityArgs must be a plain table of pointers");
  ContinuityArgs<T> a;
  if (!unpack(&a, t, n, kContinuityNumPointers) || nr < 1 || nyp < 1 ||
      nxp < 1)
    return (int)cudaErrorInvalidValue;
  start(continuity_kernel<T>, grid2d(nyp, nxp), dim3(BX, BY), a, nr, nyp,
        nxp);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
