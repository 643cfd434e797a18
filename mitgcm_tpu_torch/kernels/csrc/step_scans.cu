// Kernel E: the step's two column scans, the cg2d right-hand side and the
// vertical velocity from continuity.
//
// Replaces: mitgcm_tpu/model/step.py:solve_for_pressure's right-hand side
// (:400-413, solve_for_pressure.F:146-152), the divergence of the predicted
// transport summed level by level in the order k = Nr..1 (a lax.scan),
// and integr_continuity's bottom-up integral for w (:557-640, a lax.scan):
//   cg2d_rhs:   pfx = ((implicDiv2Dflow * ((dyG * drF) * hFacW)) * uStar)
//                     / deltaTMom, pfy likewise with dxG, hFacS and vStar;
//               acc = 0; for k = Nr-1..0: acc = acc + (pfx[i+1] - pfx);
//                                         acc = acc + (pfy[j+1] - pfy);
//               hydrostatic: b = (acc - surfC * etaN) * interior mask,
//               surfC = ((freeSurfFac * rA) / deltaTMom) / deltaTFreeSurf;
//               non-hydrostatic: b = acc (the caller adds the surface term
//               of pre_cg3d and the mask), and each level's divergence
//               div = (pfx[i+1] - pfx) + (pfy[j+1] - pfy), the first term
//               of the cg3d right-hand side (step.py:421);
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
// div); continuity reads u, v,
// hFacW, hFacS and maskC and writes w (24 B/cell). About 10 flops a cell.
// Design: one thread per padded column (j, i), i fastest, walking the
// levels in the reference's order with the sum in a register; the east and
// north neighbours' transports are recomputed from their inputs (L1/L2
// hits: the neighbouring threads load the same cells), so nothing is
// written between levels. The Python twins (model/step.py:_cg2d_rhs_plain,
// _continuity_plain) divide by deltaTMom and deltaTFreeSurf as tensors,
// so with --fmad=false the kernel is bit-equal to them.

#include "common.cuh"

namespace mitgcm {

template <typename T>
__global__ void cg2d_rhs_kernel(const T* __restrict__ uStar,
                                const T* __restrict__ vStar,
                                const T* __restrict__ hFacW,
                                const T* __restrict__ hFacS,
                                const T* __restrict__ dyG,
                                const T* __restrict__ dxG,
                                const T* __restrict__ rA,
                                const T* __restrict__ etaN,
                                const T* __restrict__ drF,
                                T* __restrict__ out, T* __restrict__ div,
                                int nr, int nyp,
                                int nxp, int oly, int olx, int hydrostatic,
                                T implicDiv2Dflow, T deltaTMom,
                                T freeSurfFac, T deltaTFreeSurf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t q = static_cast<size_t>(j) * nxp + i;
  const bool east = i + 1 < nxp, north = j + 1 < nyp;
  const T dy = dyG[q], dx = dxG[q];
  const T dyE = east ? dyG[q + 1] : T(0);
  const T dxN = north ? dxG[q + nxp] : T(0);
  T acc = T(0);
  for (int k = nr - 1; k >= 0; --k) {
    const size_t p = k * P + q;
    const T pfx = ((implicDiv2Dflow * ((dy * drF[k]) * hFacW[p])) *
                   uStar[p]) / deltaTMom;
    const T pfy = ((implicDiv2Dflow * ((dx * drF[k]) * hFacS[p])) *
                   vStar[p]) / deltaTMom;
    const T pfxE = east ? ((implicDiv2Dflow * ((dyE * drF[k]) *
                                               hFacW[p + 1])) *
                           uStar[p + 1]) / deltaTMom
                        : T(0);
    const T pfyN = north ? ((implicDiv2Dflow * ((dxN * drF[k]) *
                                                hFacS[p + nxp])) *
                            vStar[p + nxp]) / deltaTMom
                         : T(0);
    const T dbx = pfxE - pfx, dby = pfyN - pfy;
    acc = acc + dbx;
    acc = acc + dby;
    if (!hydrostatic) div[p] = dbx + dby;
  }
  if (hydrostatic) {
    const T surfC = ((freeSurfFac * rA[q]) / deltaTMom) / deltaTFreeSurf;
    const bool inner = j >= oly && j < nyp - oly && i >= olx && i < nxp - olx;
    acc = (acc - surfC * etaN[q]) * (inner ? T(1) : T(0));
  }
  out[q] = acc;
}

template <typename T>
__global__ void continuity_kernel(const T* __restrict__ u,
                                  const T* __restrict__ v,
                                  const T* __restrict__ hFacW,
                                  const T* __restrict__ hFacS,
                                  const T* __restrict__ maskC,
                                  const T* __restrict__ dyG,
                                  const T* __restrict__ dxG,
                                  const T* __restrict__ recip_rA,
                                  const T* __restrict__ EmPmR,
                                  const T* __restrict__ drF,
                                  T* __restrict__ w, T* __restrict__ PmEpR,
                                  int nr, int nyp, int nxp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t q = static_cast<size_t>(j) * nxp + i;
  const bool east = i + 1 < nxp, north = j + 1 < nyp;
  const T dy = dyG[q], dx = dxG[q], rrA = recip_rA[q];
  const T dyE = east ? dyG[q + 1] : T(0);
  const T dxN = north ? dxG[q + nxp] : T(0);
  T w_below = T(0);
  for (int k = nr - 1; k >= 0; --k) {
    const size_t p = k * P + q;
    const T uT = ((u[p] * dy) * drF[k]) * hFacW[p];
    const T vT = ((v[p] * dx) * drF[k]) * hFacS[p];
    const T uTE = east ? ((u[p + 1] * dyE) * drF[k]) * hFacW[p + 1] : T(0);
    const T vTN =
        north ? ((v[p + nxp] * dxN) * drF[k]) * hFacS[p + nxp] : T(0);
    const T div2d = (uTE - uT) + (vTN - vT);
    const T cr = -div2d * rrA;
    w_below = (w_below + cr) * maskC[p];
    w[p] = w_below;
  }
  PmEpR[q] = -EmPmR[q];
}

template <typename T>
int launch_cg2d_rhs(const void* const* t, int n, int nr, int nyp, int nxp,
                    int oly, int olx, int hydrostatic, double implicDiv2Dflow,
                    double deltaTMom, double freeSurfFac,
                    double deltaTFreeSurf, void* stream) {
  if (n != 11 || nr < 1 || nyp < 1 || nxp < 1)
    return (int)cudaErrorInvalidValue;
  cg2d_rhs_kernel<T><<<grid2d(nyp, nxp), dim3(BX, BY), 0,
                       (cudaStream_t)stream>>>(
      (const T*)t[0], (const T*)t[1], (const T*)t[2], (const T*)t[3],
      (const T*)t[4], (const T*)t[5], (const T*)t[6], (const T*)t[7],
      (const T*)t[8], (T*)t[9], (T*)t[10], nr, nyp, nxp, oly, olx,
      hydrostatic,
      T(implicDiv2Dflow), T(deltaTMom), T(freeSurfFac), T(deltaTFreeSurf));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_continuity(const void* const* t, int n, int nr, int nyp, int nxp,
                      void* stream) {
  if (n != 12 || nr < 1 || nyp < 1 || nxp < 1)
    return (int)cudaErrorInvalidValue;
  continuity_kernel<T><<<grid2d(nyp, nxp), dim3(BX, BY), 0,
                         (cudaStream_t)stream>>>(
      (const T*)t[0], (const T*)t[1], (const T*)t[2], (const T*)t[3],
      (const T*)t[4], (const T*)t[5], (const T*)t[6], (const T*)t[7],
      (const T*)t[8], (const T*)t[9], (T*)t[10], (T*)t[11], nr, nyp, nxp);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define MITGCM_STEP_SCANS_ENTRY_POINTS(T, SUF)                                \
  extern "C" int mitgcm_cg2d_rhs_##SUF(                                       \
      const void* const* t, int n, int nr, int nyp, int nxp, int oly,         \
      int olx, int hydrostatic, double implicDiv2Dflow, double deltaTMom,     \
      double freeSurfFac, double deltaTFreeSurf, void* stream) {              \
    return mitgcm::launch_cg2d_rhs<T>(t, n, nr, nyp, nxp, oly, olx,           \
                                      hydrostatic, implicDiv2Dflow,           \
                                      deltaTMom, freeSurfFac,                 \
                                      deltaTFreeSurf, stream);                \
  }                                                                           \
  extern "C" int mitgcm_continuity_##SUF(const void* const* t, int n, int nr, \
                                         int nyp, int nxp, void* stream) {    \
    return mitgcm::launch_continuity<T>(t, n, nr, nyp, nxp, stream);          \
  }

MITGCM_STEP_SCANS_ENTRY_POINTS(float, f32)
MITGCM_STEP_SCANS_ENTRY_POINTS(double, f64)
