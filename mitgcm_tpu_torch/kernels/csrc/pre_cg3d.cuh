// Kernel N1 (pre_cg3d): the nh-convection box's cg3d right-hand side after
// the cg2d solve, and its launch. Included by pre_cg3d.cu, whose entry
// point starts it on the card, and by the host check of the tests, which
// runs it on the CPU.
//
// Replaces: mitgcm_tpu/model/step.py:solve_for_pressure's pre_cg3d
// (:432-500, pre_cg3d.F with oldFreeSurfTerm), which XLA fused into one
// pass over the padded [nr, nyp, nxp] arrays: from the new cg2d solution
// x2 and free surface etaN, the surface-pressure correction flow
//   uf = (-recip_dxC * psFac) * (x2 - x2[i-1]), fx = ((drF * dyG) * hFacW)
//   * uf, and vf, fy likewise in y,
// and the vertical transport of w*,
//   wterm = (k = 0: (freeSurfFac * etaN) / deltaTFreeSurf - w*[1];
//            k > 0: w*[k] maskC[k-1] - w*[k+1]) * rA / deltaTMom
// (w*[k+1] = 0 below the bottom level), added in the twin's order to each
// level's divergence (kernel E's non-hydrostatic div, which carries the
// surface term at kSurfC - 1):
//   b = ((div + (fx[i+1] - fx)) + (fy[j+1] - fy)) + wterm.
// A neighbour beyond the array reads 0, as the shifts' zero fill does.
//
// Bound: bytes. It reads div, w*, hFacW, hFacS and maskC and writes b (24
// B/cell in float32; the 2-D fields and the neighbours' cells come from
// the cache), about 30 flops a cell.
// Design: one thread a padded column (j, i), i fastest, walking the levels
// down: the correction flow at the column's four faces, the metrics, rA
// and etaN are formed once a column, w*[k+1] and maskC[k] carried to the
// next level, so a level reads div, w*[k+1], maskC and the faces' hFacW
// and hFacS (the east and north ones the neighbouring threads' loads).
// (One thread a cell, the level the fastest block index, formed the four
// face flows at every level: 0.54 of the bound.) Every product and
// division keeps the twin's order (model/step.py:_pre_cg3d_plain, which
// divides as tensors), so with --fmad=false the output is bit-equal to
// the twin's.
#pragma once

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct PreCg3dArgs {
  // [nyp, nxp]: the cg2d solution and the new free surface
  const T *x2, *etaN;
  // [nr, nyp, nxp]: kernel E's divergence, w*, hFacW, hFacS, maskC
  const T *div, *wStar, *hFacW, *hFacS, *maskC;
  // [nyp, nxp]: the metrics; [nr]: drF
  const T *recip_dxC, *recip_dyC, *dyG, *dxG, *rA, *drF;
  // output [nr, nyp, nxp]
  T* b;
};
constexpr int kPreCg3dNumPointers = 14;

template <typename T>
__global__ void pre_cg3d_kernel(PreCg3dArgs<T> a, int nr, int nyp, int nxp,
                                T psFac, T freeSurfFac, T deltaTFreeSurf,
                                T deltaTMom) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t q = static_cast<size_t>(j) * nxp + i;
  const bool east = i + 1 < nxp, north = j + 1 < nyp;
  // the correction flow through the west (i) and south (j) faces of a
  // column
  auto uf = [&](size_t qq, int ii) {
    return (-a.recip_dxC[qq] * psFac) *
           (a.x2[qq] - (ii > 0 ? a.x2[qq - 1] : T(0)));
  };
  auto vf = [&](size_t qq, int jj) {
    return (-a.recip_dyC[qq] * psFac) *
           (a.x2[qq] - (jj > 0 ? a.x2[qq - nxp] : T(0)));
  };
  const T ufW = uf(q, i), ufE = east ? uf(q + 1, i + 1) : T(0);
  const T vfS = vf(q, j), vfN = north ? vf(q + nxp, j + 1) : T(0);
  const T dyW = a.dyG[q], dyE = east ? a.dyG[q + 1] : T(0);
  const T dxS = a.dxG[q], dxN = north ? a.dxG[q + nxp] : T(0);
  const T rA = a.rA[q];
  const T surf = (freeSurfFac * a.etaN[q]) / deltaTFreeSurf;
  T wk = a.wStar[q], mAbove = T(0);
  for (int k = 0; k < nr; ++k) {
    const size_t p = k * P + q;
    const T drF = a.drF[k];
    const T fxW = ((drF * dyW) * a.hFacW[p]) * ufW;
    const T fxE = east ? ((drF * dyE) * a.hFacW[p + 1]) * ufE : T(0);
    const T fyS = ((drF * dxS) * a.hFacS[p]) * vfS;
    const T fyN = north ? ((drF * dxN) * a.hFacS[p + nxp]) * vfN : T(0);
    const T wkp1 = k + 1 < nr ? a.wStar[p + P] : T(0);
    const T wt = k == 0 ? surf - wkp1 : wk * mAbove - wkp1;
    const T wterm = (wt * rA) / deltaTMom;
    T b = a.div[p] + (fxE - fxW);
    b = b + (fyN - fyS);
    a.b[p] = b + wterm;
    wk = wkp1;
    mAbove = a.maskC[p];
  }
}

// Start pre_cg3d with start(kernel, grid, block, args...) (OnStream on the
// card).
template <typename T, typename Start>
int launch_pre_cg3d(const void* const* table, int n, int nr, int nyp,
                    int nxp, double psFac, double freeSurfFac,
                    double deltaTFreeSurf, double deltaTMom, Start start) {
  static_assert(sizeof(PreCg3dArgs<T>) ==
                    kPreCg3dNumPointers * sizeof(void*),
                "PreCg3dArgs must be a plain table of pointers");
  PreCg3dArgs<T> a;
  if (!unpack(&a, table, n, kPreCg3dNumPointers) || nr < 1 || nyp < 1 ||
      nxp < 1)
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < kPreCg3dNumPointers; ++t)
    if (!table[t]) return (int)cudaErrorInvalidValue;
  start(pre_cg3d_kernel<T>, grid2d(nyp, nxp), dim3(BX, BY), a, nr, nyp, nxp,
        T(psFac), T(freeSurfFac), T(deltaTFreeSurf), T(deltaTMom));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
