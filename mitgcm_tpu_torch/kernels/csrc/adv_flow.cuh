// Kernel L (adv_flow): the advective transports and face areas of
// calc_adv_flow.F, and its launch. Included by adv_flow.cu, whose entry
// point starts it on the card, and by the host check of the tests, which
// runs it on the CPU.
//
// Replaces: mitgcm_tpu/model/gad.py:calc_adv_flow (:64-78), which XLA fused
// into one elementwise pass writing seven fields:
//   xA = (dyG * drF) * hFacW, yA = (dxG * drF) * hFacS,
//   uTrans = u * xA, vTrans = v * yA,
//   maskUp = 0 at the surface, maskC * maskC[k-1] below,
//   rTrans = (w * rA) * maskUp, rTransKp[k] = rTrans[k+1], 0 at the bottom.
//
// Bound: bytes. It reads u, v, w, hFacW, hFacS and maskC and writes the
// seven fields (52 B/cell in float32), for about 8 flops a cell.
// Design: one thread a padded cell (common.cuh:cell_grid, the level the
// fastest block index, so that rTransKp's w and maskC of the level below
// and maskUp's maskC of the level above come from the cache). Each product
// keeps the twin's order (model/gad.py:_calc_adv_flow_plain), rTrans's
// surface product with maskUp's 0 included (a NaN w stays NaN), so with
// --fmad=false every output is bit-equal to the twin's.
#pragma once

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct AdvFlowArgs {
  // u, v, w, hFacW, hFacS, maskC [nr]; dyG, dxG, rA; drF [nr]
  const T *u, *v, *w, *hFacW, *hFacS, *maskC, *dyG, *dxG, *rA, *drF;
  T *uTrans, *vTrans, *rTrans, *rTransKp, *maskUp, *xA, *yA;
};
constexpr int kAdvFlowNumPointers = 17;

template <typename T>
__global__ void adv_flow_kernel(AdvFlowArgs<T> a, int nr, int nyp,
                                int nxp) {
  GridCell c;
  if (!grid_cell_of(nyp, nxp, c)) return;
  const size_t p = c.p, q = c.q, P = static_cast<size_t>(nyp) * nxp;
  const T xA = (a.dyG[q] * a.drF[c.k]) * a.hFacW[p];
  const T yA = (a.dxG[q] * a.drF[c.k]) * a.hFacS[p];
  a.xA[p] = xA;
  a.yA[p] = yA;
  a.uTrans[p] = a.u[p] * xA;
  a.vTrans[p] = a.v[p] * yA;
  const T rA = a.rA[q];
  const T mC = a.maskC[p];
  const T up = c.k > 0 ? mC * a.maskC[p - P] : T(0);
  a.maskUp[p] = up;
  a.rTrans[p] = (a.w[p] * rA) * up;
  a.rTransKp[p] =
      c.k + 1 < nr ? (a.w[p + P] * rA) * (a.maskC[p + P] * mC) : T(0);
}

template <typename T, typename Start>
int launch_adv_flow(const void* const* table, int n, int nr, int nyp,
                    int nxp, Start start) {
  AdvFlowArgs<T> a;
  if (!unpack(&a, table, n, kAdvFlowNumPointers) || nr < 1 || nyp < 1 ||
      nxp < 1)
    return (int)cudaErrorInvalidValue;
  start(adv_flow_kernel<T>, cell_grid(nr, nyp, nxp), dim3(kCellX, kCellY), a,
        nr, nyp, nxp);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
