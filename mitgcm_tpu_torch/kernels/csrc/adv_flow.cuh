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

// Kernel L' (adv_flow_adj): the VJP of kernel L in u, v and w (maskUp, xA
// and yA depend on the grid alone and leave autograd's graph). Replaces
// the VJP that jax.grad took of calc_adv_flow (gad.py:64-78): the map is
// linear, so, with the level shift of rTransKp transposed,
//   u_bar = uTrans_bar * xA, v_bar = vTrans_bar * yA,
//   w_bar = ((rTrans_bar + rTransKp_bar[k-1]) * maskUp) * rA
// (rTransKp_bar[k-1] absent at the surface). Bound: bytes, it reads the
// four cotangents, hFacW, hFacS and maskC and writes three fields (40
// B/cell in float32). Design: gather form, one thread a padded cell
// (cell_grid; the level above's cotangent and mask from the cache); an
// output that the caller does not want has a null pointer and is not
// written. Each product keeps the order of the plain version
// (model/gad.py:adv_flow_vjp_plain), bit-equal to it with --fmad=false.
template <typename T>
struct AdvFlowAdjArgs {
  // the cotangents of uTrans, vTrans, rTrans, rTransKp; hFacW, hFacS,
  // maskC [nr]; dyG, dxG, rA; drF [nr]
  const T *uTrans_bar, *vTrans_bar, *rTrans_bar, *rTransKp_bar, *hFacW,
      *hFacS, *maskC, *dyG, *dxG, *rA, *drF;
  // outputs (null: not wanted)
  T *u_bar, *v_bar, *w_bar;
};
constexpr int kAdvFlowAdjNumPointers = 14;

template <typename T>
__global__ void adv_flow_adj_kernel(AdvFlowAdjArgs<T> a, int nyp, int nxp) {
  GridCell c;
  if (!grid_cell_of(nyp, nxp, c)) return;
  const size_t p = c.p, q = c.q, P = static_cast<size_t>(nyp) * nxp;
  if (a.u_bar)
    a.u_bar[p] = a.uTrans_bar[p] * ((a.dyG[q] * a.drF[c.k]) * a.hFacW[p]);
  if (a.v_bar)
    a.v_bar[p] = a.vTrans_bar[p] * ((a.dxG[q] * a.drF[c.k]) * a.hFacS[p]);
  if (a.w_bar) {
    const T up = c.k > 0 ? a.maskC[p] * a.maskC[p - P] : T(0);
    const T r = c.k > 0 ? a.rTrans_bar[p] + a.rTransKp_bar[p - P]
                        : a.rTrans_bar[p];
    a.w_bar[p] = (r * up) * a.rA[q];
  }
}

template <typename T, typename Start>
int launch_adv_flow_adj(const void* const* table, int n, int nr, int nyp,
                        int nxp, Start start) {
  AdvFlowAdjArgs<T> a;
  if (!unpack(&a, table, n, kAdvFlowAdjNumPointers) || nr < 1 || nyp < 1 ||
      nxp < 1 || (a.u_bar && (!a.uTrans_bar || !a.hFacW || !a.dyG)) ||
      (a.v_bar && (!a.vTrans_bar || !a.hFacS || !a.dxG)) ||
      (a.w_bar && (!a.rTrans_bar || !a.rTransKp_bar || !a.maskC || !a.rA)) ||
      !a.drF)
    return (int)cudaErrorInvalidValue;
  start(adv_flow_adj_kernel<T>, cell_grid(nr, nyp, nxp),
        dim3(kCellX, kCellY), a, nyp, nxp);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
