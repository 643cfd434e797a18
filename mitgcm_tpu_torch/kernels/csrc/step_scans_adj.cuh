// Kernel E' (cg2d_rhs_adj, continuity_adj): the VJPs of kernel E's two
// column scans, and their launches. Included by step_scans_adj.cu, whose
// entry points start them on the card, and by the host check of the tests,
// which runs them on the CPU.
//
// Replaces the VJPs that jax.grad took of mitgcm_tpu/model/step.py's cg2d
// right-hand side (:400-413) and integr_continuity (:557-640), each a
// lax.scan over the levels that XLA transposed into a scan the other way:
//   cg2d_rhs_adj (the hydrostatic right-hand side, linear in uStar, vStar
//     and etaN): with a = b_bar * (interior mask), every level's dbx and
//     dby take a, so
//       pfx_bar = a[i-1] - a, uStar_bar = (pfx_bar / deltaTMom) *
//       (implicDiv2Dflow * ((dyG * drF) * hFacW)), vStar_bar likewise in j,
//       etaN_bar = (-a) * (((freeSurfFac * rA) / deltaTMom) /
//       deltaTFreeSurf);
//   continuity_adj (linear in u, v and EmPmR): the bottom-up masked scan
//     w(k) = (w(k+1) + cr(k)) * maskC(k) transposes into the top-down scan
//       s(k) = (w_bar(k) + s(k-1)) * maskC(k), s(-1) absent, cr_bar = s,
//     cr = -div2d * recip_rA into d = -(s * recip_rA), and the divergence
//     into uTrans_bar = d[i-1] - d, u_bar = ((uTrans_bar * hFacW) * drF) *
//     dyG, v_bar likewise in j; EmPmR_bar = -PmEpR_bar.
// The neighbour before the first column or row is 0, the transpose of the
// shifts' zero fill, so every padded cell comes out as the plain
// version's.
//
// Bound: bytes. cg2d_rhs_adj reads hFacW and hFacS and writes uStar_bar and
// vStar_bar (16 B/cell in float32) plus a few 2-D fields; continuity_adj
// reads w_bar, maskC, hFacW and hFacS and writes u_bar and v_bar (24
// B/cell). About 10 flops a cell.
// Design: gather form, no atomics. cg2d_rhs_adj: one thread a padded cell
// (common.cuh:cell_grid), its 2-D cotangent and its west and south
// neighbours' read in place; the level-0 threads write etaN_bar.
// continuity_adj: one thread a padded column, walking the levels from the
// surface down with its own s and its west and south neighbours' in
// registers (their w_bar and maskC are the neighbouring threads' loads).
// Each value keeps the order of the plain versions (model/step.py:
// cg2d_rhs_vjp_plain, continuity_vjp_plain), which divide by deltaTMom as
// a tensor, so with --fmad=false the results are bit-equal to them.
#pragma once

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct Cg2dRhsAdjArgs {
  // b_bar [nyp, nxp]; hFacW, hFacS [nr, nyp, nxp]; dyG, dxG, rA; drF [nr]
  const T *b_bar, *hFacW, *hFacS, *dyG, *dxG, *rA, *drF;
  // outputs (null: not wanted): uStar_bar, vStar_bar; etaN_bar
  T *uStar_bar, *vStar_bar, *etaN_bar;
};
constexpr int kCg2dRhsAdjNumPointers = 10;

template <typename T>
__global__ void cg2d_rhs_adj_kernel(Cg2dRhsAdjArgs<T> a, int nr, int nyp,
                                    int nxp, int oly, int olx, T c, T dtm,
                                    T freeSurfFac, T dtfs) {
  GridCell g;
  if (!grid_cell_of(nyp, nxp, g)) return;
  const int i = g.i, j = g.j;
  // a = b_bar * interior mask, at (j, i) and its west and south neighbours
  auto a_at = [&](int jj, int ii) -> T {
    const bool inner = jj >= oly && jj < nyp - oly && ii >= olx &&
                       ii < nxp - olx;
    return a.b_bar[static_cast<size_t>(jj) * nxp + ii] *
           (inner ? T(1) : T(0));
  };
  const T a0 = a_at(j, i);
  const T aW = i > 0 ? a_at(j, i - 1) : T(0);
  const T aS = j > 0 ? a_at(j - 1, i) : T(0);
  const T drF = a.drF[g.k];
  if (a.uStar_bar)
    a.uStar_bar[g.p] =
        ((aW - a0) / dtm) * (c * ((a.dyG[g.q] * drF) * a.hFacW[g.p]));
  if (a.vStar_bar)
    a.vStar_bar[g.p] =
        ((aS - a0) / dtm) * (c * ((a.dxG[g.q] * drF) * a.hFacS[g.p]));
  if (g.k == 0 && a.etaN_bar)
    a.etaN_bar[g.q] = (-a0) * (((freeSurfFac * a.rA[g.q]) / dtm) / dtfs);
}

template <typename T>
struct ContinuityAdjArgs {
  // w_bar, maskC, hFacW, hFacS [nr, nyp, nxp]; dyG, dxG, recip_rA; drF
  // [nr]; PmEpR_bar [nyp, nxp]
  const T *w_bar, *maskC, *hFacW, *hFacS, *dyG, *dxG, *recip_rA, *drF,
      *PmEpR_bar;
  // outputs (null: not wanted): u_bar, v_bar; EmPmR_bar
  T *u_bar, *v_bar, *EmPmR_bar;
};
constexpr int kContinuityAdjNumPointers = 12;

template <typename T>
__global__ void continuity_adj_kernel(ContinuityAdjArgs<T> a, int nr,
                                      int nyp, int nxp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t q = static_cast<size_t>(j) * nxp + i;
  const bool west = i > 0, south = j > 0;
  const T rrA = a.recip_rA[q];
  const T rrAW = west ? a.recip_rA[q - 1] : T(0);
  const T rrAS = south ? a.recip_rA[q - nxp] : T(0);
  const T dy = a.dyG[q], dx = a.dxG[q];
  // the transposed scan's s of this column and of its west and south
  // neighbours
  T s = T(0), sW = T(0), sS = T(0);
  for (int k = 0; k < nr; ++k) {
    const size_t p = k * P + q;
    s = (k == 0 ? a.w_bar[p] : a.w_bar[p] + s) * a.maskC[p];
    const T d = -(s * rrA);
    T dW = T(0), dS = T(0);
    if (west) {
      sW = (k == 0 ? a.w_bar[p - 1] : a.w_bar[p - 1] + sW) * a.maskC[p - 1];
      dW = -(sW * rrAW);
    }
    if (south) {
      sS = (k == 0 ? a.w_bar[p - nxp] : a.w_bar[p - nxp] + sS) *
           a.maskC[p - nxp];
      dS = -(sS * rrAS);
    }
    const T drF = a.drF[k];
    if (a.u_bar) a.u_bar[p] = (((dW - d) * a.hFacW[p]) * drF) * dy;
    if (a.v_bar) a.v_bar[p] = (((dS - d) * a.hFacS[p]) * drF) * dx;
  }
  if (a.EmPmR_bar) a.EmPmR_bar[q] = -a.PmEpR_bar[q];
}

template <typename T, typename Start>
int launch_cg2d_rhs_adj(const void* const* table, int n, int nr, int nyp,
                        int nxp, int oly, int olx, double implicDiv2Dflow,
                        double deltaTMom, double freeSurfFac,
                        double deltaTFreeSurf, Start start) {
  Cg2dRhsAdjArgs<T> a;
  if (!unpack(&a, table, n, kCg2dRhsAdjNumPointers) || nr < 1 || nyp < 1 ||
      nxp < 1 || oly < 0 || olx < 0 || !a.b_bar || !a.hFacW || !a.hFacS ||
      !a.dyG || !a.dxG || !a.rA || !a.drF)
    return (int)cudaErrorInvalidValue;
  start(cg2d_rhs_adj_kernel<T>, cell_grid(nr, nyp, nxp),
        dim3(kCellX, kCellY), a, nr, nyp, nxp, oly, olx, T(implicDiv2Dflow),
        T(deltaTMom), T(freeSurfFac), T(deltaTFreeSurf));
  return (int)cudaGetLastError();
}

template <typename T, typename Start>
int launch_continuity_adj(const void* const* table, int n, int nr, int nyp,
                          int nxp, Start start) {
  ContinuityAdjArgs<T> a;
  if (!unpack(&a, table, n, kContinuityAdjNumPointers) || nr < 1 ||
      nyp < 1 || nxp < 1 || !a.w_bar || !a.maskC || !a.hFacW || !a.hFacS ||
      !a.dyG || !a.dxG || !a.recip_rA || !a.drF ||
      (a.EmPmR_bar && !a.PmEpR_bar))
    return (int)cudaErrorInvalidValue;
  start(continuity_adj_kernel<T>, grid2d(nyp, nxp), dim3(BX, BY), a, nr, nyp,
        nxp);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
