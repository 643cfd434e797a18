// Kernel G' (mom_ab_step_adj, mom_correction_adj, tracer_step_adj): the
// VJPs of kernel G's three passes, and their launches. Included by
// step_glue_adj.cu, whose entry points start them on the card, and by the
// host check of the tests, which runs them on the CPU.
//
// Replaces the VJPs that jax.grad took of the fused elementwise passes of
// mitgcm_tpu/model/step.py (the momentum tendency's assembly, AB-2/AB-3
// and the predictor, :54-104 and :300-357; momentum_correction_step,
// :509-539) and mitgcm_tpu/model/thermodynamics.py (the tracer's forcing,
// AB and step, :329-358). Each pass is linear in what it differentiates,
// with host coefficients, so no value of the forward is needed:
//   mom_ab_step_adj (hydrostatic): from uStar_bar s and gNm1'_bar n,
//     c = (s * maskW) * deltaTMom, and under AB-2
//       g_bar = (n + c) + c * abFac, gNm1_bar = -(c * abFac),
//     under AB-3 g_bar = (n + c) + c * ab0, gNm1_bar = c * ab1,
//     gNm2_bar = c * ab2; gU, guDiss and guExt take g_bar, dPhiHydX
//     -g_bar (u_bar is s itself: the wrapper passes it through); v alike;
//   mom_correction_adj (hydrostatic): ub = u_bar * maskW is uStar_bar, the
//     surface-pressure gradient's cotangent is the level sum
//     PX = (sum_k ((-ub) * maskW)) * (deltaTMom * psFac), PY alike, and
//     etaN_bar = ((PX * recip_dxC - (PX * recip_dxC)[i+1]) +
//     (PY * recip_dyC - (PY * recip_dyC)[j+1])) * Bo_surf;
//   tracer_step_adj: from tracer'_bar s and gNm1'_bar n, c = s * deltaT,
//     g_bar as above (c without AB), gTr_bar = g_bar, and at level ksurf0
//     sfc_bar = (g_bar * recip_hFacC) * recip_drF(ksurf0).
//
// Bound: bytes. mom_ab_step_adj reads 2 cotangents and the mask and writes
// up to 4 fields a component (28 B/cell in float32 for u with AB-2's 3),
// mom_correction_adj reads u_bar, v_bar and the masks and writes uStar_bar
// and vStar_bar (24 B/cell) plus etaN_bar, tracer_step_adj reads 2 and
// writes 2 (AB-2) to 3; a few flops a cell.
// Design: gather form, no atomics. mom_ab_step_adj and tracer_step_adj:
// one thread a padded cell (common.cuh:cell_grid); an output that the
// caller does not want has a null pointer and is not written.
// mom_correction_adj: one thread a padded column, walking the levels with
// the sums of its own column and of its east and north neighbours in
// registers (their cotangents and masks are the neighbouring threads'
// loads). Each value keeps the order of the plain versions
// (model/step.py: mom_ab_step_vjp_plain, mom_correction_vjp_plain;
// model/thermodynamics.py: tracer_step_vjp_plain), so with --fmad=false
// the results are bit-equal to them.
#pragma once

#include "common.cuh"

namespace mitgcm {

// the AB extrapolation's transpose: {g_bar, gNm1_bar, gNm2_bar} from the
// extrapolated tendency's cotangent c and the raw tendency's n (has_n:
// whether the raw tendency is an output)
template <typename T>
struct AbAdj {
  int ab;  // 0: none, 2: AB-2, 3: AB-3
  T abFac, ab0, ab1, ab2;
  __device__ void operator()(T c, T n, bool has_n, T* out) const {
    const T gc = has_n ? n + c : c;
    if (ab == 2) {
      const T t = c * abFac;
      out[0] = gc + t;
      out[1] = -t;
      out[2] = T(0);
    } else if (ab == 3) {
      out[0] = gc + c * ab0;
      out[1] = c * ab1;
      out[2] = c * ab2;
    } else {
      out[0] = gc;
      out[1] = out[2] = T(0);
    }
  }
};

template <typename T>
struct MomAbAdjArgs {
  // the cotangents of uStar, guNm1', vStar, gvNm1'; maskW, maskS
  const T *uStar_bar, *gu_bar, *vStar_bar, *gv_bar, *maskW, *maskS;
  // outputs (null: not wanted): g_bar, -g_bar, gNm1_bar, gNm2_bar of u,
  // then of v
  T *gU_bar, *dPhiX_bar, *guNm1_bar, *guNm2_bar;
  T *gV_bar, *dPhiY_bar, *gvNm1_bar, *gvNm2_bar;
};
constexpr int kMomAbAdjNumPointers = 14;

template <typename T>
__device__ __forceinline__ void mom_ab_adj_component(
    const T* s, const T* n, const T* mask, T* g_bar, T* dphi_bar, T* nm1_bar,
    T* nm2_bar, size_t p, const AbAdj<T>& ab, T deltaTMom) {
  T out[3];
  ab((s[p] * mask[p]) * deltaTMom, n[p], true, out);
  if (g_bar) g_bar[p] = out[0];
  if (dphi_bar) dphi_bar[p] = -out[0];
  if (nm1_bar) nm1_bar[p] = out[1];
  if (nm2_bar) nm2_bar[p] = out[2];
}

template <typename T>
__global__ void mom_ab_step_adj_kernel(MomAbAdjArgs<T> a, int nyp, int nxp,
                                       AbAdj<T> ab, T deltaTMom) {
  GridCell g;
  if (!grid_cell_of(nyp, nxp, g)) return;
  mom_ab_adj_component(a.uStar_bar, a.gu_bar, a.maskW, a.gU_bar, a.dPhiX_bar,
                       a.guNm1_bar, a.guNm2_bar, g.p, ab, deltaTMom);
  mom_ab_adj_component(a.vStar_bar, a.gv_bar, a.maskS, a.gV_bar, a.dPhiY_bar,
                       a.gvNm1_bar, a.gvNm2_bar, g.p, ab, deltaTMom);
}

template <typename T>
struct MomCorrAdjArgs {
  // u_bar, v_bar, maskW, maskS [nr, nyp, nxp]; Bo_surf, recip_dxC,
  // recip_dyC [nyp, nxp]
  const T *u_bar, *v_bar, *maskW, *maskS, *Bo_surf, *recip_dxC, *recip_dyC;
  // outputs (null: not wanted): uStar_bar, vStar_bar; etaN_bar
  T *uStar_bar, *vStar_bar, *etaN_bar;
};
constexpr int kMomCorrAdjNumPointers = 10;

template <typename T>
__global__ void mom_correction_adj_kernel(MomCorrAdjArgs<T> a, int nr,
                                          int nyp, int nxp, T dtPsFac) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t q = static_cast<size_t>(j) * nxp + i;
  const bool east = i + 1 < nxp, north = j + 1 < nyp;
  // the level sums of (-(u_bar * maskW)) * maskW at this column and its
  // east neighbour, and of v's at this column and its north neighbour
  T sx = T(0), sxE = T(0), sy = T(0), syN = T(0);
  for (int k = 0; k < nr; ++k) {
    const size_t p = k * P + q;
    const T mW = a.maskW[p], mS = a.maskS[p];
    const T ub = a.u_bar[p] * mW, vb = a.v_bar[p] * mS;
    if (a.uStar_bar) a.uStar_bar[p] = ub;
    if (a.vStar_bar) a.vStar_bar[p] = vb;
    sx = sx + (-ub) * mW;
    sy = sy + (-vb) * mS;
    if (east) {
      const T mWE = a.maskW[p + 1];
      sxE = sxE + (-(a.u_bar[p + 1] * mWE)) * mWE;
    }
    if (north) {
      const T mSN = a.maskS[p + nxp];
      syN = syN + (-(a.v_bar[p + nxp] * mSN)) * mSN;
    }
  }
  if (!a.etaN_bar) return;
  const T ex = (sx * dtPsFac) * a.recip_dxC[q];
  const T exE = east ? (sxE * dtPsFac) * a.recip_dxC[q + 1] : T(0);
  const T ey = (sy * dtPsFac) * a.recip_dyC[q];
  const T eyN = north ? (syN * dtPsFac) * a.recip_dyC[q + nxp] : T(0);
  a.etaN_bar[q] = ((ex - exE) + (ey - eyN)) * a.Bo_surf[q];
}

template <typename T>
struct TracerAdjArgs {
  // the cotangents of tracer' and gNm1' [nr, nyp, nxp] (the latter unread
  // without AB); recip_hFacC at level ks [nyp, nxp]; recip_drF [nr]
  const T *tr_bar, *g_bar_in, *recip_hFacC_ks, *recip_drF;
  // outputs (null: not wanted): gTr_bar, gNm1_bar, gNm2_bar; sfc_bar
  T *gTr_bar, *gNm1_bar, *gNm2_bar, *sfc_bar;
};
constexpr int kTracerAdjNumPointers = 8;

template <typename T>
__global__ void tracer_step_adj_kernel(TracerAdjArgs<T> a, int nyp, int nxp,
                                       int ks, AbAdj<T> ab, T deltaT) {
  GridCell g;
  if (!grid_cell_of(nyp, nxp, g)) return;
  T out[3];
  ab(a.tr_bar[g.p] * deltaT, ab.ab ? a.g_bar_in[g.p] : T(0), ab.ab != 0,
     out);
  if (a.gTr_bar) a.gTr_bar[g.p] = out[0];
  if (a.gNm1_bar) a.gNm1_bar[g.p] = out[1];
  if (a.gNm2_bar) a.gNm2_bar[g.p] = out[2];
  if (g.k == ks && a.sfc_bar)
    a.sfc_bar[g.q] = (out[0] * a.recip_hFacC_ks[g.q]) * a.recip_drF[ks];
}

template <typename T>
AbAdj<T> ab_adj(int ab, double abFac, double ab0, double ab1, double ab2) {
  return AbAdj<T>{ab, T(abFac), T(ab0), T(ab1), T(ab2)};
}

template <typename T, typename Start>
int launch_mom_ab_step_adj(const void* const* table, int n, int nr, int nyp,
                           int nxp, int ab, double abFac, double ab0,
                           double ab1, double ab2, double deltaTMom,
                           Start start) {
  MomAbAdjArgs<T> a;
  if (!unpack(&a, table, n, kMomAbAdjNumPointers) || (ab != 2 && ab != 3) ||
      nr < 1 || nyp < 1 || nxp < 1 || !a.uStar_bar || !a.gu_bar ||
      !a.vStar_bar || !a.gv_bar || !a.maskW || !a.maskS ||
      (ab == 2 && (a.guNm2_bar || a.gvNm2_bar)))
    return (int)cudaErrorInvalidValue;
  start(mom_ab_step_adj_kernel<T>, cell_grid(nr, nyp, nxp),
        dim3(kCellX, kCellY), a, nyp, nxp,
        ab_adj<T>(ab, abFac, ab0, ab1, ab2), T(deltaTMom));
  return (int)cudaGetLastError();
}

template <typename T, typename Start>
int launch_mom_correction_adj(const void* const* table, int n, int nr,
                              int nyp, int nxp, double dtPsFac,
                              Start start) {
  MomCorrAdjArgs<T> a;
  if (!unpack(&a, table, n, kMomCorrAdjNumPointers) || nr < 1 || nyp < 1 ||
      nxp < 1 || !a.u_bar || !a.v_bar || !a.maskW || !a.maskS ||
      (a.etaN_bar && (!a.Bo_surf || !a.recip_dxC || !a.recip_dyC)))
    return (int)cudaErrorInvalidValue;
  start(mom_correction_adj_kernel<T>, grid2d(nyp, nxp), dim3(BX, BY), a, nr,
        nyp, nxp, T(dtPsFac));
  return (int)cudaGetLastError();
}

template <typename T, typename Start>
int launch_tracer_step_adj(const void* const* table, int n, int nr, int nyp,
                           int nxp, int ks, int ab, double abFac, double ab0,
                           double ab1, double ab2, double deltaT,
                           Start start) {
  TracerAdjArgs<T> a;
  if (!unpack(&a, table, n, kTracerAdjNumPointers) ||
      (ab != 0 && ab != 2 && ab != 3) || ks < 0 || ks >= nr || nyp < 1 ||
      nxp < 1 || !a.tr_bar || (ab && !a.g_bar_in) ||
      (ab != 3 && a.gNm2_bar) || (!ab && a.gNm1_bar) ||
      (a.sfc_bar && (!a.recip_hFacC_ks || !a.recip_drF)))
    return (int)cudaErrorInvalidValue;
  start(tracer_step_adj_kernel<T>, cell_grid(nr, nyp, nxp),
        dim3(kCellX, kCellY), a, nyp, nxp, ks,
        ab_adj<T>(ab, abFac, ab0, ab1, ab2), T(deltaT));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
