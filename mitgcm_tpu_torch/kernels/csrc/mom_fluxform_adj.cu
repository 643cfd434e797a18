// Kernel B': the VJP of kernel B (the flux-form momentum tendencies).
//
// Replaces: the reverse-mode derivative that jax.grad takes of
// mitgcm_tpu/model/mom_fluxform.py:mom_fluxform (:122-451) on the gyre's
// branches, which XLA fused on the TPU. Given the cotangents of gU, gV,
// guDiss and gvDiss it writes u_bar, v_bar and w_bar. The kappas and the
// grid are constants and get no cotangent.
//
// The advection terms are quadratic in (u, v, w), the rest is linear, so
// the partial derivatives need u, v and w and nothing else of the forward
// pass: the thread recomputes every transport, average and hFacZ it needs.
//
// Bound: bytes, like kernel B (its 11 3-D inputs plus 4 cotangents read,
// 3 fields written per cell); the neighbour reads hit L1/L2.
// Design: gather, not scatter. One thread per input cell (k, j, i) sums
// the contributions of every interior output cell whose stencil read that
// cell, flux by flux, in a fixed order and with no atomics, so the result
// is the same bits on every run. The reach is +-1 in i, j and k plus the
// (+-1, +-1) corners of the Coriolis averages and of the cross transports.
// Kernel B's halo outputs are constant zeros, so the cotangents are read on
// interior cells only; the inputs are written everywhere, nonzero up to
// one cell outside the interior, where the forward pass read them.

#include <cstring>

#include "mom_fluxform.cuh"

namespace mitgcm {

template <typename T>
struct MomAdjArgs {
  // kernel B's table; its output slots gU, gV, guDiss and gvDiss hold the
  // cotangents of those outputs
  MomArgs<T> f;
  // outputs [nr, nyp, nxp]
  T *u_bar, *v_bar, *w_bar;
};
constexpr int kMomAdjNumPointers = kMomNumPointers + 3;

template <typename T>
struct MomAdjCell {
  const MomCell<T>& c;
  int ny, nx, oly, olx;
  T rkSign, nAhD, nAhZ;

  __device__ const MomArgs<T>& a() const { return c.a; }
  __device__ bool row(int j) const { return j >= oly && j < oly + ny; }
  __device__ bool col(int i) const { return i >= olx && i < olx + nx; }
  __device__ bool in(int k, int j, int i) const {
    return k >= 0 && k < c.nr && row(j) && col(i);
  }

  // ---- cotangents at interior output cells, 0 elsewhere ----
  // of gU's advective bracket: gU = -(rhW rdrF rrAw) * bracket + uCf
  __device__ T aU(int k, int j, int i) const {
    if (!in(k, j, i)) return T(0);
    const size_t p = c.i3(k, j, i);
    return -(a().recip_hFacW[p] * a().recip_drF[k] *
             a().recip_rAw[c.i2(j, i)]) *
           (a().gU[p] * a().maskW[p]);
  }
  __device__ T aV(int k, int j, int i) const {
    if (!in(k, j, i)) return T(0);
    const size_t p = c.i3(k, j, i);
    return -(a().recip_hFacS[p] * a().recip_drF[k] *
             a().recip_rAs[c.i2(j, i)]) *
           (a().gV[p] * a().maskS[p]);
  }
  // of the viscous brackets of guDiss and gvDiss
  __device__ T dU(int k, int j, int i) const {
    if (!in(k, j, i)) return T(0);
    const size_t p = c.i3(k, j, i);
    return -(a().recip_hFacW[p] * a().recip_drF[k] *
             a().recip_rAw[c.i2(j, i)]) *
           (a().guDiss[p] * a().maskW[p]);
  }
  __device__ T dV(int k, int j, int i) const {
    if (!in(k, j, i)) return T(0);
    const size_t p = c.i3(k, j, i);
    return -(a().recip_hFacS[p] * a().recip_drF[k] *
             a().recip_rAs[c.i2(j, i)]) *
           (a().gvDiss[p] * a().maskS[p]);
  }
  // of the Coriolis terms uCf (in gU) and vCf (in gV)
  __device__ T cU(int k, int j, int i) const {
    if (!in(k, j, i)) return T(0);
    const size_t p = c.i3(k, j, i);
    return a().gU[p] * a().maskW[p];
  }
  __device__ T cV(int k, int j, int i) const {
    if (!in(k, j, i)) return T(0);
    const size_t p = c.i3(k, j, i);
    return a().gV[p] * a().maskS[p];
  }

  // ---- faces whose fluxes interior cells read (only there are the
  // partial derivatives, which read one cell further, evaluated) ----
  // fZonU, vZonU at (j, i): read by cells i and i+1
  __device__ bool zonU(int j, int i) const {
    return row(j) && i >= olx - 1 && i <= olx + nx - 1;
  }
  // fMerU, vMerU at (j, i): read by cells j-1 and j
  __device__ bool merU(int j, int i) const {
    return col(i) && j >= oly && j <= oly + ny;
  }
  // fZonV, vZonV at (j, i): read by cells i-1 and i
  __device__ bool zonV(int j, int i) const {
    return row(j) && i >= olx && i <= olx + nx;
  }
  // fMerV, vMerV at (j, i): read by cells j and j+1
  __device__ bool merV(int j, int i) const {
    return col(i) && j >= oly - 1 && j <= oly + ny - 1;
  }
  // fVerU/V at interface k (0 <= k < nr; the one below the bottom is 0)
  __device__ bool ver(int k, int j, int i) const { return in(k, j, i); }
  // rViscU/V at interface k (0 < k < nr)
  __device__ bool visc(int k, int j, int i) const {
    return k > 0 && in(k, j, i);
  }

  // ---- flux cotangents at a face, from the cells on either side ----
  __device__ T FzU(int k, int j, int i) const {
    return aU(k, j, i) - aU(k, j, i + 1);
  }
  __device__ T FmU(int k, int j, int i) const {
    return aU(k, j - 1, i) - aU(k, j, i);
  }
  __device__ T FvU(int k, int j, int i) const {
    return (aU(k - 1, j, i) - aU(k, j, i)) * rkSign;
  }
  __device__ T FzV(int k, int j, int i) const {
    return aV(k, j, i - 1) - aV(k, j, i);
  }
  __device__ T FmV(int k, int j, int i) const {
    return aV(k, j, i) - aV(k, j + 1, i);
  }
  __device__ T FvV(int k, int j, int i) const {
    return (aV(k - 1, j, i) - aV(k, j, i)) * rkSign;
  }
  __device__ T VzU(int k, int j, int i) const {
    return dU(k, j, i) - dU(k, j, i + 1);
  }
  __device__ T VmU(int k, int j, int i) const {
    return dU(k, j - 1, i) - dU(k, j, i);
  }
  __device__ T RvU(int k, int j, int i) const {
    return (dU(k - 1, j, i) - dU(k, j, i)) * rkSign;
  }
  __device__ T VzV(int k, int j, int i) const {
    return dV(k, j, i - 1) - dV(k, j, i);
  }
  __device__ T VmV(int k, int j, int i) const {
    return dV(k, j, i) - dV(k, j + 1, i);
  }
  __device__ T RvV(int k, int j, int i) const {
    return (dV(k - 1, j, i) - dV(k, j, i)) * rkSign;
  }

  // ---- coefficients of the linear viscous fluxes ----
  // vZonU(k, j, i) = ZU * (u(i+1) - u(i))
  __device__ T ZU(int k, int j, int i) const {
    const size_t q = c.i2(j, i);
    return a().dyF[q] * a().drF[k] * a().hFacC[c.i3(k, j, i)] *
           a().recip_dxF[q] * nAhD * a().cosFacU[q];
  }
  // vMerU(k, j, i) = MU * (u(j) - u(j-1))
  __device__ T MU(int k, int j, int i) const {
    const size_t q = c.i2(j, i);
    return a().dxV[q] * a().drF[k] * c.hFacZ(k, j, i) * a().recip_dyU[q] *
           nAhZ;
  }
  // rViscU(k, j, i) = RU * (u(k) - u(k-1))
  __device__ T RU(int k, int j, int i) const {
    const size_t p = c.i3(k, j, i);
    return -a().kappaRU[p] * a().rAw[c.i2(j, i)] * rkSign *
           a().recip_drC[k] * a().maskW[p] * a().maskW[c.i3(k - 1, j, i)];
  }
  // vZonV(k, j, i) = ZV * (v(i) - v(i-1))
  __device__ T ZV(int k, int j, int i) const {
    const size_t q = c.i2(j, i);
    return a().dyU[q] * a().drF[k] * c.hFacZ(k, j, i) * a().recip_dxV[q] *
           nAhZ * a().cosFacV[q];
  }
  // vMerV(k, j, i) = MV * (v(j+1) - v(j))
  __device__ T MV(int k, int j, int i) const {
    const size_t q = c.i2(j, i);
    return a().dxF[q] * a().drF[k] * a().hFacC[c.i3(k, j, i)] *
           a().recip_dyF[q] * nAhD;
  }
  __device__ T RV(int k, int j, int i) const {
    const size_t p = c.i3(k, j, i);
    return -a().kappaRV[p] * a().rAs[c.i2(j, i)] * rkSign *
           a().recip_drC[k] * a().maskS[p] * a().maskS[c.i3(k - 1, j, i)];
  }

  // ---- partials of the vertical advective fluxes ----
  // d fVerU(k, j, i) / d u(k, j, i)
  __device__ T dVerU_u(int k, int j, int i) const {
    const T rTr = T(0.5) * (c.wrA(k, j, i) + c.wrA(k, j, i - 1));
    if (k == 0) return rTr;
    return rTr * T(0.5) + T(0.25) * (c.wrA(k, j, i) * c.dmask(k, j, i) +
                                     c.wrA(k, j, i - 1) * c.dmask(k, j, i - 1));
  }
  // d fVerU(k, j, i) / d u(k-1, j, i), 0 < k
  __device__ T dVerU_ukm1(int k, int j, int i) const {
    return T(0.5) * (c.wrA(k, j, i) + c.wrA(k, j, i - 1)) * T(0.5);
  }
  __device__ T dVerV_v(int k, int j, int i) const {
    const T rTr = T(0.5) * (c.wrA(k, j, i) + c.wrA(k, j - 1, i));
    if (k == 0) return rTr;
    return rTr * T(0.5) + T(0.25) * (c.wrA(k, j, i) * c.dmask(k, j, i) +
                                     c.wrA(k, j - 1, i) * c.dmask(k, j - 1, i));
  }
  __device__ T dVerV_vkm1(int k, int j, int i) const {
    return T(0.5) * (c.wrA(k, j, i) + c.wrA(k, j - 1, i)) * T(0.5);
  }
  // d fVer(k) / d w(k, j, i) where the flux reads w(k, j, i) as one of the
  // two cells of its rTrans average; vel is u or v at (k) and (k-1) of the
  // flux's own column
  __device__ T dVer_w(int k, int j, int i, T vel, T velkm1) const {
    const T rA = a().rA[c.i2(j, i)];
    if (k == 0) return T(0.5) * rA * vel;
    return T(0.5) * rA * T(0.5) * (vel + velkm1) +
           T(0.25) * rA * c.dmask(k, j, i) * vel;
  }
};

template <typename T>
__global__ void mom_fluxform_adj_kernel(const MomAdjArgs<T> b, int nr, int ny,
                                        int nx, int oly, int olx, T viscAhD,
                                        T viscAhZ, T sideDragFactor,
                                        T rkSign) {
  const int nyp = ny + 2 * oly, nxp = nx + 2 * olx;
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const MomArgs<T>& a = b.f;
  const MomCell<T> c{a, nr, nyp, nxp};
  const MomAdjCell<T> d{c, ny, nx, oly, olx, rkSign, -viscAhD, -viscAhZ};
  const size_t p = c.i3(k, j, i);
  // no interior output reads a cell more than one cell outside the
  // interior
  if (i < olx - 1 || i > olx + nx || j < oly - 1 || j > oly + ny) {
    b.u_bar[p] = T(0);
    b.v_bar[p] = T(0);
    b.w_bar[p] = T(0);
    return;
  }
  const size_t q = c.i2(j, i);
  const T* u = a.u;
  const T* v = a.v;
  const T q25 = T(0.25);

  // ------------------------------- u_bar -------------------------------
  T ub = T(0);
  const T xA = a.dyG[q] * a.drF[k] * a.hFacW[p];
  // advection: fZonU at i (u(i) as its own) and at i-1 (u(i) as its i+1)
  if (d.zonU(j, i))
    ub = ub + d.FzU(k, j, i) *
                  (q25 * (xA * (u[p] + u[p + 1]) +
                          (c.uTrans(k, j, i) + c.uTrans(k, j, i + 1))));
  if (d.zonU(j, i - 1))
    ub = ub + d.FzU(k, j, i - 1) *
                  (q25 * (xA * (u[p - 1] + u[p]) +
                          (c.uTrans(k, j, i - 1) + c.uTrans(k, j, i))));
  // fMerU at j (u(j) as its own) and at j+1 (u(j) as its j-1)
  if (d.merU(j, i))
    ub = ub + d.FmU(k, j, i) * (q25 * (c.vTrans(k, j, i) +
                                       c.vTrans(k, j, i - 1)));
  if (d.merU(j + 1, i))
    ub = ub + d.FmU(k, j + 1, i) * (q25 * (c.vTrans(k, j + 1, i) +
                                           c.vTrans(k, j + 1, i - 1)));
  // fZonV at (j, i) and (j+1, i) read uTrans(j, i)
  if (d.zonV(j, i))
    ub = ub + d.FzV(k, j, i) * (q25 * xA * (v[p] + v[p - 1]));
  if (d.zonV(j + 1, i))
    ub = ub + d.FzV(k, j + 1, i) * (q25 * xA * (v[p + nxp] + v[p + nxp - 1]));
  // fVerU at interface k (u(k) as its own) and k+1 (u(k) as its k-1)
  if (d.ver(k, j, i)) ub = ub + d.FvU(k, j, i) * d.dVerU_u(k, j, i);
  if (d.ver(k + 1, j, i))
    ub = ub + d.FvU(k + 1, j, i) * d.dVerU_ukm1(k + 1, j, i);
  // Coriolis vCf of the cells (j, i), (j, i-1), (j+1, i), (j+1, i-1)
  for (int dj = 0; dj <= 1; ++dj)
    for (int di = -1; di <= 0; ++di) {
      const int jj = j + dj, ii = i + di;
      if (!d.in(k, jj, ii)) continue;
      const size_t qq = c.i2(jj, ii);
      ub = ub + d.cV(k, jj, ii) *
                    (T(-0.5) * (a.fCori[qq] + a.fCori[qq - nxp]) * q25);
    }
  // harmonic and vertical viscous fluxes
  if (d.zonU(j, i)) ub = ub - d.VzU(k, j, i) * d.ZU(k, j, i);
  if (d.zonU(j, i - 1)) ub = ub + d.VzU(k, j, i - 1) * d.ZU(k, j, i - 1);
  if (d.merU(j, i)) ub = ub + d.VmU(k, j, i) * d.MU(k, j, i);
  if (d.merU(j + 1, i)) ub = ub - d.VmU(k, j + 1, i) * d.MU(k, j + 1, i);
  if (d.visc(k, j, i)) ub = ub + d.RvU(k, j, i) * d.RU(k, j, i);
  if (d.visc(k + 1, j, i))
    ub = ub - d.RvU(k + 1, j, i) * d.RU(k + 1, j, i);

  // ------------------------------- v_bar -------------------------------
  T vb = T(0);
  const T yA = a.dxG[q] * a.drF[k] * a.hFacS[p];
  // advection: fMerU at (j, i) and (j, i+1) read vTrans(j, i)
  if (d.merU(j, i))
    vb = vb + d.FmU(k, j, i) * (q25 * yA * (u[p] + u[p - nxp]));
  if (d.merU(j, i + 1))
    vb = vb + d.FmU(k, j, i + 1) * (q25 * yA * (u[p + 1] + u[p - nxp + 1]));
  // fZonV at i (v(i) as its own) and at i+1 (v(i) as its i-1)
  if (d.zonV(j, i))
    vb = vb + d.FzV(k, j, i) * (q25 * (c.uTrans(k, j, i) +
                                       c.uTrans(k, j - 1, i)));
  if (d.zonV(j, i + 1))
    vb = vb + d.FzV(k, j, i + 1) * (q25 * (c.uTrans(k, j, i + 1) +
                                           c.uTrans(k, j - 1, i + 1)));
  // fMerV at j (v(j) as its own) and at j-1 (v(j) as its j+1)
  if (d.merV(j, i))
    vb = vb + d.FmV(k, j, i) *
                  (q25 * (yA * (v[p] + v[p + nxp]) +
                          (c.vTrans(k, j, i) + c.vTrans(k, j + 1, i))));
  if (d.merV(j - 1, i))
    vb = vb + d.FmV(k, j - 1, i) *
                  (q25 * (yA * (v[p - nxp] + v[p]) +
                          (c.vTrans(k, j - 1, i) + c.vTrans(k, j, i))));
  if (d.ver(k, j, i)) vb = vb + d.FvV(k, j, i) * d.dVerV_v(k, j, i);
  if (d.ver(k + 1, j, i))
    vb = vb + d.FvV(k + 1, j, i) * d.dVerV_vkm1(k + 1, j, i);
  // Coriolis uCf of the cells (j, i), (j-1, i), (j, i+1), (j-1, i+1)
  for (int dj = -1; dj <= 0; ++dj)
    for (int di = 0; di <= 1; ++di) {
      const int jj = j + dj, ii = i + di;
      if (!d.in(k, jj, ii)) continue;
      const size_t qq = c.i2(jj, ii);
      vb = vb + d.cU(k, jj, ii) *
                    (T(0.5) * (a.fCori[qq] + a.fCori[qq - 1]) * q25);
    }
  if (d.zonV(j, i)) vb = vb + d.VzV(k, j, i) * d.ZV(k, j, i);
  if (d.zonV(j, i + 1)) vb = vb - d.VzV(k, j, i + 1) * d.ZV(k, j, i + 1);
  if (d.merV(j, i)) vb = vb - d.VmV(k, j, i) * d.MV(k, j, i);
  if (d.merV(j - 1, i)) vb = vb + d.VmV(k, j - 1, i) * d.MV(k, j - 1, i);
  if (d.visc(k, j, i)) vb = vb + d.RvV(k, j, i) * d.RV(k, j, i);
  if (d.visc(k + 1, j, i))
    vb = vb - d.RvV(k + 1, j, i) * d.RV(k + 1, j, i);

  // ---- the cell's own side and bottom drag, linear in u and v ----
  if (d.in(k, j, i)) {
    const T rhW = a.recip_hFacW[p], rhS = a.recip_hFacS[p];
    const T rdrF = a.recip_drF[k], drF = a.drF[k];
    const T hZ = c.hFacZ(k, j, i);
    const T dragU =
        -(rhW * rdrF * a.recip_rAw[q] *
          ((a.hFacW[p] - hZ) * a.dxV[q] * a.recip_dyU[q] +
           (a.hFacW[p] - c.hFacZ(k, j + 1, i)) * a.dxV[q + nxp] *
               a.recip_dyU[q + nxp]) *
          viscAhZ * drF * sideDragFactor);
    const T dragV =
        -(rhS * rdrF * a.recip_rAs[q] *
          ((a.hFacS[p] - hZ) * a.dyU[q] * a.recip_dxV[q] +
           (a.hFacS[p] - c.hFacZ(k, j, i + 1)) * a.dyU[q + 1] *
               a.recip_dxV[q + 1]) *
          viscAhZ * a.cosFacV[q] * drF * sideDragFactor);
    const bool deepest = (k == nr - 1);
    const T recDr = deepest ? a.recip_drF[nr - 1] : a.recip_drC[k + 1];
    const size_t below = p + static_cast<size_t>(nyp) * nxp;
    const T bottomW = a.maskW[p] * (deepest ? T(1) : T(1) - a.maskW[below]);
    const T bottomS = a.maskS[p] * (deepest ? T(1) : T(1) - a.maskS[below]);
    const T botU = -(a.kappaRU[c.i3(k + 1, j, i)] * recDr * T(2)) * bottomW *
                   rhW * rdrF;
    const T botV = -(a.kappaRV[c.i3(k + 1, j, i)] * recDr * T(2)) * bottomS *
                   rhS * rdrF;
    ub = ub + (a.guDiss[p] * a.maskW[p]) * (dragU + botU);
    vb = vb + (a.gvDiss[p] * a.maskS[p]) * (dragV + botV);
  }

  // ------------------------------- w_bar -------------------------------
  // fVerU at (k, j, i) and (k, j, i+1) and fVerV at (k, j, i) and
  // (k, j+1, i) average w(k, j, i) into their rTrans
  T wb = T(0);
  const size_t up = p - static_cast<size_t>(nyp) * nxp;
  if (d.ver(k, j, i)) {
    wb = wb + d.FvU(k, j, i) * d.dVer_w(k, j, i, u[p], k > 0 ? u[up] : T(0));
    wb = wb + d.FvV(k, j, i) * d.dVer_w(k, j, i, v[p], k > 0 ? v[up] : T(0));
  }
  if (d.ver(k, j, i + 1))
    wb = wb + d.FvU(k, j, i + 1) *
                  d.dVer_w(k, j, i, u[p + 1], k > 0 ? u[up + 1] : T(0));
  if (d.ver(k, j + 1, i))
    wb = wb + d.FvV(k, j + 1, i) *
                  d.dVer_w(k, j, i, v[p + nxp], k > 0 ? v[up + nxp] : T(0));

  b.u_bar[p] = ub;
  b.v_bar[p] = vb;
  b.w_bar[p] = wb;
}

template <typename T>
int launch_mom_adj(const void* const* table, int n, int nr, int ny, int nx,
                   int oly, int olx, double viscAhD, double viscAhZ,
                   double sideDragFactor, double rkSign, void* stream) {
  static_assert(sizeof(MomAdjArgs<T>) == kMomAdjNumPointers * sizeof(void*),
                "MomAdjArgs must be a plain table of pointers");
  if (n != kMomAdjNumPointers || oly < 1 || olx < 1)
    return (int)cudaErrorInvalidValue;
  MomAdjArgs<T> b;
  std::memcpy(&b, table, sizeof(b));
  const dim3 g((nx + 2 * olx + BX - 1) / BX, (ny + 2 * oly + BY - 1) / BY,
               nr);
  mom_fluxform_adj_kernel<T><<<g, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      b, nr, ny, nx, oly, olx, T(viscAhD), T(viscAhZ), T(sideDragFactor),
      T(rkSign));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

extern "C" int mitgcm_mom_fluxform_adj_f32(const void* const* table, int n,
                                           int nr, int ny, int nx, int oly,
                                           int olx, double viscAhD,
                                           double viscAhZ,
                                           double sideDragFactor,
                                           double rkSign, void* stream) {
  return mitgcm::launch_mom_adj<float>(table, n, nr, ny, nx, oly, olx,
                                       viscAhD, viscAhZ, sideDragFactor,
                                       rkSign, stream);
}

extern "C" int mitgcm_mom_fluxform_adj_f64(const void* const* table, int n,
                                           int nr, int ny, int nx, int oly,
                                           int olx, double viscAhD,
                                           double viscAhZ,
                                           double sideDragFactor,
                                           double rkSign, void* stream) {
  return mitgcm::launch_mom_adj<double>(table, n, nr, ny, nx, oly, olx,
                                        viscAhD, viscAhZ, sideDragFactor,
                                        rkSign, stream);
}
