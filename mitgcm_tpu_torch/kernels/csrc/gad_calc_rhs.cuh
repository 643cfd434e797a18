// Kernel C's argument table and its per-cell fluxes, shared by the
// forward kernel (gad_calc_rhs.cu) and its VJP (gad_calc_rhs_adj.cu).
#pragma once

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct GadArgs {
  // [nr, nyp, nxp]
  const T *uTrans, *vTrans, *rTrans, *xA, *yA, *maskUp, *tracer, *kappaR,
      *maskC, *recip_hFacC;
  // [nyp, nxp]
  const T *rA, *recip_dxC, *recip_dyC, *cosFacU, *recip_rA, *maskInC;
  // [nr] and [nr+1]
  const T *recip_drF, *recip_drC;
  // output [nr, nyp, nxp]
  T* gTr;
};
constexpr int kGadNumPointers = 19;

// the GM-Redi tensor of kernel C's GM branch (model/gmredi.py:GMTensor):
// Kux and Kvy [nr, nyp, nxp], or null when they are the constant isopycK
// (nonUnityDiagonal off, GmFlux::KuxVal/KvyVal); Kuz and Kvz null without
// GM_ExtraDiag
template <typename T>
struct GmArgs {
  const T *Kux, *Kvy, *Kwx, *Kwy, *Kuz, *Kvz, *maskW, *maskS;
};
constexpr int kGmNumPointers = 8;

// GM's fluxes at a face, in the JAX code's order: gmredi.py:xy_flux
// (:288-316) and r_flux (:319-344). Read only at interior cells and their
// east and north neighbours, so no shift leaves the array.
template <typename T>
struct GmFlux {
  const GadArgs<T>& a;
  const GmArgs<T>& g;
  T KuxVal, KvyVal;
  int nr, nyp, nxp;

  __device__ size_t i3(int k, int j, int i) const {
    return (static_cast<size_t>(k) * nyp + j) * nxp + i;
  }
  // maskC(k) maskC(k-1) (T(k-1) - T(k)), the levels clamped to the column
  __device__ T up(int k, int j, int i) const {
    const int km = k > 0 ? k - 1 : 0;
    return a.maskC[i3(k, j, i)] * a.maskC[i3(km, j, i)] *
           (a.tracer[i3(km, j, i)] - a.tracer[i3(k, j, i)]);
  }
  // maskC(k) maskC(k+1) maskp1 (T(k) - T(k+1))
  __device__ T dn(int k, int j, int i) const {
    const int kp = k + 1 < nr ? k + 1 : nr - 1;
    const T maskp1 = k == nr - 1 ? T(0) : T(1);
    return a.maskC[i3(k, j, i)] * a.maskC[i3(kp, j, i)] * maskp1 *
           (a.tracer[i3(k, j, i)] - a.tracer[i3(kp, j, i)]);
  }
  // dT/dz at the face between (j, i) and (jw, iw), the west or south
  // neighbour
  __device__ T dTdz(int k, int j, int i, int jw, int iw) const {
    return T(0.5) *
           (T(0.5) * a.recip_drC[k] * (up(k, jw, iw) + up(k, j, i)) +
            T(0.5) * a.recip_drC[k + 1] * (dn(k, jw, iw) + dn(k, j, i)));
  }
  // the zonal flux at the west face of (k, j, i)
  __device__ T x(int k, int j, int i) const {
    const size_t p = i3(k, j, i);
    const T K = g.Kux ? g.Kux[p] : KuxVal;
    const T f = -(a.xA[p] * K * a.recip_dxC[static_cast<size_t>(j) * nxp + i] *
                  (a.tracer[p] - a.tracer[p - 1]));
    return g.Kuz ? f - a.xA[p] * g.Kuz[p] * dTdz(k, j, i, j, i - 1) : f;
  }
  // the meridional flux at the south face
  __device__ T y(int k, int j, int i) const {
    const size_t p = i3(k, j, i);
    const T K = g.Kvy ? g.Kvy[p] : KvyVal;
    const T f = -(a.yA[p] * K * a.recip_dyC[static_cast<size_t>(j) * nxp + i] *
                  (a.tracer[p] - a.tracer[p - nxp]));
    return g.Kvz ? f - a.yA[p] * g.Kvz[p] * dTdz(k, j, i, j - 1, i) : f;
  }
  // 0.5 * (dT/dx at the east face + at the west face) at level k
  __device__ T dTdx_at(int k, int j, int i) const {
    const size_t p = i3(k, j, i), q = static_cast<size_t>(j) * nxp + i;
    const T* t = a.tracer;
    return T(0.5) * (g.maskW[p + 1] * a.recip_dxC[q + 1] * (t[p + 1] - t[p]) +
                     g.maskW[p] * a.recip_dxC[q] * (t[p] - t[p - 1]));
  }
  __device__ T dTdy_at(int k, int j, int i) const {
    const size_t p = i3(k, j, i), q = static_cast<size_t>(j) * nxp + i;
    const T* t = a.tracer;
    return T(0.5) *
           (g.maskS[p + nxp] * a.recip_dyC[q + nxp] * (t[p + nxp] - t[p]) +
            g.maskS[p] * a.recip_dyC[q] * (t[p] - t[p - nxp]));
  }
  // the vertical flux at interface k, 1 <= k < nr
  __device__ T r(int k, int j, int i) const {
    const size_t p = i3(k, j, i), q = static_cast<size_t>(j) * nxp + i;
    const T dTdx = T(0.5) * (dTdx_at(k, j, i) + dTdx_at(k - 1, j, i));
    const T dTdy = T(0.5) * (dTdy_at(k, j, i) + dTdy_at(k - 1, j, i));
    return -(a.rA[q] * a.maskInC[q] * (g.Kwx[p] * dTdx + g.Kwy[p] * dTdy) *
             a.maskUp[p]);
  }
};

template <typename T, bool GM = false>
struct GadCell {
  const GadArgs<T>& a;
  int nr, nyp, nxp;
  T diffKh, rkSign;
  // implicitDiffusion: the implicit solve (impldiff.cu) takes the place of
  // the explicit vertical diffusive flux, which is left out
  bool implicitDiffusion;
  // calcAdvection false: the advective fluxes are left out (the
  // multi-dimensional advection, gad_multidim.cu, has advected the tracer)
  bool calcAdvection;
  // an extra vertical flux added at every interface (the KPP nonlocal
  // flux, gad.py:1099-1101), or null
  const T* df;
  // with GM, its fluxes, added after the diffusive ones (gad.py:1075-1098)
  const GmFlux<T>* gm;

  __device__ size_t i3(int k, int j, int i) const {
    return (static_cast<size_t>(k) * nyp + j) * nxp + i;
  }
  __device__ size_t i2(int j, int i) const {
    return static_cast<size_t>(j) * nxp + i;
  }
  // zonal flux at the west face of (k, j, i)
  __device__ T fZon(int k, int j, int i) const {
    const size_t p = i3(k, j, i);
    const T t = a.tracer[p], tm1 = a.tracer[p - 1];
    const T adv = calcAdvection ? a.uTrans[p] * T(0.5) * (t + tm1) : T(0);
    const T f = adv - diffKh * a.xA[p] * a.recip_dxC[i2(j, i)] * (t - tm1) *
                          a.cosFacU[i2(j, i)];
    if constexpr (GM) return f + gm->x(k, j, i);
    return f;
  }
  // meridional flux at the south face
  __device__ T fMer(int k, int j, int i) const {
    const size_t p = i3(k, j, i);
    const T t = a.tracer[p], tm1 = a.tracer[p - nxp];
    const T adv = calcAdvection ? a.vTrans[p] * T(0.5) * (t + tm1) : T(0);
    const T f = adv - diffKh * a.yA[p] * a.recip_dyC[i2(j, i)] * (t - tm1);
    if constexpr (GM) return f + gm->y(k, j, i);
    return f;
  }
  // vertical flux at the upper face (interface k); zero below the bottom,
  // and at the surface but for df
  __device__ T fVer(int k, int j, int i) const {
    if (k >= nr) return T(0);
    const size_t p = i3(k, j, i);
    if (k == 0) return df ? df[p] : T(0);
    const size_t pm = p - static_cast<size_t>(nyp) * nxp;
    const T t = a.tracer[p], tkm1 = a.tracer[pm];
    T f = calcAdvection ? a.maskC[pm] * a.rTrans[p] * T(0.5) * (t + tkm1) *
                              a.maskInC[i2(j, i)]
                        : T(0);
    if (!implicitDiffusion)
      f = f + -a.kappaR[p] * a.maskUp[p] * a.rA[i2(j, i)] * a.recip_drC[k] *
                  (t - tkm1) * rkSign;
    if constexpr (GM) f = f + gm->r(k, j, i);
    return df ? f + df[p] : f;
  }
};

}  // namespace mitgcm
