// Kernel V: vector-invariant momentum tendencies gU, gV, guDiss, gvDiss.
//
// Replaces: mitgcm_tpu/model/mom_vecinv.py:mom_vecinv (:210-451) on
// Cartesian grids with constant harmonic viscosity: relative vorticity and
// horizontal divergence (calc_relvort3 :24, calc_hdiv :84), the planetary
// Coriolis term for selectCoriScheme 0-1 (:152), vorticity advection for
// selectVortScheme 0-2 (:94-149), the divergence/vorticity-form harmonic
// dissipation (:293-308), the explicit vertical viscous flux unless
// implicitViscosity (:323-340), no-slip side drag (:342-371), no-slip and
// linear bottom drag (:373-400), vertical shear and the KE gradient
// (:415-445). XLA fused this chain of shifted products into a few sweeps on
// the TPU.
//
// Bound: bytes. Per cell it reads 13 3-D fields (u, v, w, the hFacs, masks
// and their reciprocals, two kappa levels) and writes 4, ~68 B/cell in
// float32, for a few hundred flops: well below the card's ~20 flops/byte.
// Design: one thread per (k, j, i), i fastest, writing all four outputs in
// one pass, like kernel B. Every neighbour quantity (vorticity and hFacZ
// at j+1 and i+1, hDiv and KE at i-1 and j-1, the Coriolis averages, w at
// k+1) is recomputed from the inputs instead of being stored: the reach is
// +-1 in i, j and k, the loads hit L1/L2, and DRAM traffic stays at one
// read of each input and one write of each output. Halo cells of the
// outputs are written as 0; step.py fills uStar and vStar.
//
// Each expression keeps the JAX code's operation order, so with
// --fmad=false the outputs are bit-equal to the plain PyTorch twin
// (mom_vecinv.py:_mom_vecinv_plain).

#include <cstring>

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct VecinvArgs {
  // [nr, nyp, nxp]
  const T *u, *v, *w, *hFacW, *hFacS, *maskC, *maskW, *maskS, *recip_hFacC,
      *recip_hFacW, *recip_hFacS;
  // [nr+1, nyp, nxp]
  const T *kappaRU, *kappaRV;
  // [nyp, nxp]
  const T *dxC, *dyC, *dxG, *dyG, *dxV, *dyU, *rA, *rAw, *rAs, *recip_dxC,
      *recip_dyC, *recip_dxG, *recip_dyG, *recip_rA, *recip_rAw, *recip_rAs,
      *recip_rAz, *recip_dxV, *recip_dyU, *cosFacU, *cosFacV, *fCoriG;
  // [nr], [nr], [nr+1]
  const T *drF, *recip_drF, *recip_drC;
  // outputs [nr, nyp, nxp]
  T *gU, *gV, *guDiss, *gvDiss;
};
constexpr int kVecinvNumPointers = 42;

template <typename T>
__device__ __forceinline__ T vmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }

// wet-point average guard of the schemes 1
constexpr double kEps = 1.0e-9;

template <typename T>
struct VCell {
  const VecinvArgs<T>& a;
  int nr, nyp, nxp;
  T sideDragFactor;

  __device__ size_t i3(int k, int j, int i) const {
    return (static_cast<size_t>(k) * nyp + j) * nxp + i;
  }
  __device__ size_t i2(int j, int i) const {
    return static_cast<size_t>(j) * nxp + i;
  }
  // mom_calc_hfacz.F
  __device__ T hFacZ(int k, int j, int i) const {
    const T mW = a.maskW[i3(k, j, i)], mWs = a.maskW[i3(k, j - 1, i)];
    const T mS = a.maskS[i3(k, j, i)], mSw = a.maskS[i3(k, j, i - 1)];
    const T openJ =
        vmin(a.hFacW[i3(k, j, i)], a.hFacW[i3(k, j - 1, i)]) * mW * mWs;
    const T openI =
        vmin(a.hFacS[i3(k, j, i)], a.hFacS[i3(k, j, i - 1)]) * mS * mSw;
    return vmin(openI, openJ) * mW * mWs;
  }
  __device__ T rHz(int k, int j, int i) const {
    const T hz = hFacZ(k, j, i);
    return hz == T(0) ? T(0) : T(1) / hz;
  }
  // relative vorticity at the corner (mom_calc_relvort3.F), times
  // sideDragFactor where the corner is closed (mom_vecinv.py:221-222)
  __device__ T omega(int k, int j, int i) const {
    const T vdyC = a.v[i3(k, j, i)] * a.dyC[i2(j, i)];
    const T vdyCw = a.v[i3(k, j, i - 1)] * a.dyC[i2(j, i - 1)];
    const T udxC = a.u[i3(k, j, i)] * a.dxC[i2(j, i)];
    const T udxCs = a.u[i3(k, j - 1, i)] * a.dxC[i2(j - 1, i)];
    const T vort = a.recip_rAz[i2(j, i)] * ((vdyC - vdyCw) - (udxC - udxCs));
    return hFacZ(k, j, i) == T(0) ? sideDragFactor * vort : vort;
  }
  // hFacZ * vorticity, the Z of the harmonic dissipation
  __device__ T zeta(int k, int j, int i) const {
    return hFacZ(k, j, i) * omega(k, j, i);
  }
  __device__ T uTr(int k, int j, int i) const {   // u dyG hFacW
    return a.u[i3(k, j, i)] * a.dyG[i2(j, i)] * a.hFacW[i3(k, j, i)];
  }
  __device__ T vTr(int k, int j, int i) const {   // v dxG hFacS
    return a.v[i3(k, j, i)] * a.dxG[i2(j, i)] * a.hFacS[i3(k, j, i)];
  }
  __device__ T udy(int k, int j, int i) const {
    return a.u[i3(k, j, i)] * a.dyG[i2(j, i)];
  }
  __device__ T vdx(int k, int j, int i) const {
    return a.v[i3(k, j, i)] * a.dxG[i2(j, i)];
  }
  // horizontal divergence, hDivScheme 2 (mom_calc_hdiv.F)
  __device__ T hDiv(int k, int j, int i) const {
    return ((uTr(k, j, i + 1) - uTr(k, j, i)) +
            (vTr(k, j + 1, i) - vTr(k, j, i))) *
           a.recip_rA[i2(j, i)] * a.recip_hFacC[i3(k, j, i)];
  }
  // kinetic energy, selectKEscheme 0 (mom_calc_ke.F)
  __device__ T KE(int k, int j, int i) const {
    const T u0 = a.u[i3(k, j, i)], u1 = a.u[i3(k, j, i + 1)];
    const T v0 = a.v[i3(k, j, i)], v1 = a.v[i3(k, j + 1, i)];
    return T(0.25) * ((u0 * u0 + u1 * u1) + (v0 * v0 + v1 * v1));
  }
  __device__ T wrA(int k, int j, int i) const {
    return a.w[i3(k, j, i)] * a.rA[i2(j, i)];
  }
  // w rA masked by the cell above (0 at the surface)
  __device__ T wrAup(int k, int j, int i) const {
    const T mC = k == 0 ? T(0) : a.maskC[i3(k - 1, j, i)];
    return wrA(k, j, i) * mC;
  }
  __device__ T wrAkp1(int k, int j, int i) const {
    return k + 1 < nr ? wrA(k + 1, j, i) : T(0);
  }
  // explicit vertical viscous flux at interface k (zero at the surface
  // and below the bottom)
  __device__ T rViscU(int k, int j, int i, T rkSign) const {
    if (k <= 0 || k >= nr) return T(0);
    return -a.kappaRU[i3(k, j, i)] * a.rAw[i2(j, i)] *
           (a.u[i3(k, j, i)] - a.u[i3(k - 1, j, i)]) * rkSign *
           a.recip_drC[k] * a.maskW[i3(k, j, i)] * a.maskW[i3(k - 1, j, i)];
  }
  __device__ T rViscV(int k, int j, int i, T rkSign) const {
    if (k <= 0 || k >= nr) return T(0);
    return -a.kappaRV[i3(k, j, i)] * a.rAs[i2(j, i)] *
           (a.v[i3(k, j, i)] - a.v[i3(k - 1, j, i)]) * rkSign *
           a.recip_drC[k] * a.maskS[i3(k, j, i)] * a.maskS[i3(k - 1, j, i)];
  }

  // vorticity advection at U points (mom_vi_u_coriolis.F)
  __device__ T vortU(int k, int j, int i, int scheme) const {
    const T rdxC = a.recip_dxC[i2(j, i)], mW = a.maskW[i3(k, j, i)];
    if (scheme == 1) {
      const T hz = hFacZ(k, j, i), hzN = hFacZ(k, j + 1, i);
      const T num = T(0.5) * ((vdx(k, j, i) * hz + vdx(k, j, i - 1) * hz) +
                              (vdx(k, j + 1, i) * hzN +
                               vdx(k, j + 1, i - 1) * hzN));
      const T den = vmax(hz + hzN, T(kEps));
      const T vort3u = T(0.5) * (omega(k, j, i) + omega(k, j + 1, i));
      return vort3u * (num / den) * rdxC * mW;
    }
    if (scheme == 0) {
      const T vBarXY =
          T(0.25) * ((vTr(k, j, i) + vTr(k, j, i - 1)) +
                     (vTr(k, j + 1, i) + vTr(k, j + 1, i - 1)));
      const T vort3u = T(0.5) * (omega(k, j, i) * rHz(k, j, i) +
                                 omega(k, j + 1, i) * rHz(k, j + 1, i));
      return vort3u * vBarXY * rdxC * mW;
    }
    const T vBarXm = T(0.5) * (vTr(k, j, i) + vTr(k, j, i - 1));
    const T vBarXp = T(0.5) * (vTr(k, j + 1, i) + vTr(k, j + 1, i - 1));
    const T vort3u =
        T(0.5) * (vBarXm * rHz(k, j, i) * omega(k, j, i) +
                  vBarXp * (rHz(k, j + 1, i) * omega(k, j + 1, i)));
    return vort3u * rdxC * mW;
  }
  // vorticity advection at V points (mom_vi_v_coriolis.F)
  __device__ T vortV(int k, int j, int i, int scheme) const {
    const T rdyC = a.recip_dyC[i2(j, i)], mS = a.maskS[i3(k, j, i)];
    if (scheme == 1) {
      const T hz = hFacZ(k, j, i), hzE = hFacZ(k, j, i + 1);
      const T num = T(0.5) * ((udy(k, j, i) * hz + udy(k, j - 1, i) * hz) +
                              (udy(k, j, i + 1) * hzE +
                               udy(k, j - 1, i + 1) * hzE));
      const T den = vmax(hz + hzE, T(kEps));
      const T vort3v = T(0.5) * (omega(k, j, i) + omega(k, j, i + 1));
      return -vort3v * (num / den) * rdyC * mS;
    }
    if (scheme == 0) {
      const T uBarXY =
          T(0.25) * ((uTr(k, j, i) + uTr(k, j - 1, i)) +
                     (uTr(k, j, i + 1) + uTr(k, j - 1, i + 1)));
      const T vort3v = T(0.5) * (omega(k, j, i) * rHz(k, j, i) +
                                 omega(k, j, i + 1) * rHz(k, j, i + 1));
      return -vort3v * uBarXY * rdyC * mS;
    }
    const T uBarYm = T(0.5) * (uTr(k, j, i) + uTr(k, j - 1, i));
    const T uBarYp = T(0.5) * (uTr(k, j, i + 1) + uTr(k, j - 1, i + 1));
    const T vort3v =
        T(0.5) * (uBarYm * rHz(k, j, i) * omega(k, j, i) +
                  uBarYp * (rHz(k, j, i + 1) * omega(k, j, i + 1)));
    return -vort3v * rdyC * mS;
  }
};

template <typename T>
__global__ void mom_vecinv_kernel(const VecinvArgs<T> a, int nr, int ny,
                                  int nx, int oly, int olx, int vortScheme,
                                  int coriScheme, int implicitViscosity,
                                  int noSlipBottom, T viscAh,
                                  T sideDragFactor, T bottomDragLinear,
                                  T rkSign) {
  const int nyp = ny + 2 * oly, nxp = nx + 2 * olx;
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const VCell<T> c{a, nr, nyp, nxp, sideDragFactor};
  const size_t p = c.i3(k, j, i);
  if (i < olx || i >= olx + nx || j < oly || j >= oly + ny) {
    a.gU[p] = T(0);
    a.gV[p] = T(0);
    a.guDiss[p] = T(0);
    a.gvDiss[p] = T(0);
    return;
  }
  const size_t q = c.i2(j, i);
  const size_t below = p + static_cast<size_t>(nyp) * nxp;
  const T u = a.u[p], v = a.v[p];
  const T mW = a.maskW[p], mS = a.maskS[p];
  const T rhW = a.recip_hFacW[p], rhS = a.recip_hFacS[p];
  const T rdrF = a.recip_drF[k], drF = a.drF[k];
  const T AhD = viscAh, AhZ = viscAh;

  // harmonic dissipation in divergence/vorticity form (mom_vi_hdissip.F)
  const T hDiv = c.hDiv(k, j, i), Z = c.zeta(k, j, i);
  const T uD2 = AhD * a.cosFacU[q] * (hDiv - c.hDiv(k, j, i - 1)) *
                    a.recip_dxC[q] -
                AhZ * rhW * (c.zeta(k, j + 1, i) - Z) * a.recip_dyG[q] *
                    a.cosFacU[q];
  const T vD2 = AhZ * rhS * a.cosFacV[q] * (c.zeta(k, j, i + 1) - Z) *
                    a.recip_dxG[q] +
                AhD * (hDiv - c.hDiv(k, j - 1, i)) * a.recip_dyC[q] *
                    a.cosFacV[q];
  T guDiss = uD2 * mW;
  T gvDiss = vD2 * mS;

  // explicit vertical viscous flux (mom_u_rviscflux.F)
  if (!implicitViscosity) {
    guDiss = guDiss - (rhW * rdrF * a.recip_rAw[q] *
                       (c.rViscU(k + 1, j, i, rkSign) -
                        c.rViscU(k, j, i, rkSign)) *
                       rkSign);
    gvDiss = gvDiss - (rhS * rdrF * a.recip_rAs[q] *
                       (c.rViscV(k + 1, j, i, rkSign) -
                        c.rViscV(k, j, i, rkSign)) *
                       rkSign);
  }

  // no-slip side drag (mom_u_sidedrag.F)
  const T hZ = c.hFacZ(k, j, i);
  const T Ahu = AhZ * u;
  guDiss = guDiss -
           (rhW * rdrF * a.recip_rAw[q] *
            ((a.hFacW[p] - hZ) * a.dxV[q] * a.recip_dyU[q] * Ahu +
             (a.hFacW[p] - c.hFacZ(k, j + 1, i)) * a.dxV[q + nxp] *
                 a.recip_dyU[q + nxp] * Ahu) *
            drF * sideDragFactor) *
               mW;
  const T Ahv = AhZ * v * a.cosFacV[q];
  gvDiss = gvDiss -
           (rhS * rdrF * a.recip_rAs[q] *
            ((a.hFacS[p] - hZ) * a.dyU[q] * a.recip_dxV[q] * Ahv +
             (a.hFacS[p] - c.hFacZ(k, j, i + 1)) * a.dyU[q + 1] *
                 a.recip_dxV[q + 1] * Ahv) *
            drF * sideDragFactor) *
               mS;

  // no-slip and linear bottom drag (mom_u_botdrag_coeff.F): only where
  // the cell below is dry, or at k = Nr
  if (noSlipBottom || bottomDragLinear != T(0)) {
    const bool deepest = (k == nr - 1);
    T cDragU = bottomDragLinear, cDragV = bottomDragLinear;
    if (noSlipBottom) {
      const T recDr = deepest ? a.recip_drF[nr - 1] : a.recip_drC[k + 1];
      cDragU = cDragU + a.kappaRU[c.i3(k + 1, j, i)] * recDr * T(2);
      cDragV = cDragV + a.kappaRV[c.i3(k + 1, j, i)] * recDr * T(2);
    }
    const T bottomW = mW * (deepest ? T(1) : T(1) - a.maskW[below]);
    const T bottomS = mS * (deepest ? T(1) : T(1) - a.maskS[below]);
    guDiss = guDiss - cDragU * bottomW * u * rhW * rdrF;
    gvDiss = gvDiss - cDragV * bottomS * v * rhS * rdrF;
  }

  // planetary Coriolis (mom_vi_coriolis.F)
  const T fG = a.fCoriG[q];
  T gU, gV;
  if (coriScheme == 0) {
    const T vBarXY =
        T(0.25) * ((c.vdx(k, j, i) + c.vdx(k, j, i - 1)) +
                   (c.vdx(k, j + 1, i) + c.vdx(k, j + 1, i - 1)));
    gU = T(0.5) * (fG + a.fCoriG[q + nxp]) * vBarXY * a.recip_dxC[q] * mW;
    const T uBarXY =
        T(0.25) * ((c.udy(k, j, i) + c.udy(k, j - 1, i)) +
                   (c.udy(k, j, i + 1) + c.udy(k, j - 1, i + 1)));
    gV = T(-0.5) * (fG + a.fCoriG[q + 1]) * uBarXY * a.recip_dyC[q] * mS;
  } else {
    const T numU = (c.vTr(k, j, i) + c.vTr(k, j, i - 1)) +
                   (c.vTr(k, j + 1, i) + c.vTr(k, j + 1, i - 1));
    const size_t n = p + nxp;
    const T denU = vmax((a.hFacS[p] + a.hFacS[p - 1]) +
                            (a.hFacS[n] + a.hFacS[n - 1]),
                        T(kEps));
    gU = T(0.5) * (fG + a.fCoriG[q + nxp]) * numU / denU * a.recip_dxC[q] *
         mW;
    const T numV = (c.uTr(k, j, i) + c.uTr(k, j - 1, i)) +
                   (c.uTr(k, j, i + 1) + c.uTr(k, j - 1, i + 1));
    const size_t s = p - nxp;
    const T denV = vmax((a.hFacW[p] + a.hFacW[s]) +
                            (a.hFacW[p + 1] + a.hFacW[s + 1]),
                        T(kEps));
    gV = T(-0.5) * (fG + a.fCoriG[q + 1]) * numV / denV * a.recip_dyC[q] *
         mS;
  }

  // vorticity advection
  gU = gU + c.vortU(k, j, i, vortScheme);
  gV = gV + c.vortV(k, j, i, vortScheme);

  // vertical shear -w du/dz (mom_vi_u_vertshear.F)
  const T mkm1 = k == 0 ? T(0) : T(1);
  const T mkp1 = k == nr - 1 ? T(0) : T(1);
  const T ukm1 = k == 0 ? T(0) : a.u[p - static_cast<size_t>(nyp) * nxp];
  const T vkm1 = k == 0 ? T(0) : a.v[p - static_cast<size_t>(nyp) * nxp];
  const T ukp1 = k + 1 < nr ? a.u[below] : T(0);
  const T vkp1 = k + 1 < nr ? a.v[below] : T(0);
  {
    const T wBarXm = T(0.5) * (c.wrAup(k, j, i) + c.wrAup(k, j, i - 1)) *
                     mkm1 * a.recip_rAw[q];
    const T wBarXp = T(0.5) * (c.wrAkp1(k, j, i) + c.wrAkp1(k, j, i - 1)) *
                     mkp1 * a.recip_rAw[q];
    const T uZm = (u - mkm1 * ukm1) * rkSign;
    const T uZp = (mkp1 * ukp1 - u) * rkSign;
    gU = gU - T(0.5) * (wBarXp * uZp + wBarXm * uZm) * rhW * rdrF;
    const T wBarYm = T(0.5) * (c.wrAup(k, j, i) + c.wrAup(k, j - 1, i)) *
                     mkm1 * a.recip_rAs[q];
    const T wBarYp = T(0.5) * (c.wrAkp1(k, j, i) + c.wrAkp1(k, j - 1, i)) *
                     mkp1 * a.recip_rAs[q];
    const T vZm = (v - mkm1 * vkm1) * rkSign;
    const T vZp = (mkp1 * vkp1 - v) * rkSign;
    gV = gV - T(0.5) * (wBarYp * vZp + wBarYm * vZm) * rhS * rdrF;
  }

  // -grad KE (mom_vi_u_grad_ke.F)
  const T ke = c.KE(k, j, i);
  gU = gU - a.recip_dxC[q] * (ke - c.KE(k, j, i - 1)) * mW;
  gV = gV - a.recip_dyC[q] * (ke - c.KE(k, j - 1, i)) * mS;

  a.gU[p] = gU * mW;
  a.gV[p] = gV * mS;
  a.guDiss[p] = guDiss * mW;
  a.gvDiss[p] = gvDiss * mS;
}

template <typename T>
int launch_vecinv(const void* const* table, int n, int nr, int ny, int nx,
                  int oly, int olx, int vortScheme, int coriScheme,
                  int implicitViscosity, int noSlipBottom, double viscAh,
                  double sideDragFactor, double bottomDragLinear,
                  double rkSign, void* stream) {
  static_assert(sizeof(VecinvArgs<T>) == kVecinvNumPointers * sizeof(void*),
                "VecinvArgs must be a plain table of pointers");
  if (n != kVecinvNumPointers || vortScheme < 0 || vortScheme > 2 ||
      coriScheme < 0 || coriScheme > 1 || oly < 1 || olx < 1)
    return (int)cudaErrorInvalidValue;
  VecinvArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  const dim3 g((nx + 2 * olx + BX - 1) / BX, (ny + 2 * oly + BY - 1) / BY,
               nr);
  mom_vecinv_kernel<T><<<g, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      a, nr, ny, nx, oly, olx, vortScheme, coriScheme, implicitViscosity,
      noSlipBottom, T(viscAh), T(sideDragFactor), T(bottomDragLinear),
      T(rkSign));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define MITGCM_VECINV_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* const* table, int n, int nr, int ny,      \
                      int nx, int oly, int olx, int vortScheme,             \
                      int coriScheme, int implicitViscosity,                \
                      int noSlipBottom, double viscAh,                      \
                      double sideDragFactor, double bottomDragLinear,       \
                      double rkSign, void* stream) {                        \
    return mitgcm::launch_vecinv<T>(table, n, nr, ny, nx, oly, olx,         \
                                    vortScheme, coriScheme,                 \
                                    implicitViscosity, noSlipBottom, viscAh, \
                                    sideDragFactor, bottomDragLinear,       \
                                    rkSign, stream);                        \
  }

MITGCM_VECINV_ENTRY(mitgcm_mom_vecinv_f32, float)
MITGCM_VECINV_ENTRY(mitgcm_mom_vecinv_f64, double)
