// Kernel W: the vertical-momentum tendency of the non-hydrostatic path,
// gW (advection of w and the 3-D Coriolis term) and gwDiss (its harmonic
// and vertical viscous dissipation).
//
// Replaces: mitgcm_tpu/model/calc_gw.py:calc_gw (:29-166), the
// z-coordinate, Boussinesq, shallow-atmosphere case, in which the JAX
// code's rhoFac*, deepFac* and rVel2wUnit factors are exactly 1 and its
// products with them are left out (exact), as are the biharmonic terms
// (viscA4W = 0, refused otherwise: they add exact zeros). XLA fused the
// chain of shifted products into a few sweeps on the TPU.
//
// Bound: bytes. Per cell it reads six 3-D fields (u, v, w, maskC, hFacW,
// hFacS) and two kappa levels and writes two, ~40 B/cell in float32, for
// about 150 flops: far below the card's ~20 flops/byte.
// Design: one thread per padded cell (k, j, i), i fastest, as kernel B.
// The face fluxes at i+1 and j+1, the vertical flux of the level above and
// the face areas are recomputed from the inputs rather than stored; those
// loads hit L1/L2, so DRAM traffic stays near one read of each input and
// one write of each output. Every padded cell is computed, the halo cells
// with the zero fill of the JAX code's shifts (a neighbour outside the
// array reads 0, a flux on a face outside it is 0), so the outputs are
// the twin's on whole arrays. Both outputs are 0 at k = 0.
//
// Each expression keeps the JAX code's operation order, so with
// --fmad=false the outputs are bit-equal to the plain PyTorch twin
// (model/calc_gw.py:_calc_gw_plain).

#include <cstring>

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct GwArgs {
  // [nr, nyp, nxp]
  const T *u, *v, *w, *maskC, *hFacW, *hFacS;
  // [nr+1, nyp, nxp]
  const T *kappaRU, *kappaRV;
  // [nyp, nxp]
  const T *dxG, *dyG, *recip_dxC, *recip_dyC, *rA, *recip_rA, *Ro_surf,
      *R_low, *rSurfW, *rLowW, *rSurfS, *rLowS, *fCoriCos, *angleCosC,
      *angleSinC;
  // [nr]
  const T *rC, *drF, *recip_drF;
  // outputs [nr, nyp, nxp]
  T *gW, *gwDiss;
};
constexpr int kGwNumPointers = 28;

template <typename T>
__device__ __forceinline__ T gmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T gmax(T a, T b) { return a > b ? a : b; }

template <typename T>
struct GwCell {
  const GwArgs<T>& a;
  int nr, nyp, nxp;
  T viscAhW, rkSign;

  __device__ bool in(int j, int i) const {
    return j >= 0 && j < nyp && i >= 0 && i < nxp;
  }
  __device__ size_t i3(int k, int j, int i) const {
    return (static_cast<size_t>(k) * nyp + j) * nxp + i;
  }
  __device__ size_t i2(int j, int i) const {
    return static_cast<size_t>(j) * nxp + i;
  }
  // a 3-D field (or a kappa level) at (k, j, i), 0 outside the array
  __device__ T at(const T* f, int k, int j, int i) const {
    return in(j, i) ? f[i3(k, j, i)] : T(0);
  }
  __device__ int km1(int k) const { return k > 0 ? k - 1 : 0; }
  __device__ int kp1(int k) const { return k < nr - 1 ? k + 1 : nr - 1; }
  __device__ T mskM1(int k) const { return k == 0 ? T(0) : T(1); }
  __device__ T mskP1(int k) const { return k == nr - 1 ? T(0) : T(1); }

  // interface-centred open thickness at U and V points (calc_gw.F)
  __device__ T rThickW(int k, int j, int i) const {
    const T d = gmin(a.rSurfW[i2(j, i)], a.rC[km1(k)]) -
                gmax(a.rLowW[i2(j, i)], a.rC[k]);
    return gmax(d, T(0));
  }
  __device__ T rThickS(int k, int j, int i) const {
    const T d = gmin(a.rSurfS[i2(j, i)], a.rC[km1(k)]) -
                gmax(a.rLowS[i2(j, i)], a.rC[k]);
    return gmax(d, T(0));
  }
  __device__ T recipThickC(int k, int j, int i) const {
    if (k < 1 || a.maskC[i3(k - 1, j, i)] == T(0) ||
        a.maskC[i3(k, j, i)] == T(0))
      return T(0);
    const T thick = gmin(a.Ro_surf[i2(j, i)], a.rC[k - 1]) -
                    gmax(a.R_low[i2(j, i)], a.rC[k]);
    return T(1) / (thick == T(0) ? T(1) : thick);
  }

  // ---- dissipation: harmonic fluxes on the W and S faces of (j, i) ----
  __device__ T dissEW(int k, int j, int i) const {
    if (!in(j, i)) return T(0);
    const T vw = i - 1 >= 0 ? viscAhW : T(0);
    const T xA = a.dyG[i2(j, i)] * rThickW(k, j, i);
    return -(viscAhW + vw) * T(0.5) *
           (a.w[i3(k, j, i)] - at(a.w, k, j, i - 1)) * a.recip_dxC[i2(j, i)] *
           xA;
  }
  __device__ T dissNS(int k, int j, int i) const {
    if (!in(j, i)) return T(0);
    const T vs = j - 1 >= 0 ? viscAhW : T(0);
    const T yA = a.dxG[i2(j, i)] * rThickS(k, j, i);
    return -(viscAhW + vs) * T(0.5) *
           (a.w[i3(k, j, i)] - at(a.w, k, j - 1, i)) * a.recip_dyC[i2(j, i)] *
           yA;
  }
  // vertical viscous flux between k and k+1
  __device__ T dissDn(int k, int j, int i) const {
    const T viscLoc =
        (a.kappaRU[i3(k, j, i)] + at(a.kappaRU, k, j, i + 1) +
         a.kappaRU[i3(k + 1, j, i)] + at(a.kappaRU, k + 1, j, i + 1) +
         a.kappaRV[i3(k, j, i)] + at(a.kappaRV, k, j + 1, i) +
         a.kappaRV[i3(k + 1, j, i)] + at(a.kappaRV, k + 1, j + 1, i)) *
        T(0.125);
    const T w = a.w[i3(k, j, i)];
    return -viscLoc * (a.w[i3(kp1(k), j, i)] * mskP1(k) - w) * rkSign *
           a.recip_drF[k] * a.rA[i2(j, i)];
  }
  // the upper flux at k = 1 (0-based; calc_gw.F:364-377)
  __device__ T dissTop(int k, int j, int i) const {
    const T visc2 = (a.kappaRU[i3(k, j, i)] + at(a.kappaRU, k, j, i + 1) +
                     a.kappaRV[i3(k, j, i)] + at(a.kappaRV, k, j + 1, i)) *
                    T(0.25);
    return -visc2 * (a.w[i3(k, j, i)] - a.w[i3(km1(k), j, i)]) * rkSign *
           a.recip_drF[km1(k)] * a.rA[i2(j, i)];
  }

  // ---- advection ----
  __device__ T uTrans(int k, int j, int i) const {
    const int m = km1(k);
    return (a.drF[m] * a.hFacW[i3(m, j, i)] * a.u[i3(m, j, i)] * mskM1(k) +
            a.drF[k] * a.hFacW[i3(k, j, i)] * a.u[i3(k, j, i)]) *
           T(0.5) * a.dyG[i2(j, i)];
  }
  __device__ T vTrans(int k, int j, int i) const {
    const int m = km1(k);
    return (a.drF[m] * a.hFacS[i3(m, j, i)] * a.v[i3(m, j, i)] * mskM1(k) +
            a.drF[k] * a.hFacS[i3(k, j, i)] * a.v[i3(k, j, i)]) *
           T(0.5) * a.dxG[i2(j, i)];
  }
  __device__ T advEW(int k, int j, int i) const {
    if (!in(j, i)) return T(0);
    return uTrans(k, j, i) * (a.w[i3(k, j, i)] + at(a.w, k, j, i - 1)) *
           T(0.5);
  }
  __device__ T advNS(int k, int j, int i) const {
    if (!in(j, i)) return T(0);
    return vTrans(k, j, i) * (a.w[i3(k, j, i)] + at(a.w, k, j - 1, i)) *
           T(0.5);
  }
  __device__ T advDn(int k, int j, int i) const {
    const T s = a.w[i3(k, j, i)] + a.w[i3(kp1(k), j, i)] * mskP1(k);
    const T rTrans = T(0.5) * s * a.rA[i2(j, i)];
    return rTrans * (T(0.5) * s);
  }
};

template <typename T, bool Coriolis3d>
__global__ void calc_gw_kernel(const GwArgs<T> a, int nr, int nyp, int nxp,
                               T viscAhW, T rkSign, T gravitySign) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const GwCell<T> c{a, nr, nyp, nxp, viscAhW, rkSign};
  const size_t p = c.i3(k, j, i);
  if (k == 0) {
    a.gW[p] = T(0);
    a.gwDiss[p] = T(0);
    return;
  }
  const size_t q = c.i2(j, i);
  const T rThick = c.recipThickC(k, j, i);

  // gwDiss (calc_gw.F:300-390)
  const T dUp = k == 1 ? c.dissTop(k, j, i) : c.dissDn(k - 1, j, i);
  a.gwDiss[p] = -((c.dissEW(k, j, i + 1) - c.dissEW(k, j, i)) +
                  (c.dissNS(k, j + 1, i) - c.dissNS(k, j, i)) +
                  (c.dissDn(k, j, i) - dUp) * rkSign) *
                a.recip_rA[q] * rThick;

  // gW (calc_gw.F:400-470)
  const T aUp = c.advDn(k - 1, j, i) * c.mskM1(k);
  T gW = -((c.advEW(k, j, i + 1) - c.advEW(k, j, i)) +
           (c.advNS(k, j + 1, i) - c.advNS(k, j, i)) +
           (c.advDn(k, j, i) - aUp) * rkSign) *
         a.recip_rA[q] * rThick;

  // 3-D Coriolis (mom_w_coriolis_nh.F)
  if (Coriolis3d) {
    const int m = k - 1;
    const T ubar = T(0.25) * ((a.u[c.i3(m, j, i)] + c.at(a.u, m, j, i + 1)) *
                                  c.mskM1(k) +
                              (a.u[p] + c.at(a.u, k, j, i + 1)));
    const T vbar = T(0.25) * ((a.v[c.i3(m, j, i)] + c.at(a.v, m, j + 1, i)) *
                                  c.mskM1(k) +
                              (a.v[p] + c.at(a.v, k, j + 1, i)));
    const T wCori = -gravitySign * a.fCoriCos[q] *
                    (a.angleCosC[q] * ubar - a.angleSinC[q] * vbar);
    gW = gW + wCori;
  }
  a.gW[p] = gW;
}

template <typename T>
int launch_calc_gw(const void* const* table, int n, int nr, int nyp,
                   int nxp, int coriolis_3d, double viscAhW, double rkSign,
                   double gravitySign, void* stream) {
  static_assert(sizeof(GwArgs<T>) == kGwNumPointers * sizeof(void*),
                "GwArgs must be a plain table of pointers");
  if (n != kGwNumPointers) return (int)cudaErrorInvalidValue;
  GwArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  const dim3 g((nxp + BX - 1) / BX, (nyp + BY - 1) / BY, nr);
  const cudaStream_t s = (cudaStream_t)stream;
  if (coriolis_3d)
    calc_gw_kernel<T, true><<<g, dim3(BX, BY), 0, s>>>(
        a, nr, nyp, nxp, T(viscAhW), T(rkSign), T(gravitySign));
  else
    calc_gw_kernel<T, false><<<g, dim3(BX, BY), 0, s>>>(
        a, nr, nyp, nxp, T(viscAhW), T(rkSign), T(gravitySign));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define MITGCM_CALC_GW_ENTRY_POINT(T, SUF)                                    \
  extern "C" int mitgcm_calc_gw_##SUF(const void* const* table, int n,        \
                                      int nr, int nyp, int nxp,               \
                                      int coriolis_3d, double viscAhW,        \
                                      double rkSign, double gravitySign,      \
                                      void* stream) {                         \
    return mitgcm::launch_calc_gw<T>(table, n, nr, nyp, nxp, coriolis_3d,     \
                                     viscAhW, rkSign, gravitySign, stream);   \
  }

MITGCM_CALC_GW_ENTRY_POINT(float, f32)
MITGCM_CALC_GW_ENTRY_POINT(double, f64)
