// Kernel C: explicit tracer tendency with centred 2nd-order advection
// (scheme 2), Laplacian horizontal and explicit vertical diffusion.
//
// Replaces: mitgcm_tpu/model/gad.py:calc_rhs (:1038-1117) with the
// scheme-2 fluxes adv_flux_x/y/r (:846-847, :881-882, :932-933 and the
// surface zero at :1021) and diff_flux_r (:1025-1031): the flux divergence
// minus tracer * divTrans. XLA fused it into a few sweeps on the TPU.
//
// Bound: bytes. Per cell it reads 10 3-D fields (the transports and areas
// of AdvFlow, the tracer, kappaR, maskC and recip_hFacC) and writes one,
// ~44 B/cell in float32, for about 60 flops.
// Design: one thread per (k, j, i), i fastest. The fluxes at the cell's
// east, north and lower faces are recomputed by the thread (their loads hit
// L1/L2) instead of being stored, so DRAM traffic is one read of each input
// and one write of gTr. Halo cells of gTr are written as 0; the tracer step
// fills every prognostic field afterwards.
//
// Each expression keeps the JAX code's operation order, so with
// --fmad=false gTr is bit-equal to the plain PyTorch twin.

#include <cstring>

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

template <typename T>
struct GadCell {
  const GadArgs<T>& a;
  int nr, nyp, nxp;
  T diffKh, rkSign;

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
    return a.uTrans[p] * T(0.5) * (t + tm1) -
           diffKh * a.xA[p] * a.recip_dxC[i2(j, i)] * (t - tm1) *
               a.cosFacU[i2(j, i)];
  }
  // meridional flux at the south face
  __device__ T fMer(int k, int j, int i) const {
    const size_t p = i3(k, j, i);
    const T t = a.tracer[p], tm1 = a.tracer[p - nxp];
    return a.vTrans[p] * T(0.5) * (t + tm1) -
           diffKh * a.yA[p] * a.recip_dyC[i2(j, i)] * (t - tm1);
  }
  // vertical flux at the upper face (interface k); zero at the surface
  // and below the bottom
  __device__ T fVer(int k, int j, int i) const {
    if (k <= 0 || k >= nr) return T(0);
    const size_t p = i3(k, j, i);
    const size_t pm = p - static_cast<size_t>(nyp) * nxp;
    const T t = a.tracer[p], tkm1 = a.tracer[pm];
    const T adv = a.maskC[pm] * a.rTrans[p] * T(0.5) * (t + tkm1) *
                  a.maskInC[i2(j, i)];
    const T dif = -a.kappaR[p] * a.maskUp[p] * a.rA[i2(j, i)] *
                  a.recip_drC[k] * (t - tkm1) * rkSign;
    return adv + dif;
  }
};

template <typename T>
__global__ void calc_rhs_c2_kernel(const GadArgs<T> a, int nr, int ny,
                                   int nx, int oly, int olx, T diffKh,
                                   T rkSign) {
  const int nyp = ny + 2 * oly, nxp = nx + 2 * olx;
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const GadCell<T> c{a, nr, nyp, nxp, diffKh, rkSign};
  const size_t p = c.i3(k, j, i);
  if (i < olx || i >= olx + nx || j < oly || j >= oly + ny) {
    a.gTr[p] = T(0);
    return;
  }
  const size_t q = c.i2(j, i);
  const T rTransKp =
      k + 1 < nr ? a.rTrans[p + static_cast<size_t>(nyp) * nxp] : T(0);
  const T divTrans = (a.uTrans[p + 1] - a.uTrans[p]) +
                     (a.vTrans[p + nxp] - a.vTrans[p]) +
                     (rTransKp - a.rTrans[p]) * rkSign;
  const T mIn = a.maskInC[q];
  a.gTr[p] = -(a.recip_hFacC[p] * a.recip_drF[k] * a.recip_rA[q] *
               (((c.fZon(k, j, i + 1) - c.fZon(k, j, i)) +
                 (c.fMer(k, j + 1, i) - c.fMer(k, j, i))) * mIn +
                (c.fVer(k + 1, j, i) - c.fVer(k, j, i)) * rkSign -
                a.tracer[p] * divTrans * mIn));
}

template <typename T>
int launch_calc_rhs(const void* const* table, int n, int nr, int ny, int nx,
                    int oly, int olx, double diffKh, double rkSign,
                    void* stream) {
  static_assert(sizeof(GadArgs<T>) == kGadNumPointers * sizeof(void*),
                "GadArgs must be a plain table of pointers");
  if (n != kGadNumPointers) return (int)cudaErrorInvalidValue;
  GadArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  const dim3 g((nx + 2 * olx + BX - 1) / BX, (ny + 2 * oly + BY - 1) / BY,
               nr);
  calc_rhs_c2_kernel<T><<<g, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      a, nr, ny, nx, oly, olx, T(diffKh), T(rkSign));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

extern "C" int mitgcm_gad_calc_rhs_c2_f32(const void* const* table, int n,
                                          int nr, int ny, int nx, int oly,
                                          int olx, double diffKh,
                                          double rkSign, void* stream) {
  return mitgcm::launch_calc_rhs<float>(table, n, nr, ny, nx, oly, olx,
                                        diffKh, rkSign, stream);
}

extern "C" int mitgcm_gad_calc_rhs_c2_f64(const void* const* table, int n,
                                          int nr, int ny, int nx, int oly,
                                          int olx, double diffKh,
                                          double rkSign, void* stream) {
  return mitgcm::launch_calc_rhs<double>(table, n, nr, ny, nx, oly, olx,
                                         diffKh, rkSign, stream);
}
