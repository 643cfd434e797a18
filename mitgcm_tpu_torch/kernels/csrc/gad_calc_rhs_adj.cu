// Kernel C': the VJP of kernel C (the scheme-2 tracer tendency).
//
// Replaces: the reverse-mode derivative that jax.grad takes of
// mitgcm_tpu/model/gad.py:calc_rhs (:1038-1117) with the scheme-2 fluxes
// and diff_flux_r, which XLA fused on the TPU. Given the cotangent of gTr
// it writes the cotangents of the tracer and of the three transports;
// rTransKp is derived from rTrans here, as kernel C derives it, so
// rTrans_bar carries both. xA, yA, maskUp, kappaR and the grid are
// constants and get no cotangent.
//
// gTr is linear in the tracer and bilinear in (transport, tracer), so no
// intermediate of the forward pass is needed: the thread recomputes the
// partial derivatives it needs from the inputs.
//
// Bound: bytes, like kernel C: about 10 3-D fields read and 4 written per
// cell, with neighbour reads hitting L1/L2.
// Design: gather, not scatter. One thread per input cell (k, j, i) sums
// the contributions of every interior output cell whose stencil read that
// cell (reach +-1 in i, j and k), in a fixed order, with no atomics: the
// result is the same bits on every run. Output halo cells of kernel C are
// constant zeros, so the cotangent is read on interior cells only. Input
// cells are written everywhere: those one cell outside the interior are
// read by the forward pass and get nonzero cotangents; the rest get 0.

#include <cstring>

#include "gad_calc_rhs.cuh"

namespace mitgcm {

template <typename T>
struct GadAdjArgs {
  // kernel C's table; its output slot gTr holds the cotangent of gTr
  GadArgs<T> f;
  // outputs [nr, nyp, nxp]
  T *tracer_bar, *uTrans_bar, *vTrans_bar, *rTrans_bar;
};
constexpr int kGadAdjNumPointers = kGadNumPointers + 4;

template <typename T>
struct GadAdjCell {
  const GadArgs<T>& a;
  int nr, ny, nx, oly, olx, nyp, nxp;
  T diffKh, rkSign;

  __device__ size_t i3(int k, int j, int i) const {
    return (static_cast<size_t>(k) * nyp + j) * nxp + i;
  }
  __device__ size_t i2(int j, int i) const {
    return static_cast<size_t>(j) * nxp + i;
  }
  __device__ bool row(int j) const { return j >= oly && j < oly + ny; }
  __device__ bool col(int i) const { return i >= olx && i < olx + nx; }

  // cotangent of the bracket of interior cell (k, j, i):
  // gTr = -(recip_hFacC recip_drF recip_rA) * bracket; 0 off the interior
  __device__ T s(int k, int j, int i) const {
    if (k < 0 || k >= nr || !row(j) || !col(i)) return T(0);
    const size_t p = i3(k, j, i);
    return -(a.recip_hFacC[p] * a.recip_drF[k] * a.recip_rA[i2(j, i)]) *
           a.gTr[p];
  }
  // ... times maskInC, which multiplies the horizontal divergence and the
  // tracer * divTrans term
  __device__ T sIn(int k, int j, int i) const {
    if (k < 0 || k >= nr || !row(j) || !col(i)) return T(0);
    return s(k, j, i) * a.maskInC[i2(j, i)];
  }
  // cotangent of divTrans of cell (k, j, i)
  __device__ T divBar(int k, int j, int i) const {
    if (k < 0 || k >= nr || !row(j) || !col(i)) return T(0);
    return -sIn(k, j, i) * a.tracer[i3(k, j, i)];
  }
  // cotangents of the fluxes at the west face of (k, j, i) (the east face
  // of cell i-1), at its south face, and at its upper interface k. Each is
  // nonzero only on the faces of interior cells, and only there are the
  // partial derivatives, which read one cell further, evaluated.
  __device__ bool zonFace(int j, int i) const {
    return row(j) && i >= olx && i <= olx + nx;
  }
  __device__ bool merFace(int j, int i) const {
    return col(i) && j >= oly && j <= oly + ny;
  }
  __device__ bool verFace(int k, int j, int i) const {
    return k >= 1 && k < nr && row(j) && col(i);
  }
  __device__ T zonBar(int k, int j, int i) const {
    return sIn(k, j, i - 1) - sIn(k, j, i);
  }
  __device__ T merBar(int k, int j, int i) const {
    return sIn(k, j - 1, i) - sIn(k, j, i);
  }
  __device__ T verBar(int k, int j, int i) const {
    return (s(k - 1, j, i) - s(k, j, i)) * rkSign;
  }
  // d fZon(k, j, i) / d tracer(k, j, i) (sign +1) or / d tracer(k, j, i-1)
  // (sign -1): uTrans/2 -+ diffKh xA recip_dxC cosFacU
  __device__ T dZon(int k, int j, int i, T sign) const {
    const size_t p = i3(k, j, i), q = i2(j, i);
    return a.uTrans[p] * T(0.5) -
           sign * (diffKh * a.xA[p] * a.recip_dxC[q] * a.cosFacU[q]);
  }
  __device__ T dMer(int k, int j, int i, T sign) const {
    const size_t p = i3(k, j, i), q = i2(j, i);
    return a.vTrans[p] * T(0.5) -
           sign * (diffKh * a.yA[p] * a.recip_dyC[q]);
  }
  // d fVer(k, j, i) / d tracer(k) (sign +1) or / d tracer(k-1) (sign -1)
  __device__ T dVer(int k, int j, int i, T sign) const {
    const size_t p = i3(k, j, i), q = i2(j, i);
    const size_t pm = p - static_cast<size_t>(nyp) * nxp;
    const T adv = a.maskC[pm] * a.rTrans[p] * T(0.5) * a.maskInC[q];
    const T dif = a.kappaR[p] * a.maskUp[p] * a.rA[q] * a.recip_drC[k] *
                  rkSign;
    return adv - sign * dif;
  }
};

template <typename T>
__global__ void calc_rhs_c2_adj_kernel(const GadAdjArgs<T> b, int nr, int ny,
                                       int nx, int oly, int olx, T diffKh,
                                       T rkSign) {
  const int nyp = ny + 2 * oly, nxp = nx + 2 * olx;
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const GadArgs<T>& a = b.f;
  const GadAdjCell<T> c{a, nr, ny, nx, oly, olx, nyp, nxp, diffKh, rkSign};
  const size_t p = c.i3(k, j, i);
  // no interior output reads a cell more than one cell outside the
  // interior
  if (i < olx - 1 || i > olx + nx || j < oly - 1 || j > oly + ny) {
    b.tracer_bar[p] = T(0);
    b.uTrans_bar[p] = T(0);
    b.vTrans_bar[p] = T(0);
    b.rTrans_bar[p] = T(0);
    return;
  }
  const size_t q = c.i2(j, i);
  const size_t dk = static_cast<size_t>(nyp) * nxp;
  const T t = a.tracer[p];

  // uTrans: the advective flux at this face and divTrans of the cells on
  // either side of it
  T uBar = c.divBar(k, j, i - 1) - c.divBar(k, j, i);
  if (c.zonFace(j, i))
    uBar = uBar + c.zonBar(k, j, i) * (T(0.5) * (t + a.tracer[p - 1]));
  T vBar = c.divBar(k, j - 1, i) - c.divBar(k, j, i);
  if (c.merFace(j, i))
    vBar = vBar + c.merBar(k, j, i) * (T(0.5) * (t + a.tracer[p - nxp]));
  // rTrans(k) is rTrans of cell k and rTransKp of cell k-1
  T rBar = (c.divBar(k - 1, j, i) - c.divBar(k, j, i)) * rkSign;
  if (c.verFace(k, j, i))
    rBar = rBar + c.verBar(k, j, i) *
                      (a.maskC[p - dk] * T(0.5) * (t + a.tracer[p - dk]) *
                       a.maskInC[q]);

  // tracer: the - tracer * divTrans term of its own cell, then the fluxes
  // of its six faces
  T tBar = T(0);
  if (c.row(j) && c.col(i)) {
    const T rTransKp = k + 1 < nr ? a.rTrans[p + dk] : T(0);
    const T divTrans = (a.uTrans[p + 1] - a.uTrans[p]) +
                       (a.vTrans[p + nxp] - a.vTrans[p]) +
                       (rTransKp - a.rTrans[p]) * rkSign;
    tBar = -c.sIn(k, j, i) * divTrans;
  }
  if (c.zonFace(j, i))
    tBar = tBar + c.zonBar(k, j, i) * c.dZon(k, j, i, T(1));
  if (c.zonFace(j, i + 1))
    tBar = tBar + c.zonBar(k, j, i + 1) * c.dZon(k, j, i + 1, T(-1));
  if (c.merFace(j, i))
    tBar = tBar + c.merBar(k, j, i) * c.dMer(k, j, i, T(1));
  if (c.merFace(j + 1, i))
    tBar = tBar + c.merBar(k, j + 1, i) * c.dMer(k, j + 1, i, T(-1));
  if (c.verFace(k, j, i))
    tBar = tBar + c.verBar(k, j, i) * c.dVer(k, j, i, T(1));
  if (c.verFace(k + 1, j, i))
    tBar = tBar + c.verBar(k + 1, j, i) * c.dVer(k + 1, j, i, T(-1));

  b.tracer_bar[p] = tBar;
  b.uTrans_bar[p] = uBar;
  b.vTrans_bar[p] = vBar;
  b.rTrans_bar[p] = rBar;
}

template <typename T>
int launch_calc_rhs_adj(const void* const* table, int n, int nr, int ny,
                        int nx, int oly, int olx, double diffKh,
                        double rkSign, void* stream) {
  static_assert(sizeof(GadAdjArgs<T>) == kGadAdjNumPointers * sizeof(void*),
                "GadAdjArgs must be a plain table of pointers");
  if (n != kGadAdjNumPointers || oly < 1 || olx < 1)
    return (int)cudaErrorInvalidValue;
  GadAdjArgs<T> b;
  std::memcpy(&b, table, sizeof(b));
  const dim3 g((nx + 2 * olx + BX - 1) / BX, (ny + 2 * oly + BY - 1) / BY,
               nr);
  calc_rhs_c2_adj_kernel<T><<<g, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      b, nr, ny, nx, oly, olx, T(diffKh), T(rkSign));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

extern "C" int mitgcm_gad_calc_rhs_c2_adj_f32(const void* const* table,
                                              int n, int nr, int ny, int nx,
                                              int oly, int olx, double diffKh,
                                              double rkSign, void* stream) {
  return mitgcm::launch_calc_rhs_adj<float>(table, n, nr, ny, nx, oly, olx,
                                            diffKh, rkSign, stream);
}

extern "C" int mitgcm_gad_calc_rhs_c2_adj_f64(const void* const* table,
                                              int n, int nr, int ny, int nx,
                                              int oly, int olx, double diffKh,
                                              double rkSign, void* stream) {
  return mitgcm::launch_calc_rhs_adj<double>(table, n, nr, ny, nx, oly, olx,
                                             diffKh, rkSign, stream);
}
