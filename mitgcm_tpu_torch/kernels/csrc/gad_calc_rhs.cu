// Kernel C: explicit tracer tendency with centred 2nd-order advection
// (scheme 2), Laplacian horizontal and explicit vertical diffusion.
//
// Replaces: mitgcm_tpu/model/gad.py:calc_rhs (:1038-1117) with the
// scheme-2 fluxes adv_flux_x/y/r (:846-847, :881-882, :932-933 and the
// surface zero at :1021) and diff_flux_r (:1025-1031), the latter left out
// under implicit_diffusion (:1093-1094), plus an optional extra vertical
// flux df (the KPP nonlocal flux, :1099-1101): the flux divergence minus
// tracer * divTrans. Without calcAdvection (calc_rhs(calc_advection=False),
// the tracers that kernels M, O and P advect) the advective
// fluxes are 0 and divTrans is multiplied by advFac = 0, as in the JAX code.
// The GM branch (entry point gad_calc_rhs_c2_gm, the template flag GM) adds
// GM-Redi's fluxes (gad.py:1075-1098 with gmredi.py:xy_flux and r_flux):
// after the diffusive term in fZon and fMer (with GM_ExtraDiag's Kuz/Kvz
// dT/dz terms), and after the explicit diffusion and before df in fVer.
// XLA fused it into a few sweeps on the TPU.
//
// Bound: bytes. Per cell it reads 10 3-D fields (the transports and areas
// of AdvFlow, the tracer, kappaR, maskC and recip_hFacC) and writes one,
// ~44 B/cell in float32, for about 60 flops; the GM branch reads 4 more
// (Kwx, Kwy, maskW, maskS), 6 with a 3-D Kux and Kvy, 8 with Kuz and Kvz,
// for about 60 flops more.
// Design: one thread per (k, j, i), i fastest. The fluxes at the cell's
// east, north and lower faces are recomputed by the thread (their loads hit
// L1/L2) instead of being stored, so DRAM traffic is one read of each input
// and one write of gTr. Halo cells of gTr are written as 0; the tracer step
// fills every prognostic field afterwards.
//
// Each expression keeps the JAX code's operation order, so with
// --fmad=false gTr is bit-equal to the plain PyTorch twin.

#include <cstring>

#include "gad_calc_rhs.cuh"

namespace mitgcm {

template <typename T, bool GM>
__global__ void calc_rhs_c2_kernel(const GadArgs<T> a, int nr, int ny,
                                   int nx, int oly, int olx, T diffKh,
                                   T rkSign, bool implicitDiffusion,
                                   bool calcAdvection, const T* df,
                                   const GmArgs<T> g, T KuxVal, T KvyVal) {
  const int nyp = ny + 2 * oly, nxp = nx + 2 * olx;
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const GmFlux<T> gm{a, g, KuxVal, KvyVal, nr, nyp, nxp};
  const GadCell<T, GM> c{a,      nr,     nyp,
                         nxp,    diffKh, rkSign,
                         implicitDiffusion, calcAdvection, df, &gm};
  const size_t p = c.i3(k, j, i);
  if (i < olx || i >= olx + nx || j < oly || j >= oly + ny) {
    a.gTr[p] = T(0);
    return;
  }
  const size_t q = c.i2(j, i);
  const T rTransKp =
      k + 1 < nr ? a.rTrans[p + static_cast<size_t>(nyp) * nxp] : T(0);
  // advFac (gad.py:1104-1109); x * 1 is x, so with advection the sum
  // rounds as the plain divergence does
  const T advFac = calcAdvection ? T(1) : T(0);
  const T divTrans = (a.uTrans[p + 1] - a.uTrans[p]) * advFac +
                     (a.vTrans[p + nxp] - a.vTrans[p]) * advFac +
                     (rTransKp - a.rTrans[p]) * (rkSign * advFac);
  const T mIn = a.maskInC[q];
  a.gTr[p] = -(a.recip_hFacC[p] * a.recip_drF[k] * a.recip_rA[q] *
               (((c.fZon(k, j, i + 1) - c.fZon(k, j, i)) +
                 (c.fMer(k, j + 1, i) - c.fMer(k, j, i))) * mIn +
                (c.fVer(k + 1, j, i) - c.fVer(k, j, i)) * rkSign -
                a.tracer[p] * divTrans * mIn));
}

// gm_table null: kernel C; else its GM branch, gm_table the n_gm pointers
// of GmArgs and KuxVal/KvyVal the constant Kux and Kvy where those are null
template <typename T>
int launch_calc_rhs(const void* const* table, int n, int nr, int ny, int nx,
                    int oly, int olx, double diffKh, double rkSign,
                    int implicitDiffusion, int calcAdvection, const void* df,
                    const void* const* gm_table, int n_gm, double KuxVal,
                    double KvyVal, void* stream) {
  static_assert(sizeof(GadArgs<T>) == kGadNumPointers * sizeof(void*),
                "GadArgs must be a plain table of pointers");
  static_assert(sizeof(GmArgs<T>) == kGmNumPointers * sizeof(void*),
                "GmArgs must be a plain table of pointers");
  if (n != kGadNumPointers || (gm_table && n_gm != kGmNumPointers))
    return (int)cudaErrorInvalidValue;
  GadArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  GmArgs<T> gm{};
  if (gm_table) {
    std::memcpy(&gm, gm_table, sizeof(gm));
    if (!gm.Kwx || !gm.Kwy || !gm.maskW || !gm.maskS ||
        (gm.Kux == nullptr) != (gm.Kvy == nullptr) ||
        (gm.Kuz == nullptr) != (gm.Kvz == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  const dim3 g((nx + 2 * olx + BX - 1) / BX, (ny + 2 * oly + BY - 1) / BY,
               nr);
  if (gm_table)
    calc_rhs_c2_kernel<T, true><<<g, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
        a, nr, ny, nx, oly, olx, T(diffKh), T(rkSign), implicitDiffusion != 0,
        calcAdvection != 0, (const T*)df, gm, T(KuxVal), T(KvyVal));
  else
    calc_rhs_c2_kernel<T, false><<<g, dim3(BX, BY), 0,
                                   (cudaStream_t)stream>>>(
        a, nr, ny, nx, oly, olx, T(diffKh), T(rkSign), implicitDiffusion != 0,
        calcAdvection != 0, (const T*)df, gm, T(0), T(0));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define MITGCM_CALC_RHS_ENTRY_POINTS(T, SUF)                                  \
  extern "C" int mitgcm_gad_calc_rhs_c2_##SUF(                                \
      const void* const* table, int n, int nr, int ny, int nx, int oly,       \
      int olx, double diffKh, double rkSign, int implicitDiffusion,           \
      int calcAdvection, const void* df, void* stream) {                      \
    return mitgcm::launch_calc_rhs<T>(table, n, nr, ny, nx, oly, olx, diffKh, \
                                      rkSign, implicitDiffusion,              \
                                      calcAdvection, df, nullptr, 0, 0.0,     \
                                      0.0, stream);                           \
  }                                                                           \
  extern "C" int mitgcm_gad_calc_rhs_c2_gm_##SUF(                             \
      const void* const* table, int n, int nr, int ny, int nx, int oly,       \
      int olx, double diffKh, double rkSign, int implicitDiffusion,           \
      int calcAdvection, const void* df, const void* const* gm_table,         \
      int n_gm, double KuxVal, double KvyVal, void* stream) {                 \
    if (!gm_table) return (int)cudaErrorInvalidValue;                         \
    return mitgcm::launch_calc_rhs<T>(table, n, nr, ny, nx, oly, olx, diffKh, \
                                      rkSign, implicitDiffusion,              \
                                      calcAdvection, df, gm_table, n_gm,      \
                                      KuxVal, KvyVal, stream);                \
  }

MITGCM_CALC_RHS_ENTRY_POINTS(float, f32)
MITGCM_CALC_RHS_ENTRY_POINTS(double, f64)
