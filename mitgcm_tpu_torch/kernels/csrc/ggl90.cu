// Kernel G9: GGL90 TKE vertical mixing (Gaspar, Gregoris & Lefevre 1990),
// with IDEMIX's TKE source and the Langmuir parameterization.
//
// Replaces: mitgcm_tpu/model/ggl90.py:GGL90.calc (:358-574) in
// z-coordinates, with GGL90.mixinglength (:109-206) and solve_tridiagonal
// (:590-612), which XLA ran as fused passes over [nr, nyp, nxp] arrays and
// two lax.scan's over the levels. IDEMIX itself (GGL90.idemix) is kernel
// H-IDEMIX (idemix.cu), which runs first and hands this kernel its TKE
// source gTKE.
//
// Two launches per step:
//   ggl90_col  one thread per (j, i) column of the whole padded plane
//              (ggl90_col.cuh): Nsq from sigmaR, the buoyancy mixing length
//              with its mxlMaxFlag limiter (the down and up sweeps of flags
//              2 and 3) and, with Langmuir, the length LCML the mixing uses
//              (LC_Gamma times ML where the limiter set ML, :178-196),
//              KappaM and visctmp, the vertical shear (either
//              calcMeanVertShear branch), the Richardson and Prandtl numbers
//              (with IDEMIX its own Prandtl number, :423-428), the explicit
//              TKE sources (with IDEMIX's gTKE and the Stokes-drift
//              production, :441-465), the tridiagonal coefficients (with
//              IDEMIX scaled by 1/hFacI, :474) with the surface and bottom
//              Dirichlet folds (or the Neumann bottom), the Thomas solve
//              with its zero-pivot rule, the TKE floor and diffKr.
//   ggl90_visc one thread per cell: viscArU / viscArV, the averages of
//              visctmp to U and V points with their clips (:560-569).
//
// Bound: bytes. ggl90_col reads 6 3-D fields (u, v, tke, sigmaR, maskC,
// recip_hFacC; 8 with IDEMIX's hFacC and gTKE; the u(i+1), v(j+1) neighbours
// hit L1/L2) and writes 3 (tke', diffKr, visctmp), ~36 B/cell in float32,
// for ~180 operations a cell (one exp more with Langmuir), six divisions
// and three square roots among them; ggl90_visc reads 3 fields and writes
// 2. Design: a column's levels are coupled (the sweeps, the tridiagonal
// solve), so one thread walks one column, i fastest so that every level's
// loads and stores are coalesced, in three passes (up for the sweep from the
// bottom, down for the mixing and the forward elimination a row behind, up
// for the back substitution) that keep two values a level in dynamic shared
// memory and no per-thread array, so no local memory and no cap of levels
// but a block's shared memory (ggl90_col.cuh; four per-thread arrays of 64
// levels in local memory, before, took about twice as long, PERF.md's table
// of kernels). Columns outside the interior are computed like the interior
// ones, with zero for neighbours outside the padded array, exactly as the
// JAX code's zero-filled shifts do; so every output cell, halos included, is
// the plain twin's. Each expression keeps the twin's (and the JAX code's)
// operation order, and exp and sqrt are the CUDA math library's, which
// PyTorch's elementwise kernels call; built with --fmad=false the outputs
// are bit-equal to the twins (model/ggl90.py:_ggl90_col_plain,
// _ggl90_visc_plain). IDEMIX and Langmuir are template flags. The discrete
// choices (the Prandtl switch Ri >= 0.2 or IDEMIX's clip to [1, 10],
// Langmuir's equality test ML == its limit, the bottom level klowC-1 of the
// Dirichlet fold and of the kp1 clip, the zero-pivot rule) follow the JAX
// code's semantics.

#include "ggl90_col.cuh"

namespace mitgcm {

template <typename T>
__global__ void ggl90_visc_kernel(const T* __restrict__ visctmp,
                                  const T* __restrict__ maskW,
                                  const T* __restrict__ maskS,
                                  T* __restrict__ viscU, T* __restrict__ viscV,
                                  int nr, int nyp, int nxp, T viscMax,
                                  T viscAr) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t p = k * P + static_cast<size_t>(j) * nxp + i;
  if (k == 0) {
    viscU[p] = T(0);
    viscV[p] = T(0);
    return;
  }
  const T vt = visctmp[p];
  const T vW = i > 0 ? visctmp[p - 1] : T(0);
  const T vS = j > 0 ? visctmp[p - nxp] : T(0);
  const T mW = maskW[p] * maskW[p - P], mS = maskS[p] * maskS[p - P];
  viscU[p] = g9max(g9min(mW * T(0.5) * (vt + vW), viscMax), viscAr);
  viscV[p] = g9max(g9min(mS * T(0.5) * (vt + vS), viscMax), viscAr);
}

template <typename T>
int launch_ggl90_visc(const void* visctmp, const void* maskW,
                      const void* maskS, void* viscU, void* viscV, int nr,
                      int nyp, int nxp, double viscMax, double viscAr,
                      void* stream) {
  const dim3 g((nxp + BX - 1) / BX, (nyp + BY - 1) / BY, nr);
  ggl90_visc_kernel<T><<<g, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      (const T*)visctmp, (const T*)maskW, (const T*)maskS, (T*)viscU,
      (T*)viscV, nr, nyp, nxp, T(viscMax), T(viscAr));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define MITGCM_GGL90_ENTRY(SUF, T)                                             \
  extern "C" int mitgcm_ggl90_col_##SUF(                                       \
      const void* const* table, int n, const double* params, int np, int nr, \
      int nyp, int nxp, int flag, int meanShear, int dirichlet, int idemix,   \
      int langmuir, void* stream) {                                            \
    return mitgcm::launch_ggl90_col<T>(                                        \
        table, n, params, np, nr, nyp, nxp, flag, meanShear, dirichlet,        \
        idemix, langmuir, mitgcm::OnStream{(cudaStream_t)stream});             \
  }                                                                            \
  extern "C" int mitgcm_ggl90_visc_##SUF(                                      \
      const void* visctmp, const void* maskW, const void* maskS, void* viscU, \
      void* viscV, int nr, int nyp, int nxp, double viscMax, double viscAr,   \
      void* stream) {                                                          \
    return mitgcm::launch_ggl90_visc<T>(visctmp, maskW, maskS, viscU, viscV,  \
                                        nr, nyp, nxp, viscMax, viscAr,        \
                                        stream);                               \
  }

MITGCM_GGL90_ENTRY(f32, float)
MITGCM_GGL90_ENTRY(f64, double)
