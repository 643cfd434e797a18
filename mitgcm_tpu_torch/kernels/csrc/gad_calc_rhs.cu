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
// Bound: bytes. Per cell it reads 10 3-D fields (the transports, areas and
// maskUp of AdvFlow, the tracer, kappaR, maskC and recip_hFacC; implicit
// diffusion without GM needs neither kappaR nor maskUp) and writes one,
// ~44 B/cell in float32, for about 60 flops; the GM branch reads 4 more
// (Kwx, Kwy, maskW, maskS), 6 with a 3-D Kux and Kvy, 8 with Kuz and Kvz,
// for about 60 flops more.
// Design (gad_calc_rhs_tile.cuh): column-walking tiles of 32 x 4 columns
// that stage the tracer once per level in shared memory and compute fZon
// and fMer once per face and fVer once per interface (kept in a register
// for the level below), with GM's dT/dx, dT/dy, up and dn once per column
// and level, 2-D metrics read once per column, and each level's loads
// issued while the level above is computed. (One thread per (k, j, i)
// recomputing the east, north and lower faces' fluxes, before, was bound
// by load instructions and L1/L2, not by DRAM; PERF.md's PR 14 section has
// the times.) Halo cells of gTr are written as 0 by the blocks past the
// tiles; the tracer step fills every prognostic field afterwards.
//
// Each expression keeps the JAX code's operation order, so with
// --fmad=false gTr is bit-equal to the plain PyTorch twin.

#include "gad_calc_rhs_tile.cuh"

#define MITGCM_CALC_RHS_ENTRY_POINTS(T, SUF)                                  \
  extern "C" int mitgcm_gad_calc_rhs_c2_##SUF(                                \
      const void* const* table, int n, int nr, int ny, int nx, int oly,       \
      int olx, double diffKh, double rkSign, int implicitDiffusion,           \
      int calcAdvection, const void* df, void* stream) {                      \
    return mitgcm::launch_calc_rhs<T>(                                        \
        table, n, nr, ny, nx, oly, olx, diffKh, rkSign, implicitDiffusion,    \
        calcAdvection, df, nullptr, 0, 0.0, 0.0,                              \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }                                                                           \
  extern "C" int mitgcm_gad_calc_rhs_c2_gm_##SUF(                             \
      const void* const* table, int n, int nr, int ny, int nx, int oly,       \
      int olx, double diffKh, double rkSign, int implicitDiffusion,           \
      int calcAdvection, const void* df, const void* const* gm_table,         \
      int n_gm, double KuxVal, double KvyVal, void* stream) {                 \
    if (!gm_table) return (int)cudaErrorInvalidValue;                         \
    return mitgcm::launch_calc_rhs<T>(                                        \
        table, n, nr, ny, nx, oly, olx, diffKh, rkSign, implicitDiffusion,    \
        calcAdvection, df, gm_table, n_gm, KuxVal, KvyVal,                    \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }

MITGCM_CALC_RHS_ENTRY_POINTS(float, f32)
MITGCM_CALC_RHS_ENTRY_POINTS(double, f64)
