// Kernels X (mom_calc_visc) and Y (mom_del2uv): the variable horizontal
// viscosities and the biharmonic viscosity's Laplacian of (u, v).
//
// Replaces: X, mitgcm_tpu/model/mom_visc.py:calc_visc (:90-259) with its
// inputs as both momentum forms form them (calc_hdiv, calc_relvort3 with
// sideMaskFac, calc_tension, calc_strain with sideMaskFac, calc_ke;
// mom_fluxform.py:237-252, mom_vecinv.py:226-245): Smagorinsky, Leith and
// full Leith viscosities at D and Z points, with the grid-scaled viscosity,
// the grid and grid-Reynolds limits. Y, mom_fluxform.py:_del2uv (:67-119,
// the closed-wall term under no-slip sides) and mom_vecinv.py:del2uv
// (:454-480, Cartesian). XLA fused these shifted products into the
// momentum step on the TPU.
//
// Bound: bytes. X reads u, v and five 3-D grid fields and writes two or
// four fields, Y reads u, v and seven and writes two; a few hundred flops
// a cell (X's square roots, ~20 divisions' worth) against ~40-60 B/cell in
// float32.
// Design (mom_visc.cuh): one thread a padded cell, each recomputing the
// neighbour quantities it reads straight from u and v (X forms the
// vorticity and divergence at six points, the strain and tension at four);
// simple and right first, the loads mostly L1 and L2 hits. A column-walking
// tile that stages u and v, as kernels B and V do, is the next step.
// Every padded cell is written as the twin writes it.

#include "mom_visc.cuh"

#define MITGCM_VISC_ENTRY_POINTS(T, SUF)                                      \
  extern "C" int mitgcm_mom_calc_visc_##SUF(                                  \
      const void* const* table, int n, const double* params, int np, int nr,  \
      int nyp, int nxp, int smag, int leith, int re, int bih, void* stream) { \
    return mitgcm::launch_calc_visc<T>(                                       \
        table, n, params, np, nr, nyp, nxp, smag, leith, re, bih,             \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }                                                                           \
  extern "C" int mitgcm_mom_del2uv_##SUF(const void* const* table, int n,     \
                                         int nr, int nyp, int nxp, int vi,    \
                                         double param, void* stream) {        \
    return mitgcm::launch_del2uv<T>(table, n, nr, nyp, nxp, vi, param,        \
                                    mitgcm::OnStream{(cudaStream_t)stream});  \
  }

// the float32 entry points here, the float64 ones in mom_visc_f64.cu (this
// file with MITGCM_F64 set), so that nvcc builds the two at once
#ifndef MITGCM_F64
MITGCM_VISC_ENTRY_POINTS(float, f32)
#else
MITGCM_VISC_ENTRY_POINTS(double, f64)
#endif
