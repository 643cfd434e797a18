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
// and their reciprocals, the kappas at one interface) and writes 4, ~68
// B/cell in float32, for about 200 flops: well below the card's ~20
// flops/byte.
// Design (mom_vecinv_tile.cuh): column-walking tiles of 32 x 4 columns
// that stage each level in shared memory and form each hFacZ, vorticity,
// zeta, divergence and KE once, with 2-D metrics in registers for the
// whole column, the next level's loads in flight while a level is
// computed, and a template variant for each combination of the vorticity
// and Coriolis schemes, implicit viscosity and bottom drag. (One thread per
// (k, j, i) recomputing every neighbour quantity from the inputs, before,
// evaluated hFacZ about ten times a cell, several hundred loads; PERF.md's
// PR 19 section has the times.) Halo cells of the outputs are written as 0
// by the blocks past the tiles; step.py fills uStar and vStar.
//
// The dissipation variant (entry point mitgcm_mom_vecinv_visc, template
// flag Ext) takes kernel X's viscosities, multiplying D and Z before the
// differencing (:267-280), the biharmonic term from the divergence and
// vorticity of kernel Y's Laplacian, staged over the tile and its ring
// (:281-293, :309-321 with constant viscA4), or the strain-tension form
// (:255-266, mom_hdissip.F), the side drag with the per-wall viscosities
// (:342-371) and the quadratic bottom drag, which the JAX code leaves out
// and the port forms as the flux form does. The vi-gyre's variants are the
// same code without it.
//
// Each expression keeps the JAX code's operation order, so with
// --fmad=false the outputs are bit-equal to the plain PyTorch twin
// (mom_vecinv.py:_mom_vecinv_plain).

#include "mom_vecinv_tile.cuh"

#define MITGCM_VECINV_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* const* table, int n, int nr, int ny,      \
                      int nx, int oly, int olx, int vortScheme,             \
                      int coriScheme, int implicitViscosity,                \
                      int noSlipBottom, double viscAh,                      \
                      double sideDragFactor, double bottomDragLinear,       \
                      double rkSign, void* stream) {                        \
    return mitgcm::launch_vecinv<T>(                                        \
        table, n, nr, ny, nx, oly, olx, vortScheme, coriScheme,             \
        implicitViscosity, noSlipBottom, viscAh, sideDragFactor,            \
        bottomDragLinear, rkSign, mitgcm::OnStream{(cudaStream_t)stream});  \
  }

#define MITGCM_VECINV_VISC_ENTRY(NAME, T)                                   \
  extern "C" int NAME(const void* const* table, int n, int nr, int ny,      \
                      int nx, int oly, int olx, int vortScheme,             \
                      int coriScheme, int implicitViscosity,                \
                      int noSlipBottom, double viscAh,                      \
                      double sideDragFactor, double bottomDragLinear,       \
                      double rkSign, const void* const* vtable, int nv,     \
                      const double* params, int np, int strainTension,      \
                      int drag, void* stream) {                             \
    return mitgcm::launch_vecinv_visc<T>(                                   \
        table, n, nr, ny, nx, oly, olx, vortScheme, coriScheme,             \
        implicitViscosity, noSlipBottom, viscAh, sideDragFactor,            \
        bottomDragLinear, rkSign, vtable, nv, params, np, strainTension,    \
        drag, mitgcm::OnStream{(cudaStream_t)stream});                      \
  }

// the float32 entry points of the plain variants here, the others in
// mom_vecinv_f64.cu, mom_vecinv_visc.cu and mom_vecinv_visc_f64.cu (this
// file with MITGCM_F64 and MITGCM_VISC set), so that nvcc builds the four
// at once
#if !defined(MITGCM_F64) && !defined(MITGCM_VISC)
MITGCM_VECINV_ENTRY(mitgcm_mom_vecinv_f32, float)
#elif !defined(MITGCM_VISC)
MITGCM_VECINV_ENTRY(mitgcm_mom_vecinv_f64, double)
#elif !defined(MITGCM_F64)
MITGCM_VECINV_VISC_ENTRY(mitgcm_mom_vecinv_visc_f32, float)
#else
MITGCM_VECINV_VISC_ENTRY(mitgcm_mom_vecinv_visc_f64, double)
#endif
