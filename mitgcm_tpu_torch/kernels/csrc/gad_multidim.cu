// Kernel M: direction-split multi-dimensional advection of one tracer with
// the schemes 1 (upwind), 20 (DST-2, Lax-Wendroff), 30 (DST-3), 33 (DST-3
// flux-limited) and 77 (the Superbee flux limiter), and the vertical
// schemes 1, 2 (centred), 3 (upwind-3rd), 4 (centred 4th), 20, 30, 33 and 77.
//
// Replaces: mitgcm_tpu/model/gad.py:multidim_advection (:1120-1154,
// Cartesian branch) with the fluxes of adv_flux_x / adv_flux_y (:839-908),
// _adv_flux_highorder (:783-836), _limiter (:85) and adv_flux_r
// (:911-1022), which XLA fused into one pass per direction over the padded
// [nr, nyp, nxp] arrays on the TPU.
//
// Three launches per tracer, one per sweep: gad_multidim_x, _y and _r
// (gad_multidim_tile.cuh, a header of its own for the tests' host check).
// Each kernel is a template on the scheme, so each scheme's code is
// compiled alone (no registers for the branches it does not take).
//
// Bound: bytes. Per sweep a cell reads its input field, the tracer, one
// transport and one velocity, recip_hFacC and a face mask (~7 fields,
// masks counted) and writes one, ~28-32 B/cell in float32 for ~90 flops.
// Design: X stages tiles with the stencil's margin in shared memory; Y
// walks chunks of rows and R whole columns with the stencil's 4 rows or
// levels in registers; each forms each face's flux once. (One thread a
// cell forming the fluxes at both of its faces, before, formed each flux
// twice; PERF.md's PR 19 section has the times.) Like the JAX code
// (ops/stencil.py: zero-filled shifts), every cell of the padded array is
// computed and a neighbour outside the array reads 0, a face flux outside
// it is 0; so the Y sweep reads in the halo rows exactly the values of the
// X sweep that the JAX code reads there. The vertical neighbours are
// clamped at the column ends (max(0, k-2), min(nr-1, k+1)), and the
// surface flux is 0. Built with --fmad=false the result is bit-equal to
// the plain twin (model/gad.py:_multidim_plain); the discrete choices (the
// limiter's clips, DST3-FL's overflow guard |Rj| 1e20 <= |R| and its sign,
// the clip of psi to [0, 1], C4's wall factor) are the twin's.

#include "gad_multidim_tile.cuh"

#define MITGCM_MD_ENTRY(NAME, DIR, SUF, T)                                     \
  extern "C" int mitgcm_gad_multidim_##NAME##_##SUF(                           \
      const void* const* table, int n, const void* src, void* dst,           \
      const void* add, int nr,                                                 \
      int nyp, int nxp, int scheme, double deltaT, double rkSign,             \
      void* stream) {                                                          \
    return mitgcm::launch_multidim<T, DIR>(                                   \
        table, n, src, dst, add, nr, nyp, nxp, scheme, deltaT, rkSign,        \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }

MITGCM_MD_ENTRY(x, 0, f32, float)
MITGCM_MD_ENTRY(x, 0, f64, double)
MITGCM_MD_ENTRY(y, 1, f32, float)
MITGCM_MD_ENTRY(y, 1, f64, double)
MITGCM_MD_ENTRY(r, 2, f32, float)
MITGCM_MD_ENTRY(r, 2, f64, double)
