// Kernel P: direction-split multi-dimensional advection of one tracer with
// the Lagrangian piecewise parabolic (PPM, schemes 40-42) and quartic (PQM,
// 50-52) methods, each with the null, monotone and WENO limiters.
//
// Replaces: mitgcm_tpu/model/gad.py:_ppm_pqm_flux_h (:565-600) with
// _p3e_edge / _p5e_edge (:410-448), _osc_hat / _osc_mul / _osc_ends
// (:451-485, :603-627), _ppm_pqm_hat (:488-526), _plm_slope (:275),
// _ppm_coef / _ppm_mono / _pqm_coef / _pqm_mono (:289-407), _sl_flux
// (:529-545) and ppm_pqm_band (:548-562), and _ppm_pqm_flux_r (:630-780),
// inside multidim_advection's X, Y and R passes (:1120-1154), which XLA
// fused into one pass per direction over the padded [nr, nyp, nxp] arrays
// on the TPU.
//
// One launch per sweep: gad_ppm_x, _y and _r (gad_ppm_tile.cuh, a header
// of its own for the tests' host check).
//
// Bound: bytes for PPM, operations for PQM's limiter and WENO. Per sweep a
// cell reads its input field, the tracer, a transport and a velocity,
// maskC, recip_hFacC and the spacings and writes one field (~7 fields,
// ~28 B/cell in float32). A PQM cell costs ~300 flops, 2 divisions and a
// square root; a WENO cell's weights add 2 more divisions.
// Design: each edge, WENO derivative pair, cell polynomial and face flux is
// formed once: X in shared memory, a stage at a time, over a warp's row
// segment; Y and R in registers along a walk (gad_ppm_tile.cuh says how).
// Everything keeps JAX's operation order, so that the kernel is bit-equal
// to its plain twin (model/gad_ho.py) with --fmad=false. The traps of the
// JAX code, kept: every intermediate is shifted with zero fill (the right
// edge of the last cell is 0, not an edge computed from data; the upwind
// coefficients of the first face are 0; the WENO window reads derivatives
// of 0 and masks of 0 outside the array), _osc_ends replaces the
// derivatives of the first and last cell of each row with one-sided ones,
// and the vertical column is padded with 3 ghost copies of its end values
// whose mask is 0. The discrete choices (extrema, limL/limR, condA/condB,
// limDL/limDR, the QUADROOT roots, bindm/bindp, the pops c1/c2, ok and
// blend) are the twin's, compared exactly.

#include "gad_ppm_tile.cuh"

#define MITGCM_P_ENTRY(NAME, DIR, SUF, T)                                      \
  extern "C" int mitgcm_gad_ppm_##NAME##_##SUF(                                \
      const void* const* table, int n, const void* src, void* dst,           \
      const void* add, int nr,                                                 \
      int nyp, int nxp, int scheme, double deltaT, double rkSign,             \
      void* stream) {                                                          \
    return mitgcm::launch_ppm<T, DIR>(                                        \
        table, n, src, dst, add, nr, nyp, nxp, scheme, deltaT, rkSign,        \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }

MITGCM_P_ENTRY(x, 0, f32, float)
MITGCM_P_ENTRY(x, 0, f64, double)
MITGCM_P_ENTRY(y, 1, f32, float)
MITGCM_P_ENTRY(y, 1, f64, double)
MITGCM_P_ENTRY(r, 2, f32, float)
MITGCM_P_ENTRY(r, 2, f64, double)
