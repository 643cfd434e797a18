// Kernels B and C's forward kernels, B', D, G's mom_correction, H-cg3d's two
// passes, H-seaice EVP's seaice_evp_uv, V, M's, O's and P's three sweeps,
// H-SOM's three passes, W, G9's ggl90_col, J-uv, J-ts, L and R's two
// kernels, built by g++ against the mock CUDA runtime beside this file and
// run on the host through the launches that their entry points use
// (launch_mom, launch_mom_adj of
// mom_fluxform_adj_tile.cuh, launch_calc_rhs, launch_phihyd,
// launch_s_stencil_dot and launch_xr_precond of kernels/csrc/*_tile.cuh,
// launch_mom_correction of mom_correction.cuh, launch_evp_uv of
// seaice_evp_uv.cuh, launch_vecinv of mom_vecinv_tile.cuh, launch_multidim
// of gad_multidim_tile.cuh, launch_os7mp of gad_os7mp_tile.cuh, launch_ppm
// of gad_ppm_tile.cuh, launch_som_horiz and launch_som_r of som_tile.cuh,
// launch_calc_gw of calc_gw_tile.cuh, launch_ggl90_col of ggl90_col.cuh,
// launch_kappa_uv and launch_kappa_ts of mix_glue.cuh, launch_adv_flow of
// adv_flow.cuh, launch_find_rho and launch_sigma_r of eos.cuh), and the
// step glue's backward kernels F', D', E', G', L' and R' (launch_halo_fold
// of halo_adj.cuh, launch_phihyd_adj of phihyd_adj.cuh,
// launch_cg2d_rhs_adj and launch_continuity_adj of step_scans_adj.cuh,
// launch_mom_ab_step_adj, launch_mom_correction_adj and
// launch_tracer_step_adj of step_glue_adj.cuh, launch_adv_flow_adj of
// adv_flow.cuh, launch_eos_linear_adj of eos.cuh), and X and Y
// (launch_calc_visc and launch_del2uv of mom_visc.cuh) with B's and V's
// dissipation variants (launch_mom_visc, launch_vecinv_visc), and U and Z
// (launch_vertmix_calc of vertmix.cuh, launch_opps_col of opps.cuh), and
// CD, SH-uv and SH-ts (launch_cd_scheme of cd_code.cuh, launch_shap of
// shap_filt.cuh), and TH (launch_thsice_step of thsice.cuh), and
// seaice_advect with the ice tracers (launch_seaice_advect of
// seaice_advect.cuh), seaice_thermo with its tracer variant TP
// (launch_seaice_thermo of seaice_thermo.cuh) and LA
// (launch_seaice_advect_legacy of seaice_advect_legacy.cuh), for
// tests/test_torch_host_kernels.py.
#include "cuda_runtime.h"
#include "adv_flow.cuh"
#include "calc_gw_tile.cuh"
#include "cd_code.cuh"
#include "cg3d_setup.cuh"
#include "cg3d_tile.cuh"
#include "eos.cuh"
#include "forcing.cuh"
#include "gad_calc_rhs_tile.cuh"
#include "gad_multidim_tile.cuh"
#include "gad_os7mp_tile.cuh"
#include "gad_ppm_tile.cuh"
#include "ggl90_col.cuh"
#include "halo_adj.cuh"
#include "mix_glue.cuh"
#include "mom_correction.cuh"
#include "mom_fluxform_adj_tile.cuh"
#include "mom_fluxform_tile.cuh"
#include "mom_vecinv_tile.cuh"
#include "mom_visc.cuh"
#include "opps.cuh"
#include "phihyd_adj.cuh"
#include "phihyd_tile.cuh"
#include "pre_cg3d.cuh"
#include "seaice_evp_uv.cuh"
#include "seaice_glue.cuh"
#include "shap_filt.cuh"
#include "som_tile.cuh"
#include "step_glue.cuh"
#include "step_glue_adj.cuh"
#include "step_scans.cuh"
#include "step_scans_adj.cuh"
#include "thsice.cuh"
#include "seaice_advect.cuh"
#include "seaice_advect_legacy.cuh"
#include "seaice_thermo.cuh"
#include "vertmix.cuh"

using namespace mitgcm;

// Starts a tile kernel on the mock: every thread of every block in turn.
// max_shared is the card's limit of a block's shared memory that the
// launch is told (the test picks either side of a staging's size).
struct OnHost {
  size_t max_shared_bytes = 0;
  template <typename Kernel, typename... Args>
  void operator()(Kernel kernel, dim3 grid, dim3 block, Args... args) const {
    host_launch(grid, block, [&] { kernel(args...); });
  }
  template <typename Kernel, typename... Args>
  void shared(Kernel kernel, size_t bytes, dim3 grid, dim3 block,
              Args... args) const {
    host_dynamic_shared_bytes.assign(bytes, 0);
    host_launch(grid, block, [&] { kernel(args...); });
  }
  size_t max_shared() const { return max_shared_bytes; }
};

#define HOST_ENTRY_POINTS(T, SUF)                                            \
  extern "C" int host_mom_fluxform_##SUF(                                    \
      const void* const* table, int n, int nr, int ny, int nx, int oly,      \
      int olx, int no_slip_sides, int coriolis_3d, double viscAhD,           \
      double viscAhZ, double sideDragFactor, double rkSign,                  \
      double gravitySign) {                                                  \
    return launch_mom<T>(table, n, nr, ny, nx, oly, olx, no_slip_sides,      \
                         coriolis_3d, viscAhD, viscAhZ, sideDragFactor,      \
                         rkSign, gravitySign, OnHost{});                     \
  }                                                                          \
  extern "C" int host_mom_fluxform_adj_##SUF(                                \
      const void* const* table, int n, int nr, int ny, int nx, int oly,      \
      int olx, double viscAhD, double viscAhZ, double sideDragFactor,        \
      double rkSign) {                                                       \
    return launch_mom_adj<T>(table, n, nr, ny, nx, oly, olx, viscAhD,        \
                             viscAhZ, sideDragFactor, rkSign, OnHost{});     \
  }                                                                          \
  extern "C" int host_gad_calc_rhs_c2_##SUF(                                 \
      const void* const* table, int n, int nr, int ny, int nx, int oly,      \
      int olx, double diffKh, double rkSign, int implicitDiffusion,          \
      int calcAdvection, const void* df, const void* const* gm_table,        \
      int n_gm, double KuxVal, double KvyVal) {                              \
    return launch_calc_rhs<T>(table, n, nr, ny, nx, oly, olx, diffKh,        \
                              rkSign, implicitDiffusion, calcAdvection, df,  \
                              gm_table, n_gm, KuxVal, KvyVal, OnHost{});     \
  }                                                                          \
  extern "C" int host_phihyd_##SUF(                                          \
      const void* rho, const void* drC, const void* rF, const void* rC,      \
      const void* rdxC, const void* rdyC, void* phiC, void* dX, void* dY,    \
      int nr, int nyp, int nxp, double gravity, double recip_rhoConst,      \
      int min_blocks) {                                                      \
    return launch_phihyd<T>(rho, drC, rF, rC, rdxC, rdyC, phiC, dX, dY, nr,  \
                            nyp, nxp, gravity, recip_rhoConst, min_blocks,   \
                            OnHost{});                                       \
  }                                                                          \
  extern "C" int host_mom_correction_##SUF(                                  \
      const void* const* table, int n, int nr, int nyp, int nxp, int nh,     \
      double dtPsFac, double psFac, double nhFac, double deltaTMom,          \
      int min_blocks) {                                                      \
    return launch_mom_correction<T>(table, n, nr, nyp, nxp, nh, dtPsFac,     \
                                    psFac, nhFac, deltaTMom, min_blocks,     \
                                    OnHost{});                               \
  }

#define HOST_CG3D_ENTRY_POINTS(T, SUF)                                       \
  extern "C" int host_cg3d_s_stencil_dot_##SUF(                              \
      const void* const* table, int n, int nr, int ny, int nx, int oly,      \
      int olx) {                                                             \
    SStencilArgs<T> a;                                                       \
    if (!unpack(&a, table, n, 15)) return cudaErrorInvalidValue;            \
    return launch_s_stencil_dot<T>(a, nr, ny, nx, oly, olx, OnHost{});       \
  }                                                                          \
  extern "C" int host_cg3d_xr_precond_##SUF(                                 \
      const void* const* table, int n, int nr, int ny, int nx, int oly,      \
      int olx, int max_iters, int count_iter, long long max_shared) {        \
    XrPrecondArgs<T> a;                                                      \
    if (!unpack(&a, table, n, 18)) return cudaErrorInvalidValue;            \
    return launch_xr_precond<T>(a, nr, ny, nx, oly, olx, max_iters,          \
                                count_iter,                                  \
                                OnHost{static_cast<size_t>(max_shared)});    \
  }                                                                          \
  extern "C" int host_seaice_evp_uv_##SUF(                                   \
      const void* const* table, int n, const double* params, int nparams,    \
      int ny, int nx, int ol, int adaptive, int rev_den, int last) {         \
    return launch_evp_uv<T>(table, n, params, nparams, ny, nx, ol, adaptive, \
                            rev_den, last, OnHost{});                        \
  }

// V, M's and O's sweeps and H-SOM's passes, with their entry points'
// arguments but the stream
#define HOST_ADVECTION_ENTRY_POINTS(T, SUF)                                  \
  extern "C" int host_mom_vecinv_##SUF(                                      \
      const void* const* table, int n, int nr, int ny, int nx, int oly,      \
      int olx, int vortScheme, int coriScheme, int implicitViscosity,        \
      int noSlipBottom, double viscAh, double sideDragFactor,                \
      double bottomDragLinear, double rkSign) {                              \
    return launch_vecinv<T>(table, n, nr, ny, nx, oly, olx, vortScheme,      \
                            coriScheme, implicitViscosity, noSlipBottom,     \
                            viscAh, sideDragFactor, bottomDragLinear,        \
                            rkSign, OnHost{});                               \
  }                                                                          \
  extern "C" int host_gad_multidim_##SUF(                                    \
      int dir, const void* const* table, int n, const void* src, void* dst,  \
      const void* add, int nr, int nyp, int nxp, int scheme, double deltaT,  \
      double rkSign) {                                                       \
    if (dir == 0)                                                            \
      return launch_multidim<T, 0>(table, n, src, dst, add, nr, nyp, nxp,    \
                                   scheme, deltaT, rkSign, OnHost{});        \
    if (dir == 1)                                                            \
      return launch_multidim<T, 1>(table, n, src, dst, add, nr, nyp, nxp,    \
                                   scheme, deltaT, rkSign, OnHost{});        \
    return launch_multidim<T, 2>(table, n, src, dst, add, nr, nyp, nxp,      \
                                 scheme, deltaT, rkSign, OnHost{});          \
  }                                                                          \
  extern "C" int host_gad_os7mp_##SUF(                                       \
      int dir, const void* const* table, int n, const void* src, void* dst,  \
      const void* add, int nr, int nyp, int nxp, int scheme, double deltaT,  \
      double rkSign) {                                                       \
    if (dir == 0)                                                            \
      return launch_os7mp<T, 0>(table, n, src, dst, add, nr, nyp, nxp,       \
                                scheme, deltaT, rkSign, OnHost{});           \
    if (dir == 1)                                                            \
      return launch_os7mp<T, 1>(table, n, src, dst, add, nr, nyp, nxp,       \
                                scheme, deltaT, rkSign, OnHost{});           \
    return launch_os7mp<T, 2>(table, n, src, dst, add, nr, nyp, nxp,         \
                              scheme, deltaT, rkSign, OnHost{});             \
  }                                                                          \
  extern "C" int host_gad_ppm_##SUF(                                         \
      int dir, const void* const* table, int n, const void* src, void* dst,  \
      const void* add, int nr, int nyp, int nxp, int scheme, double deltaT,  \
      double rkSign) {                                                       \
    if (dir == 0)                                                            \
      return launch_ppm<T, 0>(table, n, src, dst, add, nr, nyp, nxp,         \
                              scheme, deltaT, rkSign, OnHost{});             \
    if (dir == 1)                                                            \
      return launch_ppm<T, 1>(table, n, src, dst, add, nr, nyp, nxp,         \
                              scheme, deltaT, rkSign, OnHost{});             \
    return launch_ppm<T, 2>(table, n, src, dst, add, nr, nyp, nxp,           \
                            scheme, deltaT, rkSign, OnHost{});               \
  }                                                                          \
  extern "C" int host_som_##SUF(                                             \
      int dir, const void* const* table, int n, const void* volIn,           \
      const void* oIn, const void* smIn, void* volOut, void* oOut,           \
      void* smOut, void* gTr, const void* add, int nr, int nyp, int nxp,     \
      int limiter, double deltaT) {                                          \
    if (dir == 0)                                                            \
      return som::launch_som_horiz<T, 0>(table, n, volIn, oIn, smIn, volOut, \
                                         oOut, smOut, nr, nyp, nxp, limiter, \
                                         deltaT, OnHost{});                  \
    if (dir == 1)                                                            \
      return som::launch_som_horiz<T, 1>(table, n, volIn, oIn, smIn, volOut, \
                                         oOut, smOut, nr, nyp, nxp, limiter, \
                                         deltaT, OnHost{});                  \
    return som::launch_som_r<T>(table, n, volIn, oIn, smIn, smOut, gTr, add, \
                                nr, nyp, nxp, limiter, deltaT, OnHost{});    \
  }

// W and G9's ggl90_col, with their entry points' arguments but the stream
#define HOST_COLUMN_ENTRY_POINTS(T, SUF)                                     \
  extern "C" int host_calc_gw_##SUF(                                         \
      const void* const* table, int n, int nr, int nyp, int nxp,             \
      int coriolis_3d, double viscAhW, double rkSign, double gravitySign) {  \
    return launch_calc_gw<T>(table, n, nr, nyp, nxp, coriolis_3d, viscAhW,   \
                             rkSign, gravitySign, OnHost{});                 \
  }                                                                          \
  extern "C" int host_ggl90_col_##SUF(                                       \
      const void* const* table, int n, const double* params, int np, int nr, \
      int nyp, int nxp, int flag, int meanShear, int dirichlet, int idemix,  \
      int langmuir, long long max_shared) {                                  \
    return launch_ggl90_col<T>(table, n, params, np, nr, nyp, nxp, flag,     \
                               meanShear, dirichlet, idemix, langmuir,       \
                               OnHost{static_cast<size_t>(max_shared)});     \
  }

// J-uv, J-ts, L and R's two kernels, with their entry points' arguments but
// the stream
#define HOST_MIX_ENTRY_POINTS(T, SUF)                                        \
  extern "C" int host_kappa_uv_##SUF(const void* const* table, int n,        \
                                     int nr, int nyp, int nxp, int mode,     \
                                     double viscAr) {                        \
    return launch_kappa_uv<T>(table, n, nr, nyp, nxp, mode, viscAr,          \
                              OnHost{});                                     \
  }                                                                          \
  extern "C" int host_kappa_ts_##SUF(                                        \
      const void* const* table, int n, const double* params, int np, int nr, \
      int nyp, int nxp, int kpp, int gm, int ggl90) {                        \
    return launch_kappa_ts<T>(table, n, params, np, nr, nyp, nxp, kpp, gm,   \
                              ggl90, OnHost{});                              \
  }                                                                          \
  extern "C" int host_adv_flow_##SUF(const void* const* table, int n,        \
                                     int nr, int nyp, int nxp) {             \
    return launch_adv_flow<T>(table, n, nr, nyp, nxp, OnHost{});             \
  }                                                                          \
  extern "C" int host_eos_find_rho_##SUF(                                    \
      const void* const* table, int n, const double* params, int np, int nr, \
      int plane, int kind, int use_phi, int use_mask) {                      \
    return launch_find_rho<T>(table, n, params, np, nr, plane, kind,         \
                              use_phi, use_mask, OnHost{});                  \
  }                                                                          \
  extern "C" int host_eos_sigma_r_##SUF(                                     \
      const void* const* table, int n, const double* params, int np, int nr, \
      int nyp, int nxp, int kind, int use_phi) {                             \
    return launch_sigma_r<T>(table, n, params, np, nr, nyp, nxp, kind,       \
                             use_phi, OnHost{});                             \
  }

// the backward kernels F', D', E', G', L' and R', with their entry points'
// arguments but the stream
#define HOST_ADJ_ENTRY_POINTS(T, SUF)                                        \
  extern "C" int host_halo_fold_##SUF(const void* g, void* out, int planes, \
                                      int ny, int nx, int oly, int olx) {    \
    return launch_halo_fold<T>(g, out, planes, ny, nx, oly, olx, OnHost{});  \
  }                                                                          \
  extern "C" int host_phihyd_adj_##SUF(const void* const* t, int n, int nr, \
                                       int nyp, int nxp, double gravity,     \
                                       double recip_rhoConst) {              \
    return launch_phihyd_adj<T>(t, n, nr, nyp, nxp, gravity, recip_rhoConst, \
                                OnHost{});                                   \
  }                                                                          \
  extern "C" int host_cg2d_rhs_adj_##SUF(                                    \
      const void* const* t, int n, int nr, int nyp, int nxp, int oly,        \
      int olx, double implicDiv2Dflow, double deltaTMom, double freeSurfFac, \
      double deltaTFreeSurf) {                                               \
    return launch_cg2d_rhs_adj<T>(t, n, nr, nyp, nxp, oly, olx,              \
                                  implicDiv2Dflow, deltaTMom, freeSurfFac,   \
                                  deltaTFreeSurf, OnHost{});                 \
  }                                                                          \
  extern "C" int host_continuity_adj_##SUF(const void* const* t, int n,      \
                                           int nr, int nyp, int nxp) {       \
    return launch_continuity_adj<T>(t, n, nr, nyp, nxp, OnHost{});           \
  }                                                                          \
  extern "C" int host_mom_ab_step_adj_##SUF(                                 \
      const void* const* t, int n, int nr, int nyp, int nxp, int ab,         \
      double abFac, double ab0, double ab1, double ab2, double deltaTMom) {  \
    return launch_mom_ab_step_adj<T>(t, n, nr, nyp, nxp, ab, abFac, ab0,     \
                                     ab1, ab2, deltaTMom, OnHost{});         \
  }                                                                          \
  extern "C" int host_mom_correction_adj_##SUF(                              \
      const void* const* t, int n, int nr, int nyp, int nxp,                 \
      double dtPsFac) {                                                      \
    return launch_mom_correction_adj<T>(t, n, nr, nyp, nxp, dtPsFac,         \
                                        OnHost{});                           \
  }                                                                          \
  extern "C" int host_tracer_step_adj_##SUF(                                 \
      const void* const* t, int n, int nr, int nyp, int nxp, int ks, int ab, \
      double abFac, double ab0, double ab1, double ab2, double deltaT) {     \
    return launch_tracer_step_adj<T>(t, n, nr, nyp, nxp, ks, ab, abFac, ab0, \
                                     ab1, ab2, deltaT, OnHost{});            \
  }                                                                          \
  extern "C" int host_adv_flow_adj_##SUF(const void* const* t, int n,        \
                                         int nr, int nyp, int nxp) {         \
    return launch_adv_flow_adj<T>(t, n, nr, nyp, nxp, OnHost{});             \
  }                                                                          \
  extern "C" int host_eos_linear_adj_##SUF(const void* const* t, int n,      \
                                           int nr, int plane, double rhoNil, \
                                           double tAlpha, double sBeta) {    \
    return launch_eos_linear_adj<T>(t, n, nr, plane, rhoNil, tAlpha, sBeta,  \
                                    OnHost{});                               \
  }

// the last glue: E's and G's first passes (step_scans.cuh, step_glue.cuh),
// N1, N2, Q, S1 and S2, with their entry points' arguments but the stream
#define HOST_LAST_GLUE_ENTRY_POINTS(T, SUF)                                  \
  extern "C" int host_cg2d_rhs_##SUF(                                        \
      const void* const* t, int n, int nr, int nyp, int nxp, int oly,        \
      int olx, int hydrostatic, double implicDiv2Dflow, double deltaTMom,    \
      double freeSurfFac, double deltaTFreeSurf) {                           \
    return launch_cg2d_rhs<T>(t, n, nr, nyp, nxp, oly, olx, hydrostatic,     \
                              implicDiv2Dflow, deltaTMom, freeSurfFac,       \
                              deltaTFreeSurf, OnHost{});                     \
  }                                                                          \
  extern "C" int host_mom_ab_step_##SUF(                                     \
      const void* const* t, int n, int nr, int nyp, int nxp, int ab, int nh, \
      double abFac, double ab0, double ab1, double ab2, double deltaTMom,    \
      double wFac) {                                                         \
    return launch_mom_ab_step<T>(t, n, nr, nyp, nxp, ab, nh, abFac, ab0,     \
                                 ab1, ab2, deltaTMom, wFac, OnHost{});       \
  }                                                                          \
  extern "C" int host_pre_cg3d_##SUF(                                        \
      const void* const* t, int n, int nr, int nyp, int nxp, double psFac,   \
      double freeSurfFac, double deltaTFreeSurf, double deltaTMom) {         \
    return launch_pre_cg3d<T>(t, n, nr, nyp, nxp, psFac, freeSurfFac,        \
                              deltaTFreeSurf, deltaTMom, OnHost{});          \
  }                                                                          \
  extern "C" int host_cg3d_setup_scale_##SUF(                                \
      const void* const* t, int n, int nr, int nyp, int nxp, int normalise) { \
    return launch_cg3d_setup_scale<T>(t, n, nr, nyp, nxp, normalise,         \
                                      OnHost{});                             \
  }                                                                          \
  extern "C" int host_cg3d_setup_fill_##SUF(                                 \
      const void* const* t, int n, int nr, int nyp, int nxp, int normalise) { \
    return launch_cg3d_setup_fill<T>(t, n, nr, nyp, nxp, normalise,          \
                                     OnHost{});                              \
  }                                                                          \
  extern "C" int host_surface_forcing_##SUF(                                 \
      const void* const* t, int n, const double* params, int np, int nyp,    \
      int nxp, int flags) {                                                  \
    return launch_surface_forcing<T>(t, n, params, np, nyp, nxp, flags,      \
                                     OnHost{});                              \
  }                                                                          \
  extern "C" int host_seaice_dynforcing_##SUF(                               \
      const void* const* t, int n, const double* params, int np, int nyp,    \
      int nxp, int flags) {                                                  \
    return launch_seaice_dynforcing<T>(t, n, params, np, nyp, nxp, flags,    \
                                       OnHost{});                            \
  }                                                                          \
  extern "C" int host_seaice_ocean_stress_##SUF(                             \
      const void* const* t, int n, const double* params, int np, int nyp,    \
      int nxp, int mode, int flags) {                                        \
    return launch_seaice_ocean_stress<T>(t, n, params, np, nyp, nxp, mode,   \
                                         flags, OnHost{});                   \
  }

// X, Y and B's and V's dissipation variants, with their entry points'
// arguments but the stream
#define HOST_VISC_ENTRY_POINTS(T, SUF)                                       \
  extern "C" int host_mom_calc_visc_##SUF(                                   \
      const void* const* table, int n, const double* params, int np, int nr, \
      int nyp, int nxp, int smag, int leith, int re, int bih) {              \
    return launch_calc_visc<T>(table, n, params, np, nr, nyp, nxp, smag,     \
                               leith, re, bih, OnHost{});                    \
  }                                                                          \
  extern "C" int host_mom_del2uv_##SUF(const void* const* table, int n,      \
                                       int nr, int nyp, int nxp, int vi,     \
                                       double param) {                       \
    return launch_del2uv<T>(table, n, nr, nyp, nxp, vi, param, OnHost{});    \
  }                                                                          \
  extern "C" int host_mom_fluxform_visc_##SUF(                               \
      const void* const* table, int n, int nr, int ny, int nx, int oly,      \
      int olx, int no_slip_sides, int coriolis_3d, double viscAhD,           \
      double viscAhZ, double sideDragFactor, double rkSign,                  \
      double gravitySign, const void* const* vtable, int nv,                 \
      const double* params, int np, int no_slip_bottom, int drag) {          \
    return launch_mom_visc<T>(table, n, nr, ny, nx, oly, olx, no_slip_sides, \
                              coriolis_3d, viscAhD, viscAhZ, sideDragFactor, \
                              rkSign, gravitySign, vtable, nv, params, np,   \
                              no_slip_bottom, drag, OnHost{});               \
  }                                                                          \
  extern "C" int host_mom_vecinv_visc_##SUF(                                 \
      const void* const* table, int n, int nr, int ny, int nx, int oly,      \
      int olx, int vortScheme, int coriScheme, int implicitViscosity,        \
      int noSlipBottom, double viscAh, double sideDragFactor,                \
      double bottomDragLinear, double rkSign, const void* const* vtable,     \
      int nv, const double* params, int np, int strainTension, int drag) {   \
    return launch_vecinv_visc<T>(                                            \
        table, n, nr, ny, nx, oly, olx, vortScheme, coriScheme,              \
        implicitViscosity, noSlipBottom, viscAh, sideDragFactor,             \
        bottomDragLinear, rkSign, vtable, nv, params, np, strainTension,     \
        drag, OnHost{});                                                     \
  }

// U and Z, with their entry points' arguments but the stream; a block's
// shared memory as an H100's opt-in limit
constexpr size_t kHostMaxShared = 232448;
#define HOST_RIMIX_ENTRY_POINTS(T, SUF)                                      \
  extern "C" int host_vertmix_calc_##SUF(                                    \
      const void* const* table, int n, const double* params, int np, int nr, \
      int nyp, int nxp, int my82, int kind, int use_phi, int nRi) {          \
    return launch_vertmix_calc<T>(table, n, params, np, nr, nyp, nxp, my82,  \
                                  kind, use_phi, nRi,                        \
                                  OnHost{kHostMaxShared});                   \
  }                                                                          \
  extern "C" int host_opps_col_##SUF(                                        \
      const void* const* table, int n, const double* params, int np, int nr, \
      int nyp, int nxp, int kind, int use_phi, int max_abe) {                \
    return launch_opps_col<T>(table, n, params, np, nr, nyp, nxp, kind,      \
                              use_phi, max_abe, OnHost{kHostMaxShared});     \
  }

// CD, SH-uv and SH-ts, with their entry points' arguments but the stream
#define HOST_CD_SHAP_ENTRY_POINTS(T, SUF)                                    \
  extern "C" int host_cd_scheme_##SUF(const void* const* table, int n,       \
                                      const double* params, int np, int nr,  \
                                      int nyp, int nxp) {                    \
    return launch_cd_scheme<T>(table, n, params, np, nr, nyp, nxp,           \
                               OnHost{});                                    \
  }                                                                          \
  extern "C" int host_shap_uv_##SUF(                                         \
      const void* const* table, int n, const double* params, int np, int nr, \
      int nyp, int nxp, int oly, int olx, int fill, int first, int last,     \
      int physical, int length) {                                            \
    return launch_shap<T>(0, table, n, params, np, nr, nyp, nxp, oly, olx,   \
                          ShapFlags{fill, first, last, physical, length},    \
                          OnHost{});                                         \
  }                                                                          \
  extern "C" int host_shap_ts_##SUF(                                         \
      const void* const* table, int n, const double* params, int np, int nr, \
      int nyp, int nxp, int oly, int olx, int fill, int first, int last,     \
      int physical, int length) {                                            \
    return launch_shap<T>(1, table, n, params, np, nr, nyp, nxp, oly, olx,   \
                          ShapFlags{fill, first, last, physical, length},    \
                          OnHost{});                                         \
  }

// TH, with its entry point's arguments but the stream
#define HOST_THSICE_ENTRY_POINTS(T, SUF)                                     \
  extern "C" int host_thsice_step_##SUF(                                     \
      const void* const* table, int n, const double* params, int np,         \
      int nyp, int nxp, int oly, int olx, int nitMaxTsf) {                   \
    return launch_thsice_step<T>(table, n, params, np, nyp, nxp, oly, olx,   \
                                 nitMaxTsf, OnHost{});                       \
  }

// the sea ice's advection (with its tracers), LA and seaice_thermo
// (TP's variant too), with their entry points' arguments but the stream
#define HOST_SEAICE_ENTRY_POINTS(T, SUF)                                     \
  extern "C" int host_seaice_advect_x_##SUF(                                 \
      const void* const* table, int n, void* fld, const void* tr, void* dst, \
      int nyp, int nxp, int ol, int scheme, int ntr, int mates, double dt) { \
    return launch_seaice_advect<T>(true, table, n, fld, nullptr, tr, dst,    \
                                   nyp, nxp, ol, scheme, ntr, mates, dt,     \
                                   0.0, 0.0, 0.0, 0.0, OnHost{});            \
  }                                                                          \
  extern "C" int host_seaice_advect_y_##SUF(                                 \
      const void* const* table, int n, const void* fld, const void* localT,  \
      const void* tr, void* dst, int nyp, int nxp, int ol, int scheme,       \
      int ntr, int mates, double dt, double kh0, double kh1, double kh2,     \
      double area_floor) {                                                   \
    return launch_seaice_advect<T>(false, table, n, fld, localT, tr, dst,    \
                                   nyp, nxp, ol, scheme, ntr, mates, dt,     \
                                   kh0, kh1, kh2, area_floor, OnHost{});     \
  }                                                                          \
  extern "C" int host_seaice_advect_legacy_##SUF(                            \
      const void* const* table, int n, const double* params, int nparams,    \
      int nyp, int nxp, int ol, int pass) {                                  \
    return launch_seaice_advect_legacy<T>(table, n, params, nparams, nyp,    \
                                          nxp, ol, pass, OnHost{});          \
  }                                                                          \
  extern "C" int host_seaice_thermo_##SUF(                                   \
      const void* const* table, int n, const double* params, int nparams,    \
      int nyp, int nxp, int ol, int multDim, int imax) {                     \
    return launch_seaice_thermo<T, false>(table, n, params, nparams,         \
                                          nullptr, 0, nullptr, nullptr, nyp, \
                                          nxp, ol, multDim, imax, OnHost{}); \
  }                                                                          \
  extern "C" int host_seaice_thermo_tr_##SUF(                                \
      const void* const* table, int n, const double* params, int nparams,    \
      const double* trparams, int ntrparams, const void* tr_in,              \
      void* tr_out, int nyp, int nxp, int ol, int multDim, int imax) {       \
    return launch_seaice_thermo<T, true>(table, n, params, nparams,          \
                                         trparams, ntrparams, tr_in, tr_out, \
                                         nyp, nxp, ol, multDim, imax,        \
                                         OnHost{});                          \
  }

HOST_ENTRY_POINTS(float, f32)
HOST_ENTRY_POINTS(double, f64)
HOST_SEAICE_ENTRY_POINTS(float, f32)
HOST_SEAICE_ENTRY_POINTS(double, f64)
HOST_THSICE_ENTRY_POINTS(float, f32)
HOST_THSICE_ENTRY_POINTS(double, f64)
HOST_CD_SHAP_ENTRY_POINTS(float, f32)
HOST_CD_SHAP_ENTRY_POINTS(double, f64)
HOST_RIMIX_ENTRY_POINTS(float, f32)
HOST_RIMIX_ENTRY_POINTS(double, f64)
HOST_VISC_ENTRY_POINTS(float, f32)
HOST_VISC_ENTRY_POINTS(double, f64)
HOST_CG3D_ENTRY_POINTS(float, f32)
HOST_CG3D_ENTRY_POINTS(double, f64)
HOST_ADVECTION_ENTRY_POINTS(float, f32)
HOST_ADVECTION_ENTRY_POINTS(double, f64)
HOST_COLUMN_ENTRY_POINTS(float, f32)
HOST_COLUMN_ENTRY_POINTS(double, f64)
HOST_MIX_ENTRY_POINTS(float, f32)
HOST_MIX_ENTRY_POINTS(double, f64)
HOST_ADJ_ENTRY_POINTS(float, f32)
HOST_ADJ_ENTRY_POINTS(double, f64)
HOST_LAST_GLUE_ENTRY_POINTS(float, f32)
HOST_LAST_GLUE_ENTRY_POINTS(double, f64)
