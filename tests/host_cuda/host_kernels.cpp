// Kernels B and C's forward kernels, D and G's mom_correction, built by g++
// against the mock CUDA runtime beside this file and run on the host
// through the launches that their entry points use (launch_mom,
// launch_calc_rhs, launch_phihyd of kernels/csrc/*_tile.cuh,
// launch_mom_correction of mom_correction.cuh), for
// tests/test_torch_host_kernels.py.
#include "cuda_runtime.h"
#include "gad_calc_rhs_tile.cuh"
#include "mom_correction.cuh"
#include "mom_fluxform_tile.cuh"
#include "phihyd_tile.cuh"

using namespace mitgcm;

// Starts a tile kernel on the mock: every thread of every block in turn.
struct OnHost {
  template <typename Kernel, typename... Args>
  void operator()(Kernel kernel, dim3 grid, dim3 block, Args... args) const {
    host_launch(grid, block, [&] { kernel(args...); });
  }
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

HOST_ENTRY_POINTS(float, f32)
HOST_ENTRY_POINTS(double, f64)
