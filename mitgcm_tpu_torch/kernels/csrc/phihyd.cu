// Kernel D: the hydrostatic column integral and its horizontal gradient.
//
// Replaces: mitgcm_tpu/model/phihyd.py:calc_phi_hyd (:211-268), the oceanic
// z-coordinate branch without r* or quasi-hydrostatic terms, which XLA
// fused into a scan down the levels and two shifted differences:
//   buoy = gravity * rho * (1/rhoConst),
//   incr = (dRlocM + dRlocP) * buoy,
//   phiC = (cumsum_k(incr) - incr) + dRlocM * buoy,
//   dPhiHydX = recip_dxC * (phiC - phiC[i-1]), dPhiHydY likewise in j,
// with phiC[i-1] and phiC[j-1] zero outside the padded array (the shifts'
// zero fill), so column 0 and row 0 take the difference from 0.
//
// Bound: bytes. It reads rho once and writes phiC, dPhiHydX and dPhiHydY
// (16 B/cell in float32, plus two 2-D fields), for about 15 flops a cell.
// Design: column-walking tiles over the padded array that scan each column
// once (phihyd_tile.cuh, a header of its own for the tests' host check).

#include "phihyd_tile.cuh"

#define MITGCM_PHIHYD_ENTRY_POINT(T, SUF)                                     \
  extern "C" int mitgcm_phihyd_##SUF(                                         \
      const void* rho, const void* drC, const void* rF, const void* rC,       \
      const void* rdxC, const void* rdyC, void* phiC, void* dX, void* dY,     \
      int nr, int nyp, int nxp, double gravity, double recip_rhoConst,        \
      void* stream) {                                                         \
    return mitgcm::launch_phihyd<T>(rho, drC, rF, rC, rdxC, rdyC, phiC, dX,   \
                                    dY, nr, nyp, nxp, gravity,                \
                                    recip_rhoConst, mitgcm::kPhiMinBlocks,    \
                                    mitgcm::OnStream{(cudaStream_t)stream});  \
  }

MITGCM_PHIHYD_ENTRY_POINT(float, f32)
MITGCM_PHIHYD_ENTRY_POINT(double, f64)
