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
// Design: one thread per padded column (j, i), i fastest, walking k = 0 ..
// nr-1 with the running sum in a register. The west and south neighbour
// columns are recomputed in the same thread (two more running sums, 2 x nr
// more loads that hit L1/L2 because the neighbouring threads load them
// too) rather than written out and read back by a second launch: that keeps
// the DRAM traffic at one read of rho and one write of each output. The
// half-cell weights dRlocM/dRlocP are formed on the device from drC, rF
// and rC as the twin forms them (0.5 * drC, with the end values), and the
// running sum adds in k order, as the twin's loop does, so with
// --fmad=false the outputs are bit-equal to model/phihyd.py:_phi_hyd_plain.

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct PhiColumn {
  T acc = T(0);
  // phiC of level k from that level's buoyancy, advancing the running sum
  __device__ T next(T b, T wsum, T wM) {
    const T incr = wsum * b;
    acc = acc + incr;
    return (acc - incr) + wM * b;
  }
};

template <typename T>
__global__ void phihyd_kernel(const T* __restrict__ rho,
                              const T* __restrict__ drC,
                              const T* __restrict__ rF,
                              const T* __restrict__ rC,
                              const T* __restrict__ rdxC,
                              const T* __restrict__ rdyC,
                              T* __restrict__ phiC, T* __restrict__ dX,
                              T* __restrict__ dY, int nr, int nyp, int nxp,
                              T gravity, T recip_rhoConst) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t q = static_cast<size_t>(j) * nxp + i;
  const bool west = i > 0, south = j > 0;
  const T rx = rdxC[q], ry = rdyC[q];
  PhiColumn<T> c, w, s;
  for (int k = 0; k < nr; ++k) {
    const T wM = k == 0 ? rF[0] - rC[0] : T(0.5) * drC[k];
    const T wP = k == nr - 1 ? rC[nr - 1] - rF[nr] : T(0.5) * drC[k + 1];
    const T wsum = wM + wP;
    const size_t p = k * P + q;
    const T pc = c.next((gravity * rho[p]) * recip_rhoConst, wsum, wM);
    const T pw =
        west ? w.next((gravity * rho[p - 1]) * recip_rhoConst, wsum, wM)
             : T(0);
    const T ps =
        south ? s.next((gravity * rho[p - nxp]) * recip_rhoConst, wsum, wM)
              : T(0);
    phiC[p] = pc;
    dX[p] = rx * (pc - pw);
    dY[p] = ry * (pc - ps);
  }
}

template <typename T>
int launch_phihyd(const void* rho, const void* drC, const void* rF,
                  const void* rC, const void* rdxC, const void* rdyC,
                  void* phiC, void* dX, void* dY, int nr, int nyp, int nxp,
                  double gravity, double recip_rhoConst, void* stream) {
  if (nr < 1 || nyp < 1 || nxp < 1) return (int)cudaErrorInvalidValue;
  phihyd_kernel<T><<<grid2d(nyp, nxp), dim3(BX, BY), 0,
                     (cudaStream_t)stream>>>(
      (const T*)rho, (const T*)drC, (const T*)rF, (const T*)rC,
      (const T*)rdxC, (const T*)rdyC, (T*)phiC, (T*)dX, (T*)dY, nr, nyp, nxp,
      T(gravity), T(recip_rhoConst));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define MITGCM_PHIHYD_ENTRY_POINT(T, SUF)                                     \
  extern "C" int mitgcm_phihyd_##SUF(                                         \
      const void* rho, const void* drC, const void* rF, const void* rC,       \
      const void* rdxC, const void* rdyC, void* phiC, void* dX, void* dY,     \
      int nr, int nyp, int nxp, double gravity, double recip_rhoConst,        \
      void* stream) {                                                         \
    return mitgcm::launch_phihyd<T>(rho, drC, rF, rC, rdxC, rdyC, phiC, dX,   \
                                    dY, nr, nyp, nxp, gravity,                \
                                    recip_rhoConst, stream);                  \
  }

MITGCM_PHIHYD_ENTRY_POINT(float, f32)
MITGCM_PHIHYD_ENTRY_POINT(double, f64)
