// Kernel D' (phihyd_adj): the VJP of kernel D, and its launch. Included by
// phihyd_adj.cu, whose entry point starts it on the card, and by the host
// check of the tests, which runs it on the CPU.
//
// Replaces the VJP that jax.grad took of mitgcm_tpu/model/phihyd.py:
// calc_phi_hyd (:171, the integr_GeoPot = 2 branch, :211-268), whose
// forward is
//   b = (gravity * rho) * (1/rhoConst), incr = (dRlocM + dRlocP) * b,
//   phiC = (cumsum_k(incr) - incr) + dRlocM * b,
//   dPhiHydX = recip_dxC * (phiC - phiC[i-1]), dPhiHydY likewise in j.
// The map is linear in rho, so its transpose needs no saved value: with
//   P = (phiC_bar + (ex - ex[i+1])) + (ey - ey[j+1]),
//   ex = dPhiHydX_bar * recip_dxC, ey = dPhiHydY_bar * recip_dyC
// (the neighbour beyond the last column or row 0, as the shifts' zero fill
// reads it), the exclusive prefix sum transposes into the exclusive suffix
// sum S(k) = P(k+1) + ... + P(nr-1), and
//   b_bar = S * (dRlocM + dRlocP) + P * dRlocM,
//   rho_bar = (b_bar * (1/rhoConst)) * gravity.
//
// Bound: bytes. It reads the three cotangents once and writes rho_bar once
// (16 B/cell in float32), plus the two 2-D metrics; about 12 flops a cell.
// Design: gather form, one thread a padded column (i fastest), walking the
// levels from the bottom up with S in a register; the east and north
// neighbours' cotangents are read in place (the neighbouring threads load
// the same cells). Each value keeps the order of the plain version
// (model/phihyd.py:phihyd_vjp_plain), so with --fmad=false the result is
// bit-equal to it.
#pragma once

#include "phihyd_tile.cuh"

namespace mitgcm {

template <typename T>
__global__ void phihyd_adj_kernel(const T* __restrict__ phiC_bar,
                                  const T* __restrict__ dX_bar,
                                  const T* __restrict__ dY_bar,
                                  const T* __restrict__ drC,
                                  const T* __restrict__ rF,
                                  const T* __restrict__ rC,
                                  const T* __restrict__ rdxC,
                                  const T* __restrict__ rdyC,
                                  T* __restrict__ rho_bar, int nr, int nyp,
                                  int nxp, T gravity, T recip_rhoConst) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t q = static_cast<size_t>(j) * nxp + i;
  const bool east = i + 1 < nxp, north = j + 1 < nyp;
  const T rdx = rdxC[q], rdy = rdyC[q];
  const T rdxE = east ? rdxC[q + 1] : T(0);
  const T rdyN = north ? rdyC[q + nxp] : T(0);
  T S = T(0);
  for (int k = nr - 1; k >= 0; --k) {
    const size_t p = k * P + q;
    const T ex = dX_bar[p] * rdx;
    const T exE = east ? dX_bar[p + 1] * rdxE : T(0);
    const T ey = dY_bar[p] * rdy;
    const T eyN = north ? dY_bar[p + nxp] * rdyN : T(0);
    const T Pk = (phiC_bar[p] + (ex - exE)) + (ey - eyN);
    T w[2];
    phi_weights(drC, rF, rC, k, nr, w);
    const T b = S * w[1] + Pk * w[0];
    rho_bar[p] = (b * recip_rhoConst) * gravity;
    S = S + Pk;
  }
}

template <typename T, typename Start>
int launch_phihyd_adj(const void* const* t, int n, int nr, int nyp, int nxp,
                      double gravity, double recip_rhoConst, Start start) {
  if (n != 9 || nr < 1 || nyp < 1 || nxp < 1)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < n; ++k)
    if (!t[k]) return (int)cudaErrorInvalidValue;
  start(phihyd_adj_kernel<T>, grid2d(nyp, nxp), dim3(BX, BY),
        (const T*)t[0], (const T*)t[1], (const T*)t[2], (const T*)t[3],
        (const T*)t[4], (const T*)t[5], (const T*)t[6], (const T*)t[7],
        (T*)t[8], nr, nyp, nxp, T(gravity), T(recip_rhoConst));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
