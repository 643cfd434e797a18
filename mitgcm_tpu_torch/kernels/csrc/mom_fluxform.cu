// Kernel B: flux-form momentum tendencies gU, gV, guDiss, gvDiss.
//
// Replaces: mitgcm_tpu/model/mom_fluxform.py:mom_fluxform (:122-469) on the
// branches the ported paths run: centred advection with the free-surface
// dmask correction (:155-230), constant harmonic viscosity and the explicit
// vertical viscous flux (:233-307), no-slip bottom drag (:343-381) and
// Coriolis scheme 0 (:420-445); two template flags pick the side condition
// (the no-slip side drag of :312-340, or free slip without it) and the 3-D
// Coriolis term of the non-hydrostatic path (_coriolis_3d_u, :454-469), so
// the gyres compile to the code they had before. XLA fused this chain of
// shifted products into a few sweeps on the TPU.
//
// Bound: bytes. Per cell it reads 11 3-D fields (u, v, w, the hFac and
// masks, two kappa levels) and writes 4, ~60 B/cell in float32, for a few
// hundred flops: well below the card's ~20 flops/byte.
// Design: one thread per (k, j, i), i fastest, writing all four outputs in
// one pass. Neighbour fluxes (fZonU(i-1), fMerU(j+1), fVerU(k+1), hFacZ at
// j+1 and i+1, ...) are recomputed from the inputs instead of being stored:
// their loads hit L1/L2, so DRAM traffic stays at one read of each input
// and one write of each output. 2-D metrics are re-read for every level and
// stay in L2. Halo cells of the outputs are written as 0; callers fill or
// mask them (step.py fills uStar/vStar and every prognostic field).
//
// Each expression keeps the JAX code's operation order, so with
// --fmad=false the outputs are bit-equal to the plain PyTorch twin.

#include <cstring>

#include "mom_fluxform.cuh"

namespace mitgcm {

template <typename T, bool NoSlipSides, bool Coriolis3d>
__global__ void mom_fluxform_kernel(const MomArgs<T> a, int nr, int ny,
                                    int nx, int oly, int olx, T viscAhD,
                                    T viscAhZ, T sideDragFactor, T rkSign,
                                    T gravitySign) {
  const int nyp = ny + 2 * oly, nxp = nx + 2 * olx;
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const MomCell<T> c{a, nr, nyp, nxp};
  const size_t p = c.i3(k, j, i);
  if (i < olx || i >= olx + nx || j < oly || j >= oly + ny) {
    a.gU[p] = T(0);
    a.gV[p] = T(0);
    a.guDiss[p] = T(0);
    a.gvDiss[p] = T(0);
    return;
  }
  const size_t q = c.i2(j, i);
  const T u = a.u[p], v = a.v[p];
  const T rhW = a.recip_hFacW[p], rhS = a.recip_hFacS[p];
  const T rdrF = a.recip_drF[k], drF = a.drF[k];

  // advection (mom_fluxform.F:355-905)
  T gU = -(rhW * rdrF * a.recip_rAw[q] *
           ((c.fZonU(k, j, i) - c.fZonU(k, j, i - 1)) +
            (c.fMerU(k, j + 1, i) - c.fMerU(k, j, i)) +
            (c.fVerU(k + 1, j, i) - c.fVerU(k, j, i)) * rkSign));
  T gV = -(rhS * rdrF * a.recip_rAs[q] *
           ((c.fZonV(k, j, i + 1) - c.fZonV(k, j, i)) +
            (c.fMerV(k, j, i) - c.fMerV(k, j - 1, i)) +
            (c.fVerV(k + 1, j, i) - c.fVerV(k, j, i)) * rkSign));

  // harmonic viscosity + explicit vertical viscosity
  const T nAhD = -viscAhD, nAhZ = -viscAhZ;
  const T dVrU = (c.rViscU(k + 1, j, i, rkSign) - c.rViscU(k, j, i, rkSign))
                 * rkSign;
  const T dVrV = (c.rViscV(k + 1, j, i, rkSign) - c.rViscV(k, j, i, rkSign))
                 * rkSign;
  T guDiss = -(rhW * rdrF * a.recip_rAw[q] *
               ((c.vZonU(k, j, i, nAhD) - c.vZonU(k, j, i - 1, nAhD)) +
                (c.vMerU(k, j + 1, i, nAhZ) - c.vMerU(k, j, i, nAhZ)) +
                dVrU));
  T gvDiss = -(rhS * rdrF * a.recip_rAs[q] *
               ((c.vZonV(k, j, i + 1, nAhZ) - c.vZonV(k, j, i, nAhZ)) +
                (c.vMerV(k, j, i, nAhD) - c.vMerV(k, j - 1, i, nAhD)) +
                dVrV));

  // no-slip side drag (mom_u_sidedrag.F); none under free slip
  if (NoSlipSides) {
    const T hZ = c.hFacZ(k, j, i);
    const T Ahu = viscAhZ * u;
    const T uDrag =
        -(rhW * rdrF * a.recip_rAw[q] *
          ((a.hFacW[p] - hZ) * a.dxV[q] * a.recip_dyU[q] * Ahu +
           (a.hFacW[p] - c.hFacZ(k, j + 1, i)) * a.dxV[q + nxp] *
               a.recip_dyU[q + nxp] * Ahu) *
          drF * sideDragFactor);
    const T Ahv = viscAhZ * v * a.cosFacV[q];
    const T vDrag =
        -(rhS * rdrF * a.recip_rAs[q] *
          ((a.hFacS[p] - hZ) * a.dyU[q] * a.recip_dxV[q] * Ahv +
           (a.hFacS[p] - c.hFacZ(k, j, i + 1)) * a.dyU[q + 1] *
               a.recip_dxV[q + 1] * Ahv) *
          drF * sideDragFactor);
    guDiss = guDiss + uDrag;
    gvDiss = gvDiss + vDrag;
  }

  // no-slip bottom drag (mom_u_botdrag_coeff.F): only where the cell
  // below is dry, or at k = Nr
  const bool deepest = (k == nr - 1);
  const T recDr = deepest ? a.recip_drF[nr - 1] : a.recip_drC[k + 1];
  const T cDragU = a.kappaRU[c.i3(k + 1, j, i)] * recDr * T(2);
  const T cDragV = a.kappaRV[c.i3(k + 1, j, i)] * recDr * T(2);
  const size_t below = p + static_cast<size_t>(nyp) * nxp;
  const T bottomW = a.maskW[p] * (deepest ? T(1) : T(1) - a.maskW[below]);
  const T bottomS = a.maskS[p] * (deepest ? T(1) : T(1) - a.maskS[below]);
  guDiss = guDiss - cDragU * bottomW * u * rhW * rdrF;
  gvDiss = gvDiss - cDragV * bottomS * v * rhS * rdrF;

  // Coriolis, scheme 0 (mom_u_coriolis.F)
  const T fC = a.fCori[q];
  const T uCf = T(0.5) * (fC + a.fCori[q - 1]) * T(0.25) *
                (v + a.v[p + nxp] + a.v[p - 1] + a.v[p + nxp - 1]);
  const T vCf = T(-0.5) * (fC + a.fCori[q - nxp]) * T(0.25) *
                (u + a.u[p + 1] + a.u[p - nxp] + a.u[p - nxp + 1]);
  gU = gU + uCf;
  gV = gV + vCf;

  // 3-D Coriolis (mom_u_coriolis_nh.F): fPrime times w averaged to the
  // cell centre (zero below the bottom level), then to the U point
  if (Coriolis3d) {
    const size_t down = static_cast<size_t>(nyp) * nxp;
    const bool deep = (k == nr - 1);
    const T wbar = T(0.5) * (a.w[p] + (deep ? T(0) : a.w[p + down]));
    const T wbarW =
        T(0.5) * (a.w[p - 1] + (deep ? T(0) : a.w[p - 1 + down]));
    const T fcw = a.fCoriCos[q] * a.angleCosC[q] * wbar;
    const T fcwW = a.fCoriCos[q - 1] * a.angleCosC[q - 1] * wbarW;
    gU = gU + T(0.5) * (fcw + fcwW) * gravitySign;
  }

  const T mW = a.maskW[p], mS = a.maskS[p];
  a.gU[p] = gU * mW;
  a.gV[p] = gV * mS;
  a.guDiss[p] = guDiss * mW;
  a.gvDiss[p] = gvDiss * mS;
}

template <typename T, bool NoSlipSides, bool Coriolis3d>
void launch_mom_variant(const MomArgs<T>& a, int nr, int ny, int nx,
                        int oly, int olx, double viscAhD, double viscAhZ,
                        double sideDragFactor, double rkSign,
                        double gravitySign, cudaStream_t stream) {
  const dim3 g((nx + 2 * olx + BX - 1) / BX, (ny + 2 * oly + BY - 1) / BY,
               nr);
  mom_fluxform_kernel<T, NoSlipSides, Coriolis3d>
      <<<g, dim3(BX, BY), 0, stream>>>(a, nr, ny, nx, oly, olx, T(viscAhD),
                                       T(viscAhZ), T(sideDragFactor),
                                       T(rkSign), T(gravitySign));
}

template <typename T>
int launch_mom(const void* const* table, int n, int nr, int ny, int nx,
               int oly, int olx, int no_slip_sides, int coriolis_3d,
               double viscAhD, double viscAhZ, double sideDragFactor,
               double rkSign, double gravitySign, void* stream) {
  static_assert(sizeof(MomArgs<T>) == kMomNumPointers * sizeof(void*),
                "MomArgs must be a plain table of pointers");
  if (n != kMomNumPointers) return (int)cudaErrorInvalidValue;
  MomArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  const cudaStream_t s = (cudaStream_t)stream;
  if (no_slip_sides && !coriolis_3d)
    launch_mom_variant<T, true, false>(a, nr, ny, nx, oly, olx, viscAhD,
                                       viscAhZ, sideDragFactor, rkSign,
                                       gravitySign, s);
  else if (no_slip_sides)
    launch_mom_variant<T, true, true>(a, nr, ny, nx, oly, olx, viscAhD,
                                      viscAhZ, sideDragFactor, rkSign,
                                      gravitySign, s);
  else if (!coriolis_3d)
    launch_mom_variant<T, false, false>(a, nr, ny, nx, oly, olx, viscAhD,
                                        viscAhZ, sideDragFactor, rkSign,
                                        gravitySign, s);
  else
    launch_mom_variant<T, false, true>(a, nr, ny, nx, oly, olx, viscAhD,
                                       viscAhZ, sideDragFactor, rkSign,
                                       gravitySign, s);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define MITGCM_MOM_ENTRY_POINT(T, SUF)                                        \
  extern "C" int mitgcm_mom_fluxform_##SUF(                                   \
      const void* const* table, int n, int nr, int ny, int nx, int oly,       \
      int olx, int no_slip_sides, int coriolis_3d, double viscAhD,            \
      double viscAhZ, double sideDragFactor, double rkSign,                   \
      double gravitySign, void* stream) {                                     \
    return mitgcm::launch_mom<T>(table, n, nr, ny, nx, oly, olx,              \
                                 no_slip_sides, coriolis_3d, viscAhD,         \
                                 viscAhZ, sideDragFactor, rkSign,             \
                                 gravitySign, stream);                        \
  }

MITGCM_MOM_ENTRY_POINT(float, f32)
MITGCM_MOM_ENTRY_POINT(double, f64)
