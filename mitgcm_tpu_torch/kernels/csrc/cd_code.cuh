// Kernel CD: the CD scheme's D-grid step and the predictors it gives, and
// its launch. Included by cd_code.cu, whose entry points start it on the
// card, and by the host check of the tests, which runs it on the CPU.
//
// Replaces the fused elementwise passes that XLA made of
// mitgcm_tpu/model/cd_code.py:cd_scheme (:30-83) with the step's
// use of it (mitgcm_tpu/model/step.py:269-277 and :317-318):
//   pf = Bo_surf (ab15 etaN + ab05 etaNm1);
//   afV = (gV_ab - recip_dyC (pf - pf[j-1])) maskS maskInC[j-1] maskInC,
//   vVelD' = (rCD (vVelD + dt (avg4(afV) maskW - fW (ab15 u + ab05 uNM1)))
//             + (1 - rCD) (ab15 avg4(v) + ab05 avg4(vNM1))) maskW,
//   and uVelD' alike at V points; guCor = fW vVelD', gvCor = -fS uVelD';
//   uStar = u + dt (gU_ab + guCor) maskW, vStar alike.
// The averages avg4 are over the four U (V) points around a V (U) point;
// gU_ab and gV_ab are kernel G's AB-extrapolated tendencies (its CD
// variant writes them in place of the predictors). The staggered time
// step's hydrostatic term (phxFac) is 0: the port refuses staggerTimeStep.
//
// Bound: bytes. Per cell it reads 10 3-D fields (gU_ab, gV_ab, u, v, uNM1,
// vNM1, uVelD, vVelD, maskW, maskS) and 7 2-D ones and writes 4 3-D
// fields: 56 B/cell in float32, for about 80 flops.
// Design: one thread per padded cell (k, j, i), i fastest; each thread
// forms afV and afU at the four points that its averages take (the 2-D
// fields and the neighbours' values come from the caches). A neighbour
// outside the padded array reads 0, as the twins' shifts fill. Each
// expression keeps the twin's operation order (model/cd_code.py:
// cd_scheme_plain), so with --fmad=false the outputs are bit-equal on
// every padded cell.
#pragma once

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct CdArgs {
  // [nr, nyp, nxp]: kernel G's AB-extrapolated tendencies, the
  // start-of-step velocities, the last step's, the D-grid velocities (uVelD
  // at V points, vVelD at U points), the masks
  const T *gU, *gV, *u, *v, *uNM1, *vNM1, *uVelD, *vVelD, *maskW, *maskS;
  // [nyp, nxp]: the free surface now and before the last solve, the grid
  const T *etaN, *etaNm1, *Bo_surf, *fCori, *recip_dxC, *recip_dyC,
      *maskInC;
  // outputs [nr, nyp, nxp]: the predictors and the new D-grid velocities
  T *uStar, *vStar, *uVelDNew, *vVelDNew;
};
constexpr int kCdNumPointers = 21;

// ab15, ab05 (the D-grid step's AB weights), rCD, 1 - rCD, deltaTMom
struct CdParams {
  double ab15, ab05, rCD, rCD1, deltaTMom;
};
constexpr int kCdNumParams = 5;

template <typename T>
__global__ void cd_scheme_kernel(CdArgs<T> a, int nyp, int nxp,
                                 CdParams c) {
  GridCell g;
  if (!grid_cell_of(nyp, nxp, g)) return;
  const int j = g.j, i = g.i;
  const size_t lev = g.p - g.q;
  const T ab15 = T(c.ab15), ab05 = T(c.ab05), rCD = T(c.rCD),
          rCD1 = T(c.rCD1), dt = T(c.deltaTMom);
  auto in = [&](int jj, int ii) {
    return jj >= 0 && jj < nyp && ii >= 0 && ii < nxp;
  };
  // a field's value at (jj, ii) of this level (3-D) or plane (2-D), 0
  // outside the array
  auto at3 = [&](const T* f, int jj, int ii) -> T {
    return in(jj, ii) ? f[lev + static_cast<size_t>(jj) * nxp + ii] : T(0);
  };
  auto at2 = [&](const T* f, int jj, int ii) -> T {
    return in(jj, ii) ? f[static_cast<size_t>(jj) * nxp + ii] : T(0);
  };
  auto pf = [&](int jj, int ii) -> T {
    if (!in(jj, ii)) return T(0);
    const size_t q = static_cast<size_t>(jj) * nxp + ii;
    return a.Bo_surf[q] * (ab15 * a.etaN[q] + ab05 * a.etaNm1[q]);
  };
  auto afV = [&](int jj, int ii) -> T {
    if (!in(jj, ii)) return T(0);
    const size_t q = static_cast<size_t>(jj) * nxp + ii;
    return (a.gV[lev + q] - a.recip_dyC[q] * (pf(jj, ii) - pf(jj - 1, ii))) *
           a.maskS[lev + q] * at2(a.maskInC, jj - 1, ii) * a.maskInC[q];
  };
  auto afU = [&](int jj, int ii) -> T {
    if (!in(jj, ii)) return T(0);
    const size_t q = static_cast<size_t>(jj) * nxp + ii;
    return (a.gU[lev + q] - a.recip_dxC[q] * (pf(jj, ii) - pf(jj, ii - 1))) *
           a.maskW[lev + q] * at2(a.maskInC, jj, ii - 1) * a.maskInC[q];
  };
  // the averages at a U point of a field at V points, and at a V point of
  // a field at U points
  auto avgW = [&](const T* f) -> T {
    return T(0.25) * ((at3(f, j, i) + at3(f, j + 1, i - 1)) +
                      (at3(f, j, i - 1) + at3(f, j + 1, i)));
  };
  auto avgS = [&](const T* f) -> T {
    return T(0.25) * ((at3(f, j, i) + at3(f, j - 1, i + 1)) +
                      (at3(f, j - 1, i) + at3(f, j, i + 1)));
  };
  const size_t q = g.q, p = g.p;
  const T fC = a.fCori[q];
  const T fW = T(0.5) * (fC + at2(a.fCori, j, i - 1));
  const T fS = T(0.5) * (fC + at2(a.fCori, j - 1, i));
  const T mW = a.maskW[p], mS = a.maskS[p];
  const T u = a.u[p], v = a.v[p];

  // vVelD (at U points)
  const T vfW = T(0.25) * ((afV(j, i) + afV(j + 1, i - 1)) +
                           (afV(j, i - 1) + afV(j + 1, i))) * mW -
                fW * (ab15 * u + ab05 * a.uNM1[p]);
  T vD = a.vVelD[p] + dt * vfW;
  vD = (rCD * vD + rCD1 * (ab15 * avgW(a.v) + ab05 * avgW(a.vNM1))) * mW;
  const T guCor = fW * vD;

  // uVelD (at V points)
  const T vfS = T(0.25) * ((afU(j, i) + afU(j - 1, i + 1)) +
                           (afU(j, i + 1) + afU(j - 1, i))) * mS +
                fS * (ab15 * v + ab05 * a.vNM1[p]);
  T uD = a.uVelD[p] + dt * vfS;
  uD = (rCD * uD + rCD1 * (ab15 * avgS(a.u) + ab05 * avgS(a.uNM1))) * mS;
  const T gvCor = -fS * uD;

  a.vVelDNew[p] = vD;
  a.uVelDNew[p] = uD;
  a.uStar[p] = u + dt * (a.gU[p] + guCor) * mW;
  a.vStar[p] = v + dt * (a.gV[p] + gvCor) * mS;
}

// Kernel CD's launch from its entry point's arguments: the table's and the
// parameters' checks and the grid; start(kernel, grid, block, args...)
// starts it (OnStream on the card).
template <typename T, typename Start>
int launch_cd_scheme(const void* const* table, int n, const double* params,
                     int np, int nr, int nyp, int nxp, Start start) {
  static_assert(sizeof(CdArgs<T>) == kCdNumPointers * sizeof(void*),
                "CdArgs must be a plain table of pointers");
  static_assert(sizeof(CdParams) == kCdNumParams * sizeof(double),
                "CdParams must be a plain array of doubles");
  CdArgs<T> a;
  if (!unpack(&a, table, n, kCdNumPointers) || np != kCdNumParams ||
      nr < 1 || nr > 65535 || nyp < 1 || nxp < 1)
    return (int)cudaErrorInvalidValue;
  const void* const* ptrs = table;
  for (int t = 0; t < kCdNumPointers; ++t)
    if (ptrs[t] == nullptr) return (int)cudaErrorInvalidValue;
  CdParams c;
  std::memcpy(&c, params, sizeof(c));
  start(cd_scheme_kernel<T>, cell_grid(nr, nyp, nxp), dim3(kCellX, kCellY),
        a, nyp, nxp, c);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
