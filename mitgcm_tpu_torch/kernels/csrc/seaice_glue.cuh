// Kernels S1 (seaice_dynforcing) and S2 (seaice_ocean_stress): the sea
// ice's per-step glue around its dynamics, and their launches. Included by
// seaice_glue.cu, whose entry points start them on the card, and by the
// host check of the tests, which runs them on the CPU.
//
// Replaces: mitgcm_tpu/model/seaice.py's step set-up (:1989-2025) with
// get_dynforcing (:484) and evp's set-up (:1094-1112), and its ocean
// stress (ocean_stress :1301, ocean_stress_hb87 :1288-1300), the
// no-dynamics drag (oceandrag :593, :2047) and the clip of EVP's velocity
// (:2063-2066), which XLA fused into small 2-D passes:
//   S1: press0 = ((strength HEFF) exp(-cStar (1 - AREA))) HEFFM, zMax =
//       zetaMaxFac press0; taux = (cdair fu) SIMaskU, cdair the drag ratio
//       of the cell's hemisphere; massC = rhoIce HEFF, massU = (rhoIce / 2)
//       (HEFF + HEFF[i-1]) (+ the snow's under addSnowMass); forcex0 =
//       (taux / 2) (AREA + AREA[i-1]) under scaleSurfStress, else taux,
//       minus (massU recip_dxC) (phiSurf - phiSurf[i-1]) under useTilt,
//       phiSurf = Bo_surf etaN; areaW = (AREA + AREA[i-1]) / 2 under
//       scaleSurfStress, else 1, and on EVP paths locMaskU = massU != 0;
//       the v and S twins alike;
//   S2: fu' = (1 - areaW) fu + areaW fuIce, fuIce the ice-ocean drag
//       dwatn turned by the water turning angle and averaged to the u
//       point (ocean_stress), or fu' = ((1 - areaW) fu + areaW windTauX) +
//       stressDivX stressFactor (HB87), areaW = ((AREA + AREA[i-1]) / 2)
//       stressFactor; without the ice dynamics dwatn is oceandrag of the
//       cell, formed where it is read; under EVP with clipVelocities the
//       ice velocity clamped to [-0.4, 0.4], fresh.
// A neighbour beyond the array reads 0, as the shifts' zero fill does, so
// every padded cell comes out as the twin's.
//
// Bound: bytes. S1 reads up to 13 2-D fields and writes up to 13, S2 reads
// up to 17 and writes up to 4; tens of flops a cell (S1's exp).
// Design: one thread a padded cell (common.cuh:cell_grid with one level);
// the neighbours' values come from the cache. Each expression keeps the
// twin's order (model/seaice.py:SeaIce._dynforcing_plain,
// _ocean_stress_plain), Python numbers cast to the field's type as PyTorch
// casts them, so with --fmad=false every output is bit-equal.
#pragma once

#include "common.cuh"

namespace mitgcm {
namespace seaice_glue {

// the S1 flags
constexpr int kAddSnowMass = 1, kScaleSurfStress = 2, kUseTilt = 4,
              kEvp = 8;
// the S2 variants of the ocean stress and flags
constexpr int kNoStress = 0, kStress = 1, kStressHB87 = 2;
constexpr int kClip = 1, kDrag = 2;

template <typename T>
struct DynforcingArgs {
  // [nyp, nxp]: the ice state, the wind stress, the grid's fields
  const T *HEFF, *AREA, *HSNOW, *fu, *fv, *yC, *SIMaskU, *SIMaskV, *HEFFM,
      *etaN, *Bo_surf, *recip_dxC, *recip_dyC;
  // outputs [nyp, nxp] (locMaskU and locMaskV on EVP paths only)
  T *press0, *zMax, *taux, *tauy, *massC, *massU, *massV, *forcex0,
      *forcey0, *areaW, *areaS, *locMaskU, *locMaskV;
};
constexpr int kDynforcingPointers = 26;
// strength, -cStar, zetaMaxFac, the drag ratios south and north, rhoIce,
// rhoIce / 2, rhoSnow, rhoSnow / 2
constexpr int kDynforcingParams = 9;

template <typename T>
__global__ void dynforcing_kernel(DynforcingArgs<T> a, int nyp, int nxp,
                                  int flags, T strength, T mcStar,
                                  T zetaMaxFac, T cdS, T cdN, T rhoIce,
                                  T rhoIce2, T rhoSnow, T rhoSnow2) {
  GridCell c;
  if (!grid_cell_of(nyp, nxp, c)) return;
  const size_t q = c.q;
  const bool west = c.i > 0, south = c.j > 0;
  const size_t w = q - 1, s = q - nxp;
  auto at = [&](const T* f, bool in, size_t r) { return in ? f[r] : T(0); };
  const T A = a.AREA[q], H = a.HEFF[q];
  const T press0 =
      ((strength * H) * exp(mcStar * (T(1) - A))) * a.HEFFM[q];
  a.press0[q] = press0;
  a.zMax[q] = zetaMaxFac * press0;
  const T cd = a.yC[q] < T(0) ? cdS : cdN;
  const T taux = (cd * a.fu[q]) * a.SIMaskU[q];
  const T tauy = (cd * a.fv[q]) * a.SIMaskV[q];
  a.taux[q] = taux;
  a.tauy[q] = tauy;
  T massC = rhoIce * H;
  T massU = rhoIce2 * (H + at(a.HEFF, west, w));
  T massV = rhoIce2 * (H + at(a.HEFF, south, s));
  if (flags & kAddSnowMass) {
    const T S = a.HSNOW[q];
    massC = massC + rhoSnow * S;
    massU = massU + rhoSnow2 * (S + at(a.HSNOW, west, w));
    massV = massV + rhoSnow2 * (S + at(a.HSNOW, south, s));
  }
  a.massC[q] = massC;
  a.massU[q] = massU;
  a.massV[q] = massV;
  const T AW = A + at(a.AREA, west, w), AS = A + at(a.AREA, south, s);
  T fx = taux, fy = tauy;
  if (flags & kScaleSurfStress) {
    fx = (taux * T(0.5)) * AW;
    fy = (tauy * T(0.5)) * AS;
  }
  if (flags & kUseTilt) {
    const T phi = a.Bo_surf[q] * a.etaN[q];
    const T phiW = west ? a.Bo_surf[w] * a.etaN[w] : T(0);
    const T phiS = south ? a.Bo_surf[s] * a.etaN[s] : T(0);
    fx = fx - (massU * a.recip_dxC[q]) * (phi - phiW);
    fy = fy - (massV * a.recip_dyC[q]) * (phi - phiS);
  }
  a.forcex0[q] = fx;
  a.forcey0[q] = fy;
  const bool scale = flags & kScaleSurfStress;
  a.areaW[q] = scale ? T(0.5) * AW : T(1);
  a.areaS[q] = scale ? T(0.5) * AS : T(1);
  if (flags & kEvp) {
    a.locMaskU[q] = massU != T(0) ? T(1) : T(0);
    a.locMaskV[q] = massV != T(0) ? T(1) : T(0);
  }
}

template <typename T>
struct OceanStressArgs {
  // [nyp, nxp]: the ice and surface ocean velocities, the drag (null under
  // kDrag: formed here), the ice's AREA, the ocean's wind stress
  const T *uIce, *vIce, *uVel0, *vVel0, *dwatn, *fCori, *AREA, *fu, *fv;
  // HB87's wind stress over the ice and the EVP stresses' divergence
  const T *windTauX, *windTauY, *stressDivX, *stressDivY;
  // kDrag's grid fields
  const T *maskInW, *maskInS, *yC, *HEFFM;
  // outputs [nyp, nxp]: the new ocean stress, the clipped ice velocity
  T *fuOut, *fvOut, *uClip, *vClip;
};
constexpr int kOceanStressPointers = 21;
// sin and cos of the water turning angle, stressFactor, the water drag
// coefficients times rhoConst south and north, dWatMin^2, dWatMin
constexpr int kOceanStressParams = 7;

template <typename T>
struct OceanStressParams {
  T sinwat, coswat, stressFactor, dragS, dragN, dWatMin2, dWatMin;
};

// SeaIce.oceandrag at cell (j, i), 0 outside the array
template <typename T>
__device__ T drag_at(const OceanStressArgs<T>& a,
                     const OceanStressParams<T>& p, int j, int i, int nyp,
                     int nxp) {
  if (i < 0 || j < 0) return T(0);
  const size_t q = static_cast<size_t>(j) * nxp + i;
  const T du = (a.uIce[q] - a.uVel0[q]) * a.maskInW[q];
  const T dv = (a.vIce[q] - a.vVel0[q]) * a.maskInS[q];
  const T duE =
      i + 1 < nxp ? (a.uIce[q + 1] - a.uVel0[q + 1]) * a.maskInW[q + 1] : T(0);
  const T dvN = j + 1 < nyp ? (a.vIce[q + nxp] - a.vVel0[q + nxp]) *
                                  a.maskInS[q + nxp]
                            : T(0);
  const T x = du + duE, y = dv + dvN;
  const T tempVar = T(0.25) * (x * x + y * y);
  const T cd = a.yC[q] < T(0) ? p.dragS : p.dragN;
  const T cw = (cd * cd) * tempVar > p.dWatMin2 ? cd * sqrt(tempVar)
                                                : p.dWatMin;
  return cw * a.HEFFM[q];
}

// torch.clamp(v, -0.4, 0.4): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clip(T v) {
  const T lo = T(-0.40), hi = T(0.40);
  return v != v ? v : (v < lo ? lo : (v > hi ? hi : v));
}

template <typename T>
__global__ void ocean_stress_kernel(OceanStressArgs<T> a,
                                    OceanStressParams<T> p, int nyp, int nxp,
                                    int mode, int flags) {
  GridCell c;
  if (!grid_cell_of(nyp, nxp, c)) return;
  const size_t q = c.q;
  const int i = c.i, j = c.j;
  if (mode != kNoStress) {
    const T A = a.AREA[q];
    const T areaW =
        (T(0.5) * (A + (i > 0 ? a.AREA[q - 1] : T(0)))) * p.stressFactor;
    const T areaS =
        (T(0.5) * (A + (j > 0 ? a.AREA[q - nxp] : T(0)))) * p.stressFactor;
    T fuIce, fvIce;
    if (mode == kStressHB87) {
      a.fuOut[q] = ((T(1) - areaW) * a.fu[q] + areaW * a.windTauX[q]) +
                   a.stressDivX[q] * p.stressFactor;
      a.fvOut[q] = ((T(1) - areaS) * a.fv[q] + areaS * a.windTauY[q]) +
                   a.stressDivY[q] * p.stressFactor;
    } else {
      // the velocity differences at (j + dj, i + di), 0 outside the array
      auto du = [&](int dj, int di) {
        const int jj = j + dj, ii = i + di;
        if (jj < 0 || ii < 0 || jj >= nyp || ii >= nxp) return T(0);
        const size_t r = static_cast<size_t>(jj) * nxp + ii;
        return a.uIce[r] - a.uVel0[r];
      };
      auto dv = [&](int dj, int di) {
        const int jj = j + dj, ii = i + di;
        if (jj < 0 || ii < 0 || jj >= nyp || ii >= nxp) return T(0);
        const size_t r = static_cast<size_t>(jj) * nxp + ii;
        return a.vIce[r] - a.vVel0[r];
      };
      auto dw = [&](int dj, int di) {
        const int jj = j + dj, ii = i + di;
        if (flags & kDrag) return drag_at(a, p, jj, ii, nyp, nxp);
        if (jj < 0 || ii < 0) return T(0);
        return a.dwatn[static_cast<size_t>(jj) * nxp + ii];
      };
      const T sgn = a.fCori[q] < T(0) ? T(-1) : T(1);
      const T w0 = dw(0, 0), wW = dw(0, -1), wS = dw(-1, 0);
      const T du0 = du(0, 0), dv0 = dv(0, 0);
      const T turn = (sgn * p.sinwat) * T(0.5);
      fuIce = ((T(0.5) * (w0 + wW)) * p.coswat) * du0 -
              turn * ((w0 * T(0.5)) * (dv0 + dv(1, 0)) +
                      (wW * T(0.5)) * (dv(0, -1) + dv(1, -1)));
      fvIce = ((T(0.5) * (w0 + wS)) * p.coswat) * dv0 +
              turn * ((w0 * T(0.5)) * (du0 + du(0, 1)) +
                      (wS * T(0.5)) * (du(-1, 0) + du(-1, 1)));
      a.fuOut[q] = (T(1) - areaW) * a.fu[q] + areaW * fuIce;
      a.fvOut[q] = (T(1) - areaS) * a.fv[q] + areaS * fvIce;
    }
  }
  if (flags & kClip) {
    a.uClip[q] = clip(a.uIce[q]);
    a.vClip[q] = clip(a.vIce[q]);
  }
}

}  // namespace seaice_glue

// Start S1 with start(kernel, grid, block, args...) (OnStream on the card).
template <typename T, typename Start>
int launch_seaice_dynforcing(const void* const* table, int n,
                             const double* params, int np, int nyp, int nxp,
                             int flags, Start start) {
  using namespace seaice_glue;
  static_assert(sizeof(DynforcingArgs<T>) ==
                    kDynforcingPointers * sizeof(void*),
                "DynforcingArgs must be a plain table of pointers");
  DynforcingArgs<T> a;
  if (!unpack(&a, table, n, kDynforcingPointers) ||
      np != kDynforcingParams || nyp < 1 || nxp < 1 || flags < 0 ||
      flags > 15)
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < kDynforcingPointers - 2; ++t) {
    const bool snow = t == 2, tilt = t >= 9 && t <= 12;
    if (!table[t] && !(snow && !(flags & kAddSnowMass)) &&
        !(tilt && !(flags & kUseTilt)))
      return (int)cudaErrorInvalidValue;
  }
  if ((flags & kEvp) && (!a.locMaskU || !a.locMaskV))
    return (int)cudaErrorInvalidValue;
  start(dynforcing_kernel<T>, cell_grid(1, nyp, nxp), dim3(kCellX, kCellY),
        a, nyp, nxp, flags, T(params[0]), T(params[1]), T(params[2]),
        T(params[3]), T(params[4]), T(params[5]), T(params[6]), T(params[7]),
        T(params[8]));
  return (int)cudaGetLastError();
}

// Start S2 with start(kernel, grid, block, args...) (OnStream on the card):
// mode kNoStress, kStress or kStressHB87; flags kClip, kDrag (kStress
// only).
template <typename T, typename Start>
int launch_seaice_ocean_stress(const void* const* table, int n,
                               const double* params, int np, int nyp,
                               int nxp, int mode, int flags, Start start) {
  using namespace seaice_glue;
  static_assert(sizeof(OceanStressArgs<T>) ==
                    kOceanStressPointers * sizeof(void*),
                "OceanStressArgs must be a plain table of pointers");
  OceanStressArgs<T> a;
  if (!unpack(&a, table, n, kOceanStressPointers) ||
      np != kOceanStressParams || nyp < 1 || nxp < 1 || mode < kNoStress ||
      mode > kStressHB87 || flags < 0 || flags > 3 ||
      (mode == kNoStress && !(flags & kClip)) ||
      ((flags & kDrag) && mode != kStress))
    return (int)cudaErrorInvalidValue;
  const bool stress = mode != kNoStress, drag = flags & kDrag;
  if ((stress && (!a.AREA || !a.fu || !a.fv || !a.fuOut || !a.fvOut)) ||
      (mode == kStressHB87 &&
       (!a.windTauX || !a.windTauY || !a.stressDivX || !a.stressDivY)) ||
      (mode == kStress &&
       (!a.uIce || !a.vIce || !a.uVel0 || !a.vVel0 || !a.fCori ||
        (!drag && !a.dwatn) ||
        (drag && (!a.maskInW || !a.maskInS || !a.yC || !a.HEFFM)))) ||
      ((flags & kClip) && (!a.uIce || !a.vIce || !a.uClip || !a.vClip)))
    return (int)cudaErrorInvalidValue;
  const OceanStressParams<T> p{T(params[0]), T(params[1]), T(params[2]),
                               T(params[3]), T(params[4]), T(params[5]),
                               T(params[6])};
  start(ocean_stress_kernel<T>, cell_grid(1, nyp, nxp), dim3(kCellX, kCellY),
        a, p, nyp, nxp, mode, flags);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
