// Kernel Q (surface_forcing): the step's surface forcing, once a step, and
// its launch. Included by forcing.cu, whose entry point starts it on the
// card, and by the host check of the tests, which runs it on the CPU.
//
// Replaces: mitgcm_tpu/model/thermodynamics.py:surface_forcing_ts
// (external_forcing_surf.F, forcing_surf_relax.F; :60-140) and
// mitgcm_tpu/model/step.py:apply_forcing_uv's surface level
// (apply_forcing.F), which XLA fused into small 2-D passes, one launch on
// [nyp, nxp] writing
//   sfT = ((0 - lamT f (theta_s - SST) drF_s hFacC_s) - (Qnet recip_Cp)
//          mass2rUnit) + (EmPmR (tRef_1 - temp_EvPrRn)) mass2rUnit,
//   sfS likewise with lamS, SSS, saltFlux mass2rUnit and
//          (convertFW2Salt - salt_EvPrRn),
//   tauU = fu mass2rUnit, tauV = fv mass2rUnit (KPP's and GGL90's surface
//          stress, written only on their paths),
//   guExt = (tauU recip_drF_1) recip_hFacW_1, gvExt likewise (the momentum
//          forcing's surface level, which kernel G adds),
// each term present only under its flag (relaxation, E-P-R), f = 1 - AREA
// under sea ice without SEAICErestoreUnderIce, else 1; _s is the surface
// level ksurf0, _1 the first.
//
// Bound: bytes, up to 15 2-D fields read and 6 written (4 without KPP and
// GGL90), a few flops.
// Design: one thread a padded cell (common.cuh:cell_grid with one level).
// Each term keeps the twin's order (model/thermodynamics.py:
// _surface_forcing_plain), Python numbers cast to the field's type as
// PyTorch casts them, so with --fmad=false every output is bit-equal.
#pragma once

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct ForcingArgs {
  // [nyp, nxp]: the surface level's theta, salt and hFacC, the relaxation
  // targets, the sea ice's AREA (null: no open-water fraction); drF and
  // recip_drF at that level and at the first (one value each)
  const T *theta, *salt, *hFacC, *SST, *SSS, *AREA, *drF;
  // [nyp, nxp]: the fluxes and the wind stress
  const T *Qnet, *saltFlux, *EmPmR, *fu, *fv;
  // the first level's recip_drF (one value), recip_hFacW and recip_hFacS
  const T *recip_drF, *recip_hFacW, *recip_hFacS;
  // outputs [nyp, nxp] (tauU and tauV null without kTau)
  T *sfT, *sfS, *tauU, *tauV, *guExt, *gvExt;
};
constexpr int kForcingNumPointers = 21;

// the Python numbers: lamT, lamS (1/tau of the relaxations), recip_Cp,
// mass2rUnit, tRef_1 - temp_EvPrRn, convertFW2Salt - salt_EvPrRn
constexpr int kForcingNumParams = 6;
// the flags: relaxation of theta and of salt, E-P-R of theta and of salt,
// the surface stress tauU/tauV written (the KPP and GGL90 paths)
constexpr int kRelaxT = 1, kRelaxS = 2, kEvPrRnT = 4, kEvPrRnS = 8,
              kTau = 16;

template <typename T>
__global__ void surface_forcing_kernel(ForcingArgs<T> a, int nyp, int nxp,
                                       int flags, T lamT, T lamS, T recipCp,
                                       T m2r, T cT, T cS) {
  GridCell c;
  if (!grid_cell_of(nyp, nxp, c)) return;
  const size_t q = c.q;
  // the open-water fraction times 1/tau: the twin's lam * openFrac
  const T open = a.AREA ? T(1) - a.AREA[q] : T(1);
  T sfT = T(0), sfS = T(0);
  if (flags & kRelaxT) {
    const T lam = a.AREA ? lamT * open : lamT;
    sfT = sfT - (((lam * (a.theta[q] - a.SST[q])) * a.drF[0]) * a.hFacC[q]);
  }
  if (flags & kRelaxS) {
    const T lam = a.AREA ? lamS * open : lamS;
    sfS = sfS - (((lam * (a.salt[q] - a.SSS[q])) * a.drF[0]) * a.hFacC[q]);
  }
  sfT = sfT - (a.Qnet[q] * recipCp) * m2r;
  sfS = sfS - a.saltFlux[q] * m2r;
  if (flags & kEvPrRnT) sfT = sfT + (a.EmPmR[q] * cT) * m2r;
  if (flags & kEvPrRnS) sfS = sfS + (a.EmPmR[q] * cS) * m2r;
  a.sfT[q] = sfT;
  a.sfS[q] = sfS;
  const T tauU = a.fu[q] * m2r, tauV = a.fv[q] * m2r;
  if (flags & kTau) {
    a.tauU[q] = tauU;
    a.tauV[q] = tauV;
  }
  a.guExt[q] = (tauU * a.recip_drF[0]) * a.recip_hFacW[q];
  a.gvExt[q] = (tauV * a.recip_drF[0]) * a.recip_hFacS[q];
}

// Start surface_forcing with start(kernel, grid, block, args...) (OnStream
// on the card). The slots of a term or an output that its flag leaves out
// may be null.
template <typename T, typename Start>
int launch_surface_forcing(const void* const* table, int n,
                           const double* params, int np, int nyp, int nxp,
                           int flags, Start start) {
  static_assert(sizeof(ForcingArgs<T>) == kForcingNumPointers * sizeof(void*),
                "ForcingArgs must be a plain table of pointers");
  ForcingArgs<T> a;
  if (!unpack(&a, table, n, kForcingNumPointers) ||
      np != kForcingNumParams || nyp < 1 || nxp < 1 || flags < 0 ||
      flags > 31 || !a.Qnet || !a.saltFlux || !a.fu || !a.fv ||
      !a.recip_drF || !a.recip_hFacW || !a.recip_hFacS || !a.sfT || !a.sfS ||
      !a.guExt || !a.gvExt || ((flags & kTau) && (!a.tauU || !a.tauV)) ||
      ((flags & kRelaxT) && (!a.theta || !a.SST)) ||
      ((flags & kRelaxS) && (!a.salt || !a.SSS)) ||
      ((flags & (kRelaxT | kRelaxS)) && (!a.drF || !a.hFacC)) ||
      ((flags & (kEvPrRnT | kEvPrRnS)) && !a.EmPmR))
    return (int)cudaErrorInvalidValue;
  start(surface_forcing_kernel<T>, cell_grid(1, nyp, nxp),
        dim3(kCellX, kCellY), a, nyp, nxp, flags, T(params[0]), T(params[1]),
        T(params[2]), T(params[3]), T(params[4]), T(params[5]));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
