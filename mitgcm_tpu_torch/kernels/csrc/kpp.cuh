// Kernel K's argument tables and parameters (kpp.cu), in the order the
// wrappers of mitgcm_tpu_torch/model/kpp.py fill them.
#pragma once

#include "eos.cuh"

namespace mitgcm {

// K-pre (kpp_pre): pointers
template <typename T>
struct KppPreArgs {
  // [nr, nyp, nxp]
  const T *u, *v, *theta, *salt, *phi, *maskC;
  // [nyp, nxp]
  const T *sfU, *sfV, *sfT, *sfS, *Qsw;
  // [nr]: find_rho's and find_alpha's pressure terms, tRef, sRef (LINEAR),
  // zgrid(1) - zgrid(k)
  const T *profile, *aprof, *tref, *sref, *rfac;
  // outputs [nr, nyp, nxp]: dbloc_f0(k+1) unmasked, dbloc and Ritop as
  // KPPMIX reads them, shsq(k+1) and dVsq(k) (cell-indexed)
  T *dbraw, *dbloc, *ritop, *shsq, *dvsq;
  // outputs [nyp, nxp]
  T *ustar, *bo, *bosol;
  // [nyp, nxp]: the number of wet levels of each column
  const int* kmtj;
};
constexpr int kKppPrePointers = 25;

// K-pre's scalars, in the order of model/kpp.py:kpp_pre
struct KppPreParams {
  double rhoConst, dp0, scale, gravity, rhoNil, tAlpha, sBeta, drho,
      alpha_lin, beta_lin, epsLocSq, ustar_min, recip_Cp, recip_rhoConst;
};

// K-col (kpp_col): pointers
template <typename T>
struct KppColArgs {
  // [nr, nyp, nxp], cell-indexed (K-pre's outputs and the background
  // diffusivity profiles)
  const T *dbloc, *dblocSm, *ritop, *shsq, *dvsq, *difT, *difS, *maskC;
  // [nyp, nxp]
  const T *ustar, *bo, *bosol, *fCori;
  // zgrid and hwidth [nr+2], zgrid(k)-zgrid(k+1) [nr], swfrac(hbf*zgrid(k))
  // for k = 2..nr [nr-1], -zgrid(k) + hwidth(k)/2 for k = 1..nr [nr], and
  // the wm/ws tables [nni+2, nnj+2]
  const T *zg, *hw, *dz, *worka, *sigz, *wmt, *wst;
  // outputs [nr, nyp, nxp] and [nyp, nxp]
  T *viscAz, *diffKzT, *diffKzS, *ghat, *hbl, *frac;
  const int* kmtj;
  int* kbl;
};
constexpr int kKppColPointers = 27;

// K-col's scalars (KPP_PARM01 and derived), in the order of
// model/kpp.py:kpp_col
struct KppColParams {
  double epsilon, vonk, conc1, Ricr, cekman, cmonob, phepsi, minKPPhbl,
      viscAr, difmcon, difscon, diftcon, difm0, difs0, dift0, BVSQcon,
      Riinfty, Vtc, cg, zmin, zmax, umin, deltaz, deltau, zg_nr;
};

}  // namespace mitgcm
