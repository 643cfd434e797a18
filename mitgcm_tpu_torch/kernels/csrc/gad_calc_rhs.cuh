// Kernel C's argument tables, shared by the forward kernel
// (gad_calc_rhs.cu, gad_calc_rhs_tile.cuh) and its VJP
// (gad_calc_rhs_adj.cu).
#pragma once

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct GadArgs {
  // [nr, nyp, nxp]
  const T *uTrans, *vTrans, *rTrans, *xA, *yA, *maskUp, *tracer, *kappaR,
      *maskC, *recip_hFacC;
  // [nyp, nxp]
  const T *rA, *recip_dxC, *recip_dyC, *cosFacU, *recip_rA, *maskInC;
  // [nr] and [nr+1]
  const T *recip_drF, *recip_drC;
  // output [nr, nyp, nxp]
  T* gTr;
};
constexpr int kGadNumPointers = 19;

// the GM-Redi tensor of kernel C's GM branch (model/gmredi.py:GMTensor):
// Kux and Kvy [nr, nyp, nxp], or null when they are the constant isopycK
// (nonUnityDiagonal off, the launch's KuxVal/KvyVal); Kuz and Kvz null
// without GM_ExtraDiag
template <typename T>
struct GmArgs {
  const T *Kux, *Kvy, *Kwx, *Kwy, *Kuz, *Kvz, *maskW, *maskS;
};
constexpr int kGmNumPointers = 8;

}  // namespace mitgcm
