// Kernels J-uv (kappa_uv) and J-ts (kappa_ts): the vertical viscosities and
// diffusivities of the step, and KPP's nonlocal flux, and their launches.
// Included by mix_glue.cu, whose entry points start them on the card, and
// by the host check of the tests, which runs them on the CPU.
//
// The kernels run only where there is arithmetic to do: viscAr alone and
// the background diffusivity alone are constant fills, which the step
// makes with torch.full (model/step.py:kappa_uv,
// model/thermodynamics.py:kappa_ts) and which the launches refuse.
//
// kappa_uv writes KappaRU and KappaRV on nr + 1 levels, every padded cell:
// viscAr (calc_viscosity.F), on the first nr levels in one of
//   mode 1, KPP (kpp_calc_visc.F; mitgcm_tpu/model/kpp.py:745-752), and
//     PP81 and MY82 alike with their viscAr as az (pp81/my82_calc_visc.F;
//     mitgcm_tpu/model/vertmix.py:165-171):
//     max(K, (K - viscAr) + (maskW * 0.5) * (az + az[i-1])), K = viscAr,
//     and likewise at v points with az[j-1] and maskS, az[i-1] and az[j-1]
//     zero at the first padded column and row (the shift's zero fill),
//     the max NaN-propagating as torch.maximum;
//   mode 2, GGL90 (ggl90_calc_visc.F; mitgcm_tpu/model/step.py:207-210):
//     K + (viscArU - viscAr).
// kappa_ts writes the tracers' interface diffusivities kapT and kapS on nr
// levels (mitgcm_tpu/model/thermodynamics.py:283, :470-505, :524-540):
// without KPP the background diffusivity + Kwz * maskInC under GM, then
// + (diffKr - diffKrS) under GGL90, PP81 or MY82 (the flag `ggl90`, the
// diffKr addend; one of the two at least; mitgcm_tpu/model/
// thermodynamics.py:501-505, :537-540); with KPP the
// nonlocal fluxes dfT and dfS (KPP_TRANSPORT_T/S;
// mitgcm_tpu/model/kpp.py:755-766), 0 at the surface,
// ((-rA * diffKz[k]) * ghat[k-1]) * (sf + qsw) * maskUp[k] below, on KPP's
// own diffKzT and diffKzS, with qsw = ((-Qsw * recip_Cp) * (1 / rhoConst))
// * (1 - frac) for theta and sfS + 0 * sfS for salt, and, under GM, kapT =
// diffKzT + Kwz * maskInC (kapS likewise; without GM the caller keeps
// diffKzT and diffKzS themselves).
//
// Bound: bytes. kappa_uv writes 2 fields of nr + 1 levels and reads 3
// (KPP: az, maskW, maskS) or 2 (GGL90: viscArU, viscArV) of nr; kappa_ts
// writes 2 and reads 1-2 fields (KPP: 4, and 2 more under GM) and a few
// 2-D ones; a few flops a cell.
// Design: one thread a padded cell (common.cuh:cell_grid), each expression
// in the twins' operation order (model/step.py:_kappa_uv_plain,
// model/thermodynamics.py:_kappa_ts_plain) with the host's constants
// rounded to T as PyTorch rounds a Python number against a tensor, so with
// --fmad=false every output is bit-equal to the twin's.
#pragma once

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct KappaUvArgs {
  // maskW, maskS [nr]; mode 1: a0 = KPP's viscAz; mode 2: a0, a1 = GGL90's
  // viscArU, viscArV [nr]; outputs [nr + 1]
  const T *maskW, *maskS, *a0, *a1;
  T *kappaRU, *kappaRV;
};
constexpr int kKappaUvNumPointers = 6;

template <typename T>
__global__ void kappa_uv_kernel(KappaUvArgs<T> a, int nr, int nyp, int nxp,
                                int mode, T viscAr) {
  GridCell c;
  if (!grid_cell_of(nyp, nxp, c)) return;
  T ku = viscAr, kv = viscAr;
  if (c.k < nr && mode == 1) {
    const T az = a.a0[c.p];
    const T azw = c.i > 0 ? a.a0[c.p - 1] : T(0);
    const T azs = c.j > 0 ? a.a0[c.p - nxp] : T(0);
    ku = max_nan(viscAr, (viscAr - viscAr) +
                             (a.maskW[c.p] * T(0.5)) * (az + azw));
    kv = max_nan(viscAr, (viscAr - viscAr) +
                             (a.maskS[c.p] * T(0.5)) * (az + azs));
  } else if (c.k < nr && mode == 2) {
    ku = viscAr + (a.a0[c.p] - viscAr);
    kv = viscAr + (a.a1[c.p] - viscAr);
  }
  a.kappaRU[c.p] = ku;
  a.kappaRV[c.p] = kv;
}

template <typename T, typename Start>
int launch_kappa_uv(const void* const* table, int n, int nr, int nyp,
                    int nxp, int mode, double viscAr, Start start) {
  KappaUvArgs<T> a;
  if (!unpack(&a, table, n, kKappaUvNumPointers) || nr < 1 || nyp < 1 ||
      nxp < 1 || mode < 1 || mode > 2 || !a.a0 ||
      (mode == 2 && !a.a1))
    return (int)cudaErrorInvalidValue;
  start(kappa_uv_kernel<T>, cell_grid(nr + 1, nyp, nxp),
        dim3(kCellX, kCellY), a, nr, nyp, nxp, mode, T(viscAr));
  return (int)cudaGetLastError();
}

template <typename T>
struct KappaTsArgs {
  // GM: Kwz [nr], maskInC; GGL90: diffKr [nr]; KPP: diffKzT, diffKzS,
  // ghat, maskUp [nr], rA, sfT, sfS, Qsw, frac
  const T *Kwz, *maskInC, *diffKr, *diffKzT, *diffKzS, *ghat, *maskUp, *rA,
      *sfT, *sfS, *Qsw, *frac;
  // outputs [nr]: kapT, kapS (with KPP only under GM), dfT, dfS (KPP)
  T *kapT, *kapS, *dfT, *dfS;
};
constexpr int kKappaTsNumPointers = 16;

template <typename T>
struct KappaTsParams {
  T diffKrT, diffKrS, recip_Cp, recip_rhoConst;
};

template <typename T>
__global__ void kappa_ts_kernel(KappaTsArgs<T> a, int nr, int nyp, int nxp,
                                int kpp, int gm, int ggl90,
                                KappaTsParams<T> s) {
  GridCell c;
  if (!grid_cell_of(nyp, nxp, c)) return;
  const size_t p = c.p, q = c.q;
  // gmredi_calc_diff.F's Kwz * maskInC, formed once for both tracers
  const T kwz = gm ? a.Kwz[p] * a.maskInC[q] : T(0);
  if (!kpp) {
    T kt = s.diffKrT, ks = s.diffKrS;
    if (gm) {
      kt = kt + kwz;
      ks = ks + kwz;
    }
    if (ggl90) {
      const T d = a.diffKr[p] - s.diffKrS;
      kt = kt + d;
      ks = ks + d;
    }
    a.kapT[p] = kt;
    a.kapS[p] = ks;
    return;
  }
  T dt = T(0), ds = T(0);
  if (c.k > 0) {
    const T qsw = ((-a.Qsw[q] * s.recip_Cp) * s.recip_rhoConst) *
                  (T(1) - a.frac[q]);
    const T ft = a.sfT[q] + qsw;
    const T sfs = a.sfS[q];
    const T fs = sfs + T(0) * sfs;
    const T mra = -a.rA[q];
    const T g = a.ghat[p - static_cast<size_t>(nyp) * nxp];
    const T up = a.maskUp[p];
    dt = (((mra * a.diffKzT[p]) * g) * ft) * up;
    ds = (((mra * a.diffKzS[p]) * g) * fs) * up;
  }
  a.dfT[p] = dt;
  a.dfS[p] = ds;
  if (gm) {
    a.kapT[p] = a.diffKzT[p] + kwz;
    a.kapS[p] = a.diffKzS[p] + kwz;
  }
}

template <typename T, typename Start>
int launch_kappa_ts(const void* const* table, int n, const double* params,
                    int np, int nr, int nyp, int nxp, int kpp, int gm,
                    int ggl90, Start start) {
  KappaTsArgs<T> a;
  if (!unpack(&a, table, n, kKappaTsNumPointers) || np != 4 || nr < 1 ||
      nyp < 1 || nxp < 1 || (kpp && ggl90) || !(kpp || gm || ggl90) ||
      (gm && !(a.Kwz && a.maskInC)) ||
      (ggl90 && !a.diffKr) || ((!kpp || gm) && !(a.kapT && a.kapS)) ||
      (kpp && !(a.diffKzT && a.diffKzS && a.ghat && a.maskUp && a.rA &&
                a.sfT && a.sfS && a.Qsw && a.frac && a.dfT && a.dfS)))
    return (int)cudaErrorInvalidValue;
  const KappaTsParams<T> s{T(params[0]), T(params[1]), T(params[2]),
                           T(params[3])};
  start(kappa_ts_kernel<T>, cell_grid(nr, nyp, nxp), dim3(kCellX, kCellY),
        a, nr, nyp, nxp, kpp, gm, ggl90, s);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
