// Kernel U (vertmix_calc): PP81's and MY82's Richardson-number mixing, and
// its launch. Included by vertmix.cu, whose entry points start it on the
// card, and by the host check of the tests, which runs it on the CPU.
//
// One thread walks one (j, i) column of the whole padded plane, i fastest,
// so that every level's loads and stores are coalesced. At each interface
// k >= 1 (mitgcm_tpu/model/vertmix.py:34-57): the density of the k-1 water
// and of the k water, both at level k's reference pressure (eos.cuh's
// Eos::rho, totPhiHyd's level k with use_phi), buoy = ((g mass2rUnit) *
// (rhoKm1 - rhoK)) * recip_drC[k]; the cell-centred velocity uc = 0.5 * (u
// + u[i+1]) and vc = 0.5 * (v + v[j+1]) (0 past the padded edge, the
// shift's zero fill), the shear du^2 + dv^2 with du = (uc[k-1] - uc[k]) *
// recip_drC[k]; Ri = -buoy / max(shear, 1e-10). Then
//   PP81 (:80-101): denom = 1 + PPalpha Ri (1 + PPalpha RiLimit where Ri <
//     RiLimit), visc = PPviscMax there and PPnu0 / denom^PPnRi elsewhere
//     (the power multiplied out as JAX's integer_pow does, binary powers),
//     max(visc, viscAr) and max(visc / denom, diffKrS), times maskC;
//     level 0 viscAr * maskC and diffKrS * maskC.
//   MY82 (:129-162): the stability functions SH and SM of RiFlux =
//     (btmp - sqrt(btmp^2 - 4 beta2 beta3 min(Ri, RiMax))) / (2 beta2), the
//     TKE sqrt(max(B1 (SH buoy + SM shear), 0)), the column's sums GM =
//     sum tke rF and GH = sum tke from the top (the twin sums in the same
//     order), hbl = -GM / GH * MYhblScale (0 where GH == 0), then a second
//     pass over every level: visc = (hbl (hbl tke)) SM and diff likewise
//     with SH, clipped to [viscAr, MYviscMax] and [diffKrS, MYdiffMax],
//     times maskC (level 0's TKE and stability functions 0).
// Each expression keeps the twin's operation order (model/vertmix.py:
// _vertmix_plain) with the host's constants rounded to T as PyTorch rounds
// a Python number against a tensor, IEEE division and sqrt, so with
// --fmad=false the outputs are bit-equal to the twin's.
//
// Bound: bytes. The kernel reads u, v, theta, salt and maskC (totPhiHyd
// too with use_phi; the u(i+1) and v(j+1) neighbours come from L1/L2) and
// writes viscAr and diffKr, 28-32 B a cell in float32, for ~80 operations a
// cell in PP81 (two equations of state) and ~100 in MY82. MY82's second
// pass reads each level's TKE, SH and SM back from dynamic shared memory
// (three values a level of each of a block's 32 columns, no per-thread
// array), so its levels are capped by a block's shared memory only
// (vertmix_max_nr); PP81 takes none.
#pragma once

#include "common.cuh"
#include "eos.cuh"

namespace mitgcm {

// u, v, theta, salt, totPhiHyd (read with use_phi), the pressure profile
// (nonlinear kinds), tRef and sRef (LINEAR) [nr], maskC, recip_drC and rF
// [nr + 1]; outputs viscAr, diffKr
template <typename T>
struct VertmixArgs {
  const T *u, *v, *theta, *salt, *phi, *profile, *tref, *sref, *maskC,
      *recip_drC, *rF;
  T *visc, *diff;
};
constexpr int kVertmixPointers = 13;

// the launch's doubles (model/vertmix.py:u_params): the EOS's seven
// (eos_of), gravity * mass2rUnit, viscAr, diffKrS, then the scheme's
struct VertmixParams {
  double eos[7];
  double gm2r, viscAr, diffKrS;
  // PP81: PPalpha, RiLimit, 1 + PPalpha RiLimit, PPviscMax, PPnu0;
  // MY82: RiMax, alpha1, alpha2, beta1, beta2, beta3, beta4, 4 beta2
  // beta3, 2 beta2, MYhblScale, MYviscMax, MYdiffMax, B1
  double s[13];
};
constexpr int kVertmixParams = 23;

constexpr int kUColumns = 32;
// The most levels a launch takes: MY82's three values a level of a
// block's columns within max_shared bytes.
inline int vertmix_max_nr(size_t max_shared, size_t bytes) {
  return static_cast<int>(max_shared / (3 * kUColumns * bytes));
}

// x^n as JAX's integer_pow forms it (n >= 1): binary powers, the
// accumulator multiplied by the running square
template <typename T>
__device__ __forceinline__ T ipow(T x, int n) {
  T acc = T(0);
  bool first = true;
  while (n > 0) {
    if (n & 1) {
      acc = first ? x : acc * x;
      first = false;
    }
    n >>= 1;
    if (n > 0) x = x * x;
  }
  return acc;
}

template <typename T, bool MY82>
__global__ void vertmix_calc_kernel(const VertmixArgs<T> a, const Eos<T> e,
                                    const VertmixParams q, int nr, int nyp,
                                    int nxp, int nRi) {
  constexpr int C = kUColumns;
  const int c = threadIdx.x, col = blockIdx.x * C + c;
  const int plane = nyp * nxp;
  if (col >= plane) return;
  const int j = col / nxp, i = col - j * nxp;
  const size_t P = static_cast<size_t>(plane);
  const bool hasE = i + 1 < nxp, hasN = j + 1 < nyp;
  const T gm2r = T(q.gm2r), viscAr = T(q.viscAr), diffKrS = T(q.diffKrS);
  const T eps = T(1.0e-10), half = T(0.5);
  // MY82's slots: a level's TKE, SH and SM
  T* const sT = dynamic_shared<T>() + c;
  T* const sH = sT + static_cast<size_t>(nr) * C;
  T* const sM = sH + static_cast<size_t>(nr) * C;

  // the cell-centred velocity (uc, vc) of the level at p
  struct Centred {
    T x, y;
  };
  auto centred = [&](size_t p) {
    const T ue = hasE ? a.u[p + 1] : T(0);
    const T vn = hasN ? a.v[p + nxp] : T(0);
    return Centred{half * (a.u[p] + ue), half * (a.v[p] + vn)};
  };
  Centred cprev = centred(col);
  T tprev = a.theta[col], sprev = a.salt[col];
  T GM = T(0), GH = T(0);
  if (MY82) {
    sT[0] = T(0);
    sH[0] = T(0);
    sM[0] = T(0);
  } else {
    a.visc[col] = viscAr * a.maskC[col];
    a.diff[col] = diffKrS * a.maskC[col];
  }
  for (int k = 1; k < nr; ++k) {
    const size_t p = k * P + col;
    const T phi = e.use_phi ? a.phi[p] : T(0);
    const T tk = a.theta[p], sk = a.salt[p];
    const T rhoKm1 = e.rho(tprev, sprev, k, phi);
    const T rhoK = e.rho(tk, sk, k, phi);
    const T rdrC = a.recip_drC[k];
    const Centred cur = centred(p);
    const T du = (cprev.x - cur.x) * rdrC;
    const T dv = (cprev.y - cur.y) * rdrC;
    const T shear = du * du + dv * dv;
    const T buoy = (gm2r * (rhoKm1 - rhoK)) * rdrC;
    cprev = cur;
    tprev = tk;
    sprev = sk;
    const T Ri = -buoy / max_nan(shear, eps);
    if (!MY82) {
      const bool low = Ri < T(q.s[1]);
      const T denom = low ? T(q.s[2]) : T(1) + T(q.s[0]) * Ri;
      const T viscTmp = low ? T(q.s[3]) : T(q.s[4]) / ipow(denom, nRi);
      const T visc = max_nan(viscTmp, viscAr);
      const T diff = max_nan(visc / denom, diffKrS);
      a.visc[p] = visc * a.maskC[p];
      a.diff[p] = diff * a.maskC[p];
    } else {
      const T RiTmp = min_nan(Ri, T(q.s[0]));
      const T btmp = T(q.s[3]) + T(q.s[6]) * RiTmp;
      const T RiFlux =
          (btmp - sqrt(btmp * btmp - T(q.s[7]) * RiTmp)) / T(q.s[8]);
      const T SHt = (T(q.s[1]) - T(q.s[2]) * RiFlux) / (T(1) - RiFlux);
      const T SMt = (SHt * (T(q.s[3]) - T(q.s[4]) * RiFlux)) /
                    (T(q.s[5]) - T(q.s[6]) * RiFlux);
      const T tke = sqrt(max_nan(T(q.s[12]) * (SHt * buoy + SMt * shear),
                                 T(0)));
      sT[k * C] = tke;
      sH[k * C] = SHt;
      sM[k * C] = SMt;
      GM = GM + tke * a.rF[k];
      GH = GH + tke;
    }
  }
  if (!MY82) return;
  const T hbl = GH == T(0) ? T(0) : ((-GM) / GH) * T(q.s[9]);
  const T viscMax = T(q.s[10]), diffMax = T(q.s[11]);
  for (int k = 0; k < nr; ++k) {
    const size_t p = k * P + col;
    const T tkel = hbl * sT[k * C];
    const T visc = max_nan((hbl * tkel) * sM[k * C], viscAr);
    const T diff = max_nan((hbl * tkel) * sH[k * C], diffKrS);
    a.visc[p] = min_nan(visc, viscMax) * a.maskC[p];
    a.diff[p] = min_nan(diff, diffMax) * a.maskC[p];
  }
}

// Kernel U's launch from its entry point's arguments: the table's and the
// flags' checks, the Eos, the columns a block and MY82's shared memory;
// start.shared(kernel, bytes, grid, block, args...) starts it (OnStream on
// the card), start.max_shared() is the card's limit of a block's shared
// memory.
template <typename T, typename Start>
int launch_vertmix_calc(const void* const* table, int n,
                        const double* params, int np, int nr, int nyp,
                        int nxp, int my82, int kind, int use_phi, int nRi,
                        Start start) {
  static_assert(sizeof(VertmixArgs<T>) == kVertmixPointers * sizeof(void*),
                "VertmixArgs must be a plain table of pointers");
  static_assert(sizeof(VertmixParams) == kVertmixParams * sizeof(double),
                "VertmixParams must be a plain array of doubles");
  VertmixArgs<T> a;
  if (!unpack(&a, table, n, kVertmixPointers) || np != kVertmixParams ||
      nr < 1 ||
      (my82 && nr > vertmix_max_nr(start.max_shared(), sizeof(T))) ||
      nyp < 1 || nxp < 1 || (!my82 && nRi < 1) ||
      !eos_inputs_ok(kind, use_phi, a.phi, a.profile, a.tref, a.sref) ||
      !(a.u && a.v && a.theta && a.salt && a.maskC && a.recip_drC &&
        a.rF && a.visc && a.diff))
    return (int)cudaErrorInvalidValue;
  VertmixParams q;
  std::memcpy(&q, params, sizeof(q));
  const Eos<T> e = eos_of<T>(q.eos, kind, use_phi, a.profile, a.tref,
                             a.sref);
  const long long plane = static_cast<long long>(nyp) * nxp;
  const dim3 grid(static_cast<unsigned>((plane + kUColumns - 1) /
                                        kUColumns)),
      block(kUColumns);
  if (my82)
    start.shared(vertmix_calc_kernel<T, true>,
                 3 * static_cast<size_t>(nr) * kUColumns * sizeof(T), grid,
                 block, a, e, q, nr, nyp, nxp, nRi);
  else
    start(vertmix_calc_kernel<T, false>, grid, block, a, e, q, nr, nyp, nxp,
          nRi);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
