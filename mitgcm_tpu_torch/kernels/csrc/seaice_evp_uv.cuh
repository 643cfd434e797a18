// Kernel H-seaice EVP's second launch, seaice_evp_uv, as a tile that
// forms each sigma12 and each drag once, and its launch. Included by
// seaice_evp.cu, whose entry point starts it on the card, and by the host
// check of the tests, which runs it on the CPU.
//
// A block owns a tile of BX x BY padded cells, one thread a cell (the
// launch covers the whole padded array: sigma12, and on the last subcycle
// dwatn and the divergence, are the JAX code's whole padded arrays, every
// shifted read zero-filled at the array's edge). In shared memory it forms
//  - the new sigma12 (seaice.py:1142-1165) once at each Z point of the
//    tile and of its north row and east column, which the divergence
//    reads (t12x at j + 1, t12y at i + 1);
//  - the drag dwatn (oceandrag, seaice.py:593) once at each C point of
//    the tile and of its south row and west column, which the forcing
//    reads (at i - 1 and j - 1);
// the ring's 80 cells by threads 0..79, a warp for each ring row. Then
// each thread writes its cell's sigma12 (and dwatn and the divergence on
// the last subcycle) and, at an interior cell, the new u and v, in the
// expressions and order of the twin (model/seaice.py:_evp_uv_plain), at
// its cell and at every halo cell that wraps to it (fill_uv), so no halo
// cell computes them again. Without the tile each thread evaluated
// sigma12 five times and the drag three times.
// One cell a thread: each cell's sigma12 and drag read 3 x 3
// neighbourhoods of several fields, which the tile's threads share through
// L1. A version with 16-byte rows of 4 cells a thread took 142-148
// registers in float32 and ran slower on an H100 (PERF.md §6).
#pragma once

#include "seaice.cuh"

namespace mitgcm {

template <typename T>
struct EvpUvArgs {
  const T *u, *v, *uNm1, *vNm1, *s12, *s1, *s2, *zeta, *alpha, *uVel0,
      *vVel0, *forcex0, *forcey0, *massC, *massU, *massV, *areaW, *areaS,
      *locMaskU, *locMaskV, *sumNorm, *fCori, *yC, *maskInW, *maskInS,
      *heffm, *maskU, *maskV, *recip_dyU, *recip_dxV, *dxV, *dyU, *dyF, *dxF,
      *recip_rAw, *recip_rAs;
  T *uo, *vo, *s12o, *dwatn, *divX, *divY;
};
constexpr int kEvpUvPointers = 42;

struct EvpUvParams {
  double revFac, recip_revFac, ecc2, evpBeta, recip_dt, starFac,
      starFacRecipDt, coswat, sinwat, dragNorth, dragSouth, dWatMin,
      dWatMinSq;
};

// the ring of the tile: sigma12's north row and east column, the drag's
// south row and west column
constexpr int kEvpRing = 2 * BX + 2 * BY;
static_assert(kEvpRing <= NT, "one thread per ring cell");

template <typename T, bool ADAPTIVE, bool REV_DEN>
__global__ void __launch_bounds__(NT) seaice_evp_uv_kernel(
    const EvpUvArgs<T> a, const EvpUvParams q, int nyp, int nxp, int ny,
    int nx, int ol, int last) {
  // sigma12 at Z points (j0 + y, i0 + x), y <= BY, x <= BX; the drag at C
  // points (j0 - 1 + y, i0 - 1 + x)
  __shared__ T s12s[BY + 1][BX + 1];
  __shared__ T dws[BY + 1][BX + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * BX + tx;
  const int i0 = blockIdx.x * BX, j0 = blockIdx.y * BY;
  const int i = i0 + tx, j = j0 + ty;
  const Fld<T> u{a.u, nyp, nxp}, v{a.v, nyp, nxp}, hm{a.heffm, nyp, nxp},
      Z{a.zeta, nyp, nxp}, A{a.alpha, nyp, nxp}, S1{a.s1, nyp, nxp},
      S2{a.s2, nyp, nxp}, u0{a.uVel0, nyp, nxp}, v0{a.vVel0, nyp, nxp};
  auto at = [&](const T* f, int jj, int ii) -> T {
    return f[static_cast<size_t>(jj) * nxp + ii];
  };
  // the new sigma12 at Z point (jj, ii) (:1142-1165), 0 outside the array
  auto s12n = [&](int jj, int ii) -> T {
    if (!in2(jj, ii, nyp, nxp)) return T(0);
    const T zetaZ = at(a.sumNorm, jj, ii) *
                    (Z(jj, ii) + Z(jj, ii - 1) + Z(jj - 1, ii) +
                     Z(jj - 1, ii - 1));
    const T shear = T(2.0) * zetaZ *
                    e12_at(u, v, hm, a.recip_dyU, a.recip_dxV, jj, ii);
    const T alphaZ = T(0.25) * (A(jj, ii) + A(jj, ii - 1) + A(jj - 1, ii) +
                                A(jj - 1, ii - 1));
    const T den12 = REV_DEN ? alphaZ : alphaZ + T(q.ecc2);
    return (at(a.s12, jj, ii) * (alphaZ - T(q.revFac)) +
            shear * T(q.recip_revFac)) / den12;
  };
  // oceandrag (seaice.py:593) of this subcycle's u, v, 0 outside the array
  auto dwatn = [&](int jj, int ii) -> T {
    if (!in2(jj, ii, nyp, nxp)) return T(0);
    auto du = [&](int y, int x) -> T {
      if (!in2(y, x, nyp, nxp)) return T(0);
      return (at(a.u, y, x) - at(a.uVel0, y, x)) * at(a.maskInW, y, x);
    };
    auto dv = [&](int y, int x) -> T {
      if (!in2(y, x, nyp, nxp)) return T(0);
      return (at(a.v, y, x) - at(a.vVel0, y, x)) * at(a.maskInS, y, x);
    };
    const T sa = du(jj, ii) + du(jj, ii + 1);
    const T sb = dv(jj, ii) + dv(jj + 1, ii);
    const T tempVar = T(0.25) * (sa * sa + sb * sb);
    const T dc = at(a.yC, jj, ii) < T(0) ? T(q.dragSouth) : T(q.dragNorth);
    const T cw = dc * dc * tempVar > T(q.dWatMinSq) ? dc * sqrt(tempVar)
                                                   : T(q.dWatMin);
    return cw * hm(jj, ii);
  };

  // the tile's sigma12 and drag, then the ring's
  s12s[ty][tx] = s12n(j, i);
  dws[ty + 1][tx + 1] = dwatn(j, i);
  if (t < BX) {
    s12s[BY][t] = s12n(j0 + BY, i0 + t);                  // north row
  } else if (t < 2 * BX) {
    const int x = t - BX;
    dws[0][x + 1] = dwatn(j0 - 1, i0 + x);               // south row
  } else if (t < 2 * BX + BY) {
    const int y = t - 2 * BX;
    s12s[y][BX] = s12n(j0 + y, i0 + BX);                 // east column
  } else if (t < kEvpRing) {
    const int y = t - 2 * BX - BY;
    dws[y + 1][0] = dwatn(j0 + y, i0 - 1);               // west column
  }
  __syncthreads();
  if (i >= nxp || j >= nyp) return;

  // the terms of the stress divergence (:1166-1174), 0 outside the array
  auto t11 = [&](int jj, int ii) -> T {
    if (!in2(jj, ii, nyp, nxp)) return T(0);
    return T(0.5) * (S1(jj, ii) + S2(jj, ii)) * at(a.dyF, jj, ii);
  };
  auto t22 = [&](int jj, int ii) -> T {
    if (!in2(jj, ii, nyp, nxp)) return T(0);
    return T(0.5) * (S1(jj, ii) - S2(jj, ii)) * at(a.dxF, jj, ii);
  };
  // the divergence at this cell from the staged sigma12 here, north and
  // east of it
  const T s12c = s12s[ty][tx];
  const T t12x_c = s12c * at(a.dxV, j, i);
  const T t12x_n = in2(j + 1, i, nyp, nxp)
                       ? s12s[ty + 1][tx] * at(a.dxV, j + 1, i) : T(0);
  const T t12y_c = s12c * at(a.dyU, j, i);
  const T t12y_e = in2(j, i + 1, nyp, nxp)
                       ? s12s[ty][tx + 1] * at(a.dyU, j, i + 1) : T(0);
  const size_t p = static_cast<size_t>(j) * nxp + i;
  const T divX = (t11(j, i) - t11(j, i - 1) + t12x_n - t12x_c) *
                 a.recip_rAw[p];
  const T divY = (t22(j, i) - t22(j - 1, i) + t12y_e - t12y_c) *
                 a.recip_rAs[p];
  const T dw = dws[ty + 1][tx + 1];
  a.s12o[p] = s12c;
  if (last) {
    a.dwatn[p] = dw;
    a.divX[p] = divX;
    a.divY[p] = divY;
  }
  if (i < ol || i >= ol + nx || j < ol || j >= ol + ny) return;

  // the new u and v at this interior cell
  const T dw_im = dws[ty + 1][tx], dw_jm = dws[ty][tx + 1];
  auto dvC = [&](int y, int x) -> T { return v0(y, x) - v(y, x); };
  auto duC = [&](int y, int x) -> T { return u0(y, x) - u(y, x); };
  auto mfv = [&](int y, int x) -> T {
    if (!in2(y, x, nyp, nxp)) return T(0);
    return at(a.massC, y, x) * at(a.fCori, y, x) * T(0.5) *
           (v(y, x) + v(y + 1, x));
  };
  auto mfu = [&](int y, int x) -> T {
    if (!in2(y, x, nyp, nxp)) return T(0);
    return at(a.massC, y, x) * at(a.fCori, y, x) * T(0.5) *
           (u(y, x) + u(y, x + 1));
  };
  const T coswat = T(q.coswat);
  const T sgn = a.fCori[p] < T(0) ? T(-1) : T(1);
  const T sgs = sgn * T(q.sinwat) * T(0.5);
  const T dwU = T(0.5) * (dw + dw_im);
  const T dwV = T(0.5) * (dw + dw_jm);
  T frcU = a.forcex0[p] +
           (dwU * coswat * a.uVel0[p] -
            sgs * (dw * T(0.5) * (dvC(j, i) + dvC(j + 1, i)) +
                   dw_im * T(0.5) * (dvC(j, i - 1) + dvC(j + 1, i - 1))) *
                a.locMaskU[p]) * a.areaW[p];
  T frcV = a.forcey0[p] +
           (dwV * coswat * a.vVel0[p] +
            sgs * (dw * T(0.5) * (duC(j, i) + duC(j, i + 1)) +
                   dw_jm * T(0.5) * (duC(j - 1, i) + duC(j - 1, i + 1))) *
                a.locMaskV[p]) * a.areaS[p];
  frcU = frcU + T(0.5) * (mfv(j, i) + mfv(j, i - 1));
  frcV = frcV - T(0.5) * (mfu(j, i) + mfu(j - 1, i));
  T betaU, betaV;
  if (ADAPTIVE) {
    betaU = T(0.5) * (A(j, i) + A(j, i - 1));
    betaV = T(0.5) * (A(j, i) + A(j - 1, i));
  } else {
    betaU = betaV = T(q.evpBeta);
  }
  const T recip_dt = T(q.recip_dt);
  const T betaFacU = betaU * recip_dt;
  const T betaFacV = betaV * recip_dt;
  const T mU = a.massU[p], mV = a.massV[p];
  T denomU = mU * (betaFacU + T(q.starFacRecipDt)) + dwU * coswat * a.areaW[p];
  T denomV = mV * (betaFacV + T(q.starFacRecipDt)) + dwV * coswat * a.areaS[p];
  if (denomU == T(0)) denomU = T(1);
  if (denomV == T(0)) denomV = T(1);
  const T un = a.maskU[p] *
               (mU * betaFacU * a.u[p] + mU * recip_dt * T(q.starFac) *
                a.uNm1[p] + frcU + divX) / denomU;
  const T vn = a.maskV[p] *
               (mV * betaFacV * a.v[p] + mV * recip_dt * T(q.starFac) *
                a.vNm1[p] + frcV + divY) / denomV;
  // at this cell and at each halo cell that wraps to it (fill_uv)
  for (int jj = j % ny; jj < nyp; jj += ny)
    for (int ii = i % nx; ii < nxp; ii += nx) {
      const size_t w = static_cast<size_t>(jj) * nxp + ii;
      a.uo[w] = un;
      a.vo[w] = vn;
    }
}

template <typename T, bool ADAPTIVE, bool REV_DEN, typename Start>
void start_evp_uv(const EvpUvArgs<T>& a, const EvpUvParams& q, int nyp,
                  int nxp, int ny, int nx, int ol, int last, Start start) {
  start(seaice_evp_uv_kernel<T, ADAPTIVE, REV_DEN>, grid2d(nyp, nxp),
        dim3(BX, BY), a, q, nyp, nxp, ny, nx, ol, last);
}

// Check the table and sizes, pick the variant and start the kernel with
// start(kernel, grid, block, args...) (OnStream on the card).
template <typename T, typename Start>
int launch_evp_uv(const void* const* table, int n, const double* params,
                  int nparams, int ny, int nx, int ol, int adaptive,
                  int rev_den, int last, Start start) {
  EvpUvArgs<T> a;
  if (!table_of<T, EvpUvArgs<T>, kEvpUvPointers>(table, n, &a) ||
      nparams != static_cast<int>(sizeof(EvpUvParams) / sizeof(double)) ||
      ny < 1 || nx < 1 || ol < 1)
    return (int)cudaErrorInvalidValue;
  EvpUvParams q;
  std::memcpy(&q, params, sizeof(q));
  const int nyp = ny + 2 * ol, nxp = nx + 2 * ol;
  if (adaptive) {
    if (rev_den)
      start_evp_uv<T, true, true>(a, q, nyp, nxp, ny, nx, ol, last, start);
    else
      start_evp_uv<T, true, false>(a, q, nyp, nxp, ny, nx, ol, last, start);
  } else if (rev_den) {
    start_evp_uv<T, false, true>(a, q, nyp, nxp, ny, nx, ol, last, start);
  } else {
    start_evp_uv<T, false, false>(a, q, nyp, nxp, ny, nx, ol, last, start);
  }
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
