// Kernel G's mom_correction and its launch. Included by step_glue.cu, whose
// entry point starts it on the card, and by the host check of the tests,
// which runs it on the CPU.
//
// Replaces the fused elementwise pass that XLA made of
// momentum_correction_step (mitgcm_tpu/model/step.py:509-539): the new
// surface-pressure gradient of Bo_surf * etaN and
//   u = (uStar - (deltaTMom * psFac * phiSurfX) * maskW) * maskW, v likewise,
// with the non-hydrostatic flag the gradient of phi_nh added as
//   dpx = psFac * phiSurfX + (nhFac * recip_dxC) * (phi_nh - phi_nh[i-1]),
//   u = (uStar - (deltaTMom * dpx) * maskW) * maskW.
// The west and south neighbours read 0 outside the array (the shifts' zero
// fill), so every padded cell comes out as the twin's.
//
// Bound: bytes. It reads uStar, vStar, maskW and maskS (and phi_nh) and
// writes u and v once (24 B/cell in float32; 28 with phi_nh), plus four
// 2-D fields; a few flops a cell.
// Design: a thread owns V neighbouring cells of a padded row, i fastest,
// and a chunk of up to kCorrChunk levels (no level depends on another):
// the chunk is halved while the launch would have fewer than kCorrMinBlocks
// blocks, so that a small grid keeps its blocks. The thread forms the
// surface-pressure gradient of its V columns once, in registers, and then
// walks its chunk, issuing level k+1's loads before level k's stores. The
// chunk is the fastest part of the block index, so the blocks of one band
// of columns run together and share its 2-D fields in L2. V is 16 bytes of T (4 floats, 2 doubles) when nxp is
// a multiple of it and every field is 16-byte aligned (a fresh tensor of
// 1028-float rows is), else 1. Every value keeps the twin's expression and
// order (model/step.py:_mom_correction_plain), so with --fmad=false the
// outputs are bit-equal to it.
#pragma once

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct MomCorrArgs {
  // [nr, nyp, nxp]
  const T *uStar, *vStar, *maskW, *maskS, *phi_nh;
  // [nyp, nxp]
  const T *etaN, *Bo_surf, *recip_dxC, *recip_dyC;
  // outputs [nr, nyp, nxp]
  T *u, *v;
};
constexpr int kMomCorrNumPointers = 11;
constexpr int kCorrChunk = 8;          // levels a thread, at most
constexpr int kCorrMinBlocks = 1024;   // about 8 blocks an SM of an H100

// the loads of one level of a thread's cells, issued a level ahead
template <typename T, int V, bool NH>
struct CorrLevel {
  Pack<T, V> uS{}, vS{}, mW{}, mS{}, ph{}, phS{};
  T phW = T(0);
  __device__ void load(const MomCorrArgs<T>& a, size_t p, int nxp,
                       bool west, bool south) {
    uS = load_pack<T, V>(a.uStar, p);
    vS = load_pack<T, V>(a.vStar, p);
    mW = load_pack<T, V>(a.maskW, p);
    mS = load_pack<T, V>(a.maskS, p);
    if (!NH) return;
    ph = load_pack<T, V>(a.phi_nh, p);
    phW = west ? a.phi_nh[p - 1] : T(0);
    phS = south ? load_pack<T, V>(a.phi_nh, p - nxp) : Pack<T, V>{};
  }
};

template <typename T, int V, bool NH>
__global__ void __launch_bounds__(NT)
    mom_correction_kernel(MomCorrArgs<T> a, int nr, int nyp, int nxp,
                          int nbx, int chunk, int nchunks, T dtPsFac,
                          T psFac, T nhFac, T deltaTMom) {
  const int c0 = blockIdx.x % nchunks;
  const int band = blockIdx.x / nchunks;
  const int i = ((band % nbx) * BX + threadIdx.x) * V;
  const int j = (band / nbx) * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t q = static_cast<size_t>(j) * nxp + i;
  const bool west = i > 0, south = j > 0;
  // the surface-pressure gradient of the V columns
  const Pack<T, V> Bo = load_pack<T, V>(a.Bo_surf, q),
                   eta = load_pack<T, V>(a.etaN, q),
                   rdx = load_pack<T, V>(a.recip_dxC, q),
                   rdy = load_pack<T, V>(a.recip_dyC, q);
  Pack<T, V> BoS{}, etaS{};
  if (south) {
    BoS = load_pack<T, V>(a.Bo_surf, q - nxp);
    etaS = load_pack<T, V>(a.etaN, q - nxp);
  }
  T boW = west ? a.Bo_surf[q - 1] * a.etaN[q - 1] : T(0);
  T gx[V], gy[V];
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const T bo = Bo.x[c] * eta.x[c];
    const T boS = south ? BoS.x[c] * etaS.x[c] : T(0);
    gx[c] = rdx.x[c] * (bo - boW);
    gy[c] = rdy.x[c] * (bo - boS);
    boW = bo;
  }
  const int k0 = c0 * chunk;
  const int k1 = k0 + chunk < nr ? k0 + chunk : nr;
  CorrLevel<T, V, NH> cur;
  cur.load(a, k0 * P + q, nxp, west, south);
  for (int k = k0; k < k1; ++k) {
    const size_t p = k * P + q;
    CorrLevel<T, V, NH> next;
    if (k + 1 < k1) next.load(a, p + P, nxp, west, south);
    Pack<T, V> u, v;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const T mW = cur.mW.x[c], mS = cur.mS.x[c];
      if (!NH) {
        u.x[c] = (cur.uS.x[c] - (dtPsFac * gx[c]) * mW) * mW;
        v.x[c] = (cur.vS.x[c] - (dtPsFac * gy[c]) * mS) * mS;
        continue;
      }
      const T ph = cur.ph.x[c];
      const T phW = c == 0 ? cur.phW : cur.ph.x[c - 1];
      const T dpx = psFac * gx[c] + (nhFac * rdx.x[c]) * (ph - phW);
      const T dpy = psFac * gy[c] + (nhFac * rdy.x[c]) * (ph - cur.phS.x[c]);
      u.x[c] = (cur.uS.x[c] - (deltaTMom * dpx) * mW) * mW;
      v.x[c] = (cur.vS.x[c] - (deltaTMom * dpy) * mS) * mS;
    }
    store_pack<T, V>(a.u, p, u);
    store_pack<T, V>(a.v, p, v);
    cur = next;
  }
}

// Check the table, pick the width V, the chunk and the variant, and start
// the kernel with start(kernel, grid, block, args...) (OnStream on the
// card). min_blocks: kCorrMinBlocks on the card (the tests' host check
// gives 0 for the longest chunks).
template <typename T, typename Start>
int launch_mom_correction(const void* const* table, int n, int nr, int nyp,
                          int nxp, int nh, double dtPsFac, double psFac,
                          double nhFac, double deltaTMom, int min_blocks,
                          Start start) {
  static_assert(sizeof(MomCorrArgs<T>) == kMomCorrNumPointers * sizeof(void*),
                "MomCorrArgs must be a plain table of pointers");
  MomCorrArgs<T> a;
  if (!unpack(&a, table, n, kMomCorrNumPointers) || nr < 1 || nyp < 1 ||
      nxp < 1)
    return (int)cudaErrorInvalidValue;
  constexpr int kV = 16 / sizeof(T);
  const bool vec = rows_of_packs<T>(table, n, nxp);
  const int nbx = (nxp / (vec ? kV : 1) + BX - 1) / BX;
  const long long bands = static_cast<long long>(nbx) * ((nyp + BY - 1) / BY);
  int chunk = kCorrChunk;
  while (chunk > 1 && bands * ((nr + chunk - 1) / chunk) < min_blocks)
    chunk /= 2;
  const int nchunks = (nr + chunk - 1) / chunk;
  const long long blocks = bands * nchunks;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto run = [&](auto kernel) {
    start(kernel, dim3(static_cast<unsigned>(blocks)), dim3(BX, BY), a, nr,
          nyp, nxp, nbx, chunk, nchunks, T(dtPsFac), T(psFac), T(nhFac),
          T(deltaTMom));
  };
  if (vec && nh)
    run(mom_correction_kernel<T, kV, true>);
  else if (vec)
    run(mom_correction_kernel<T, kV, false>);
  else if (nh)
    run(mom_correction_kernel<T, 1, true>);
  else
    run(mom_correction_kernel<T, 1, false>);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
