// Kernel M: direction-split multi-dimensional advection of one tracer with
// the non-linear schemes 30 (DST-3), 33 (DST-3 flux-limited) and 77 (the
// Superbee flux limiter).
//
// Replaces: mitgcm_tpu/model/gad.py:multidim_advection (:1120-1154,
// Cartesian branch) with the fluxes of adv_flux_x / adv_flux_y (:839-908),
// _adv_flux_highorder (:783-836), _limiter (:85) and adv_flux_r
// (:911-1022), which XLA fused into one pass per direction over the padded
// [nr, nyp, nxp] arrays on the TPU.
//
// Three launches per tracer, one per sweep, each one thread per cell of
// the whole padded array:
//   gad_multidim_x  localX = T - dt/V ((F(i+1) - F(i)) - T (U(i+1) - U(i)))
//   gad_multidim_y  localY from localX with the meridional fluxes
//   gad_multidim_r  the vertical fluxes of localY, then
//                   gTr = (localT - T) / dt
// where T is the tracer (the compensation term always uses it), F the
// scheme's flux at a face, U the transport, and V/dt the cell's volume
// factors (recip_hFacC recip_drF recip_rA, masked by maskInC).
//
// Bound: bytes. Per sweep a cell reads its input field, the tracer, one
// transport and one velocity, recip_hFacC and a face mask (~7 fields,
// masks counted) and writes one, ~28-32 B/cell in float32 for ~80 flops;
// the neighbours of the stencil (i-2 .. i+2) hit L1/L2.
// Design: each thread computes both face fluxes of its cell itself, in the
// JAX code's operation order: sharing a flux between threads would need a
// second pass or shared memory, and the plain twin computes every flux
// once per face, so recomputing it gives the same bits. Like the JAX code
// (ops/stencil.py: zero-filled shifts), every cell of the padded array is
// computed and a neighbour outside the array reads 0, a face flux outside
// it is 0; so the Y sweep reads in the halo rows exactly the values of the
// X sweep that the JAX code reads there. The vertical neighbours are
// clamped at the column ends (km1 = max(1, k-1) ...), and the surface flux
// is 0. Built with --fmad=false the result is bit-equal to the plain twin
// (model/gad.py:_multidim_plain); the discrete choices (the limiter's
// clips, DST3-FL's overflow guard |Rj| 1e20 <= |R| and its sign, the clip
// of psi to [0, 1]) are the twin's.

#include <cstring>

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct MdArgs {
  // [nr, nyp, nxp]
  const T *uTrans, *vTrans, *rTrans, *uVel, *vVel, *wVel, *tracer, *maskW,
      *maskS, *maskC, *recip_hFacC;
  // [nyp, nxp]
  const T *recip_dxC, *recip_dyC, *recip_rA, *maskInC, *maskInW, *maskInS;
  // [nr], [nr+1]
  const T *recip_drF, *recip_drC;
};
constexpr int kMdPointers = 19;

constexpr int kDst3 = 30, kDst3FluxLimit = 33, kFluxLimit = 77;

// torch.minimum / maximum (a NaN in either gives NaN)
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// the Superbee limiter of the slope ratio, with its overflow guard
// (gad.py:791-797)
template <typename T>
__device__ __forceinline__ T superbee(T Rj, T crRaw) {
  const T crMax = T(1.0e6);
  T cr;
  if (fabs(Rj) * crMax <= fabs(crRaw)) {
    cr = (crRaw >= T(0) ? crMax : -crMax) * (Rj >= T(0) ? T(1) : T(-1));
  } else {
    cr = crRaw / (Rj == T(0) ? T(1) : Rj);
  }
  return nmax(nmax(nmin(T(2.0) * cr, T(1)), nmin(cr, T(2.0))), T(0));
}

// DST-3 flux-limited weight psi for the ratio theta = R / Rj (gad.py:818-833)
template <typename T>
__device__ __forceinline__ T dst3fl_psi(T Rj, T R, T cfl, T d0, T d1) {
  const T thetaMax = T(1.0e20);
  T theta;
  if (fabs(Rj) * thetaMax <= fabs(R)) {
    theta = R * Rj >= T(0) ? thetaMax : -thetaMax;
  } else {
    theta = R / (Rj == T(0) ? T(1) : Rj);
  }
  const T psi = d0 + d1 * theta;
  return nmax(nmin(nmin(psi, T(1)), theta * (T(1) - cfl) / (cfl + T(1.0e-20))),
              T(0));
}

// the horizontal flux at a face (gad.py:_adv_flux_highorder): trans the
// transport, cfl its Courant number, t and tm1 the tracer on either side,
// Rjp / Rj / Rjm the masked differences across the faces up to one cell away
template <typename T>
__device__ T flux_h(int scheme, T trans, T cfl, T t, T tm1, T Rjp, T Rj,
                    T Rjm) {
  const T absT = fabs(trans);
  if (scheme == kFluxLimit) {
    const T lim = superbee(Rj, trans > T(0) ? Rjm : Rjp);
    return trans * (t + tm1) * T(0.5) -
           absT * ((T(1) - lim) + cfl * lim) * Rj * T(0.5);
  }
  const T sixth = T(1.0 / 6.0);
  const T d0 = (T(2.0) - cfl) * (T(1) - cfl) * sixth;
  const T d1 = (T(1) - cfl * cfl) * sixth;
  if (scheme == kDst3)
    return T(0.5) * (trans + absT) * (tm1 + (d0 * Rj + d1 * Rjm)) +
           T(0.5) * (trans - absT) * (t - (d0 * Rj + d1 * Rjp));
  const T psiP = dst3fl_psi(Rj, Rjm, cfl, d0, d1);
  const T psiM = dst3fl_psi(Rj, Rjp, cfl, d0, d1);
  return T(0.5) * (trans + absT) * (tm1 + psiP * Rj) +
         T(0.5) * (trans - absT) * (t - psiM * Rj);
}

template <typename T>
struct MdCell {
  const MdArgs<T>& a;
  const T* src;
  int nr, nyp, nxp;
  T deltaT;

  __device__ size_t i3(int k, int j, int i) const {
    return (static_cast<size_t>(k) * nyp + j) * nxp + i;
  }
  // src at (k, j, i), 0 outside the padded array (a zero-filled shift)
  __device__ T s(int k, int j, int i) const {
    return (i < 0 || i >= nxp || j < 0 || j >= nyp) ? T(0) : src[i3(k, j, i)];
  }
  // the face masks maskW * maskInW and maskS * maskInS
  __device__ T mW(int k, int j, int i) const {
    if (i < 0 || i >= nxp) return T(0);
    return a.maskW[i3(k, j, i)] * a.maskInW[static_cast<size_t>(j) * nxp + i];
  }
  __device__ T mS(int k, int j, int i) const {
    if (j < 0 || j >= nyp) return T(0);
    return a.maskS[i3(k, j, i)] * a.maskInS[static_cast<size_t>(j) * nxp + i];
  }
  // the zonal flux at the west face of (k, j, i) (gad.py:adv_flux_x); 0 for
  // a face outside the array
  __device__ T fx(int scheme, int k, int j, int i) const {
    if (i >= nxp) return T(0);
    const size_t p = i3(k, j, i);
    const T t = s(k, j, i), tm1 = s(k, j, i - 1);
    const T Rjp = (s(k, j, i + 1) - t) * mW(k, j, i + 1);
    const T Rj = (t - tm1) * mW(k, j, i);
    const T Rjm = (tm1 - s(k, j, i - 2)) * mW(k, j, i - 1);
    const T cfl =
        fabs(a.uVel[p] * deltaT * a.recip_dxC[static_cast<size_t>(j) * nxp + i]);
    return flux_h(scheme, a.uTrans[p], cfl, t, tm1, Rjp, Rj, Rjm);
  }
  // the meridional flux at the south face (gad.py:adv_flux_y)
  __device__ T fy(int scheme, int k, int j, int i) const {
    if (j >= nyp) return T(0);
    const size_t p = i3(k, j, i);
    const T t = s(k, j, i), tm1 = s(k, j - 1, i);
    const T Rjp = (s(k, j + 1, i) - t) * mS(k, j + 1, i);
    const T Rj = (t - tm1) * mS(k, j, i);
    const T Rjm = (tm1 - s(k, j - 2, i)) * mS(k, j - 1, i);
    const T cfl =
        fabs(a.vVel[p] * deltaT * a.recip_dyC[static_cast<size_t>(j) * nxp + i]);
    return flux_h(scheme, a.vTrans[p], cfl, t, tm1, Rjp, Rj, Rjm);
  }
  // the vertical flux at interface k, the top of cell k (gad.py:adv_flux_r):
  // 0 at the surface and below the bottom; neighbours clamped to the column
  __device__ T fr(int scheme, int k, int j, int i) const {
    if (k == 0 || k >= nr) return T(0);
    const int km1 = k - 1, km2 = k > 1 ? k - 2 : 0;
    const int kp1 = k + 1 < nr ? k + 1 : nr - 1;
    const T t = src[i3(k, j, i)], tkm1 = src[i3(km1, j, i)];
    const T tkm2 = src[i3(km2, j, i)], tkp1 = src[i3(kp1, j, i)];
    const T mC = a.maskC[i3(k, j, i)], mkm1 = a.maskC[i3(km1, j, i)];
    const T mkm2 = a.maskC[i3(km2, j, i)], mkp1 = a.maskC[i3(kp1, j, i)];
    const size_t p = i3(k, j, i);
    const T rT = a.rTrans[p], absT = fabs(rT);
    const T wCFL = fabs(a.wVel[p] * deltaT * a.recip_drC[k]);
    if (scheme == kFluxLimit) {
      const T Rjp = (tkp1 - t) * mkp1;
      const T Rj = t - tkm1;
      const T Rjm = (tkm1 - tkm2) * mkm2;
      const T lim = superbee(Rj, rT < T(0) ? Rjm : Rjp);
      return mkm1 * (rT * (t + tkm1) * T(0.5) +
                     absT * ((T(1) - lim) + wCFL * lim) * Rj * T(0.5));
    }
    const T Rjp = (t - tkp1) * mkp1;
    const T Rj = (tkm1 - t) * mC * mkm1;
    const T Rjm = (tkm2 - tkm1) * mkm1;
    const T sixth = T(1.0 / 6.0);
    const T d0 = (T(2.0) - wCFL) * (T(1) - wCFL) * sixth;
    const T d1 = (T(1) - wCFL * wCFL) * sixth;
    if (scheme == kDst3)
      return T(0.5) * (rT + absT) * (t + (d0 * Rj + d1 * Rjp)) +
             T(0.5) * (rT - absT) * (tkm1 - (d0 * Rj + d1 * Rjm));
    const T psiP = dst3fl_psi(Rj, Rjm, wCFL, d0, d1);
    const T psiM = dst3fl_psi(Rj, Rjp, wCFL, d0, d1);
    return T(0.5) * (rT + absT) * (t + psiM * Rj) +
           T(0.5) * (rT - absT) * (tkm1 - psiP * Rj);
  }
};

// dir 0: X, 1: Y, 2: R
template <typename T>
__global__ void multidim_kernel(const MdArgs<T> a, const T* __restrict__ src,
                                T* __restrict__ dst, int dir, int nr, int nyp,
                                int nxp, int scheme, T deltaT, T rkSign) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const MdCell<T> c{a, src, nr, nyp, nxp, deltaT};
  const size_t p = c.i3(k, j, i);
  const size_t q = static_cast<size_t>(j) * nxp + i;
  const T tr = a.tracer[p];
  const T vol = deltaT * a.recip_hFacC[p] * a.recip_drF[k] * a.recip_rA[q];
  const T mIn = a.maskInC[q];
  if (dir == 0) {
    const T uE = i + 1 < nxp ? a.uTrans[p + 1] : T(0);
    dst[p] = src[p] - vol * ((c.fx(scheme, k, j, i + 1) -
                              c.fx(scheme, k, j, i)) -
                             tr * (uE - a.uTrans[p])) * mIn;
  } else if (dir == 1) {
    const T vN = j + 1 < nyp ? a.vTrans[p + nxp] : T(0);
    dst[p] = src[p] - vol * ((c.fy(scheme, k, j + 1, i) -
                              c.fy(scheme, k, j, i)) -
                             tr * (vN - a.vTrans[p])) * mIn;
  } else {
    const size_t P = static_cast<size_t>(nyp) * nxp;
    const T rKp = k + 1 < nr ? a.rTrans[p + P] : T(0);
    const T localT =
        src[p] - vol * ((c.fr(scheme, k + 1, j, i) - c.fr(scheme, k, j, i)) -
                        tr * (rKp - a.rTrans[p])) * rkSign * mIn;
    dst[p] = (localT - tr) / deltaT;
  }
}

template <typename T>
int launch_multidim(int dir, const void* const* table, int n, const void* src,
                    void* dst, int nr, int nyp, int nxp, int scheme,
                    double deltaT, double rkSign, void* stream) {
  static_assert(sizeof(MdArgs<T>) == kMdPointers * sizeof(void*),
                "MdArgs must be a plain table of pointers");
  if (n != kMdPointers ||
      (scheme != kDst3 && scheme != kDst3FluxLimit && scheme != kFluxLimit))
    return (int)cudaErrorInvalidValue;
  MdArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  const dim3 g((nxp + BX - 1) / BX, (nyp + BY - 1) / BY, nr);
  multidim_kernel<T><<<g, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      a, (const T*)src, (T*)dst, dir, nr, nyp, nxp, scheme, T(deltaT),
      T(rkSign));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define MITGCM_MD_ENTRY(NAME, DIR, SUF, T)                                     \
  extern "C" int mitgcm_gad_multidim_##NAME##_##SUF(                           \
      const void* const* table, int n, const void* src, void* dst, int nr,   \
      int nyp, int nxp, int scheme, double deltaT, double rkSign,             \
      void* stream) {                                                          \
    return mitgcm::launch_multidim<T>(DIR, table, n, src, dst, nr, nyp, nxp,  \
                                      scheme, deltaT, rkSign, stream);        \
  }

MITGCM_MD_ENTRY(x, 0, f32, float)
MITGCM_MD_ENTRY(x, 0, f64, double)
MITGCM_MD_ENTRY(y, 1, f32, float)
MITGCM_MD_ENTRY(y, 1, f64, double)
MITGCM_MD_ENTRY(r, 2, f32, float)
MITGCM_MD_ENTRY(r, 2, f64, double)
