// GM-Redi's kernels: gm_tensor, gm_psi_b and gm_residual_flow.
//
// Replace: mitgcm_tpu/model/gmredi.py:calc_tensor (:192-285) with the
// sigmaX and sigmaY of step.py:927-930 and _slope_limit (:90-189);
// calc_psi_b (:396-421) with _slope_psi (:347-393); residual_flow
// (:424-438). XLA fused each into a few elementwise sweeps over [nr, nyp,
// nxp] on the TPU. Kernel C's GM branch (gad_calc_rhs_tile.cuh) takes
// xy_flux and r_flux.
//
// Bound: bytes. gm_tensor reads 5 3-D fields (rhoInSitu, sigmaR, maskC,
// maskW, maskS) and writes 3 to 7 (Kwx, Kwy, Kwz; Kux, Kvy; Kuz, Kvz),
// ~130 flops a cell with sqrt (and tanh, sin) per slope; gm_psi_b reads 4
// and writes 2; gm_residual_flow reads 7 and writes 3.
// Design: one thread per padded cell (k, j, i), i fastest, every padded
// cell computed with the JAX code's zero-filled shifts, so the outputs match
// the twins on the whole array. The density gradients sigmaX and sigmaY
// are not stored: each thread recomputes them at the neighbours it needs
// (4 + 4 at the W point, 1 + 4 at U, 4 + 1 at V; their loads hit L1/L2).
// The taper scheme and nonUnityDiagonal are template parameters;
// GM_ExtraDiag's Kuz and Kvz are written where their pointers are not null.
//
// Each expression keeps the JAX code's operation order, so with
// --fmad=false every output is bit-equal to the twin of model/gmredi.py.

#include <cstring>

#include "gmredi.cuh"

namespace mitgcm {

template <typename T>
struct TensorArgs {
  // [nr, nyp, nxp]
  const T *rho, *sigmaR, *maskC, *maskW, *maskS;
  // [nyp, nxp]
  const T *recip_dxC, *recip_dyC, *fCori;
  // [nr + 1] and [nr] (ldd97's depths)
  const T *rF, *rC;
  // outputs [nr, nyp, nxp]; Kux, Kvy null without nonUnityDiagonal, Kuz,
  // Kvz null without GM_ExtraDiag
  T *Kwx, *Kwy, *Kwz, *Kux, *Kvy, *Kuz, *Kvz;
};
constexpr int kTensorPointers = 17;

template <typename T>
struct PsiArgs {
  const T *rho, *sigmaR, *maskW, *maskS;   // [nr, nyp, nxp]
  const T *recip_dxC, *recip_dyC;          // [nyp, nxp]
  T *psiX, *psiY;
};
constexpr int kPsiPointers = 8;

template <typename T>
struct FlowArgs {
  const T *psiX, *psiY, *u, *v, *w, *recip_hFacW, *recip_hFacS;  // 3-D
  const T *dyG, *dxG, *recip_rA;                                  // 2-D
  const T* recip_drF;                                             // [nr]
  T *uF, *vF, *wF;
};
constexpr int kFlowPointers = 14;

// the density and its gradients at any (k, j, i), zero outside the array
template <typename T>
struct Sigma {
  const T *rho, *sigmaR, *maskW, *maskS, *recip_dxC, *recip_dyC;
  int nr, nyp, nxp;

  __device__ bool in(int k, int j, int i) const {
    return k >= 0 && k < nr && j >= 0 && j < nyp && i >= 0 && i < nxp;
  }
  __device__ size_t i3(int k, int j, int i) const {
    return (static_cast<size_t>(k) * nyp + j) * nxp + i;
  }
  // maskW * recip_dxC * (rho - rho(i-1)), rho(-1) = 0
  __device__ T x(int k, int j, int i) const {
    if (!in(k, j, i)) return T(0);
    const size_t p = i3(k, j, i);
    const T west = i > 0 ? rho[p - 1] : T(0);
    return maskW[p] * recip_dxC[static_cast<size_t>(j) * nxp + i] *
           (rho[p] - west);
  }
  __device__ T y(int k, int j, int i) const {
    if (!in(k, j, i)) return T(0);
    const size_t p = i3(k, j, i);
    const T south = j > 0 ? rho[p - nxp] : T(0);
    return maskS[p] * recip_dyC[static_cast<size_t>(j) * nxp + i] *
           (rho[p] - south);
  }
  __device__ T r(int k, int j, int i) const {
    return in(k, j, i) ? sigmaR[i3(k, j, i)] : T(0);
  }
};

template <typename T, int S, bool NON_UNITY>
__global__ void gm_tensor_kernel(const TensorArgs<T> a, const TensorParams q,
                                 int nr, int nyp, int nxp) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const Sigma<T> sg{a.rho, a.sigmaR, a.maskW, a.maskS, a.recip_dxC,
                    a.recip_dyC, nr, nyp, nxp};
  const size_t p = sg.i3(k, j, i);
  const size_t q2 = static_cast<size_t>(j) * nxp + i;
  const T gsign = T(q.gsign), negGsign = T(-q.gsign);

  // the W interface above the cell (gmredi.py:200-245)
  const size_t plane = static_cast<size_t>(nyp) * nxp;
  const T maskFk = a.maskC[p] * (k > 0 ? a.maskC[p - plane] : T(0));
  const T dSxW = T(0.25) * (sg.x(k, j, i + 1) + sg.x(k, j, i) +
                            sg.x(k - 1, j, i + 1) + sg.x(k - 1, j, i)) *
                 maskFk;
  const T dSyW = T(0.25) * (sg.y(k, j + 1, i) + sg.y(k, j, i) +
                            sg.y(k - 1, j + 1, i) + sg.y(k - 1, j, i)) *
                 maskFk;
  T LrhoC = T(0), rDepF = T(0);
  if (S == kGmLdd97) {
    LrhoC = lrho(q, a.fCori[q2]);
    rDepF = a.rF[0] - a.rF[k];
  }
  const Slope<T> w =
      slope_limit<T, S>(q, dSxW, dSyW, gsign * a.sigmaR[p], LrhoC, rDepF);
  const bool top = k == 0;
  a.Kwx[p] = top ? T(0) : T(q.Kgm) * (negGsign * (w.sx * maskFk) * w.taper);
  a.Kwy[p] = top ? T(0) : T(q.Kgm) * (negGsign * (w.sy * maskFk) * w.taper);
  a.Kwz[p] = top ? T(0) : T(q.isoK) * ((w.ssq * maskFk) * w.taper);
  if (!NON_UNITY) return;

  // U and V points at the cell centre's depth (gmredi.py:253-283); sigmaR
  // one level down repeats the last level, and maskp1 zeroes that level
  const T maskp1 = k == nr - 1 ? T(0) : T(1);
  const int kp = k + 1 < nr ? k + 1 : nr - 1;
  T LrhoW = T(0), LrhoS = T(0), rDepC = T(0);
  if (S == kGmLdd97) {
    const T fW = i > 0 ? a.fCori[q2 - 1] : T(0);
    const T fS = j > 0 ? a.fCori[q2 - nxp] : T(0);
    LrhoW = lrho(q, T(0.5) * (a.fCori[q2] + fW));
    LrhoS = lrho(q, T(0.5) * (a.fCori[q2] + fS));
    rDepC = a.rF[0] - a.rC[k];
  }
  const T mW = a.maskW[p], mS = a.maskS[p];
  const T dSxU = sg.x(k, j, i) * mW;
  const T dSyU = T(0.25) * (sg.y(k, j + 1, i - 1) + sg.y(k, j + 1, i) +
                            sg.y(k, j, i - 1) + sg.y(k, j, i)) *
                 mW;
  const T dSrU = T(0.25) * (sg.r(k, j, i - 1) + sg.r(k, j, i) +
                            (sg.r(kp, j, i - 1) + sg.r(kp, j, i)) * maskp1) *
                 mW * gsign;
  const Slope<T> u = slope_limit<T, S>(q, dSxU, dSyU, dSrU, LrhoW, rDepC);
  const T kmin = T(q.Kmin), isoK = T(q.isoK);
  const T kux = isoK * u.taper;
  a.Kux[p] = kux < kmin ? kmin : kux;

  const T dSxV = T(0.25) * (sg.x(k, j - 1, i + 1) + sg.x(k, j, i + 1) +
                            sg.x(k, j - 1, i) + sg.x(k, j, i)) *
                 mS;
  const T dSyV = sg.y(k, j, i) * mS;
  const T dSrV = T(0.25) * (sg.r(k, j - 1, i) + sg.r(k, j, i) +
                            (sg.r(kp, j - 1, i) + sg.r(kp, j, i)) * maskp1) *
                 mS * gsign;
  const Slope<T> v = slope_limit<T, S>(q, dSxV, dSyV, dSrV, LrhoS, rDepC);
  const T kvy = isoK * v.taper;
  a.Kvy[p] = kvy < kmin ? kmin : kvy;
  if (a.Kuz) {
    const T c = T(q.negGsignIsoK);
    a.Kuz[p] = c * u.sx * u.taper;
    a.Kvz[p] = c * v.sy * v.taper;
  }
}

template <typename T, int S>
__global__ void gm_psi_b_kernel(const PsiArgs<T> a, const PsiParams q,
                                int nr, int nyp, int nxp) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const Sigma<T> sg{a.rho, a.sigmaR, a.maskW, a.maskS, a.recip_dxC,
                    a.recip_dyC, nr, nyp, nxp};
  const size_t p = sg.i3(k, j, i);
  if (k == 0) {
    a.psiX[p] = T(0);
    a.psiY[p] = T(0);
    return;
  }
  const size_t pm = p - static_cast<size_t>(nyp) * nxp;
  const T halfSign = T(q.halfSign), K = T(q.K);
  const T mWf = a.maskW[p] * a.maskW[pm];
  const T mSf = a.maskS[p] * a.maskS[pm];
  const T slopeX = T(0.5) * (sg.x(k - 1, j, i) + sg.x(k, j, i)) * mWf;
  const T dSrW = (sg.r(k, j, i - 1) + sg.r(k, j, i)) * halfSign * mWf;
  const T slopeY = T(0.5) * (sg.y(k - 1, j, i) + sg.y(k, j, i)) * mSf;
  const T dSrS = (sg.r(k, j - 1, i) + sg.r(k, j, i)) * halfSign * mSf;
  T sX, tX, sY, tY;
  slope_psi<T, S>(q, slopeX, dSrW, &sX, &tX);
  slope_psi<T, S>(q, slopeY, dSrS, &sY, &tY);
  a.psiX[p] = sX * tX * K;
  a.psiY[p] = sY * tY * K;
}

template <typename T>
__global__ void gm_residual_flow_kernel(const FlowArgs<T> a, int nr,
                                        int nyp, int nxp, T flip) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const size_t plane = static_cast<size_t>(nyp) * nxp;
  const size_t q2 = static_cast<size_t>(j) * nxp + i;
  const size_t p = k * plane + q2;
  const T rdrF = a.recip_drF[k];
  const T dPsiX = (k + 1 < nr ? a.psiX[p + plane] : T(0)) - a.psiX[p];
  const T dPsiY = (k + 1 < nr ? a.psiY[p + plane] : T(0)) - a.psiY[p];
  a.uF[p] = a.u[p] + dPsiX * rdrF * a.recip_hFacW[p] * flip;
  a.vF[p] = a.v[p] + dPsiY * rdrF * a.recip_hFacS[p] * flip;
  const T dyPsiX = a.dyG[q2] * a.psiX[p];
  const T dxPsiY = a.dxG[q2] * a.psiY[p];
  const T dyPsiXe = i + 1 < nxp ? a.dyG[q2 + 1] * a.psiX[p + 1] : T(0);
  const T dxPsiYn = j + 1 < nyp ? a.dxG[q2 + nxp] * a.psiY[p + nxp] : T(0);
  const T curl = dyPsiXe - dyPsiX + dxPsiYn - dxPsiY;
  a.wF[p] = a.w[p] + curl * a.recip_rA[q2] * flip;
}

template <typename Args, int N>
bool table_to(const void* const* table, int n, Args* a) {
  static_assert(sizeof(Args) == N * sizeof(void*),
                "the argument struct must be a plain table of pointers");
  if (n != N) return false;
  std::memcpy(a, table, sizeof(*a));
  return true;
}

template <typename Params>
bool params_to(const double* params, int n, Params* q) {
  if (n != static_cast<int>(sizeof(Params) / sizeof(double))) return false;
  std::memcpy(q, params, sizeof(*q));
  return true;
}

inline dim3 grid3d(int nr, int nyp, int nxp) {
  return dim3((nxp + BX - 1) / BX, (nyp + BY - 1) / BY, nr);
}

template <typename T, int S>
void tensor_launch(const TensorArgs<T>& a, const TensorParams& q, int nr,
                   int nyp, int nxp, bool nonUnity, cudaStream_t stream) {
  if (nonUnity)
    gm_tensor_kernel<T, S, true><<<grid3d(nr, nyp, nxp), dim3(BX, BY), 0,
                                   stream>>>(a, q, nr, nyp, nxp);
  else
    gm_tensor_kernel<T, S, false><<<grid3d(nr, nyp, nxp), dim3(BX, BY), 0,
                                    stream>>>(a, q, nr, nyp, nxp);
}

template <typename T>
int launch_gm_tensor(const void* const* table, int n, const double* params,
                     int nparams, int nr, int nyp, int nxp, int scheme,
                     int nonUnity, cudaStream_t stream) {
  TensorArgs<T> a;
  TensorParams q;
  if (!table_to<TensorArgs<T>, kTensorPointers>(table, n, &a) ||
      !params_to(params, nparams, &q) || nr < 1 || nyp < 1 || nxp < 1 ||
      !a.Kwx || !a.Kwy || !a.Kwz || (nonUnity && (!a.Kux || !a.Kvy)) ||
      (a.Kuz && !a.Kvz) || (a.Kuz && !nonUnity))
    return (int)cudaErrorInvalidValue;
  switch (scheme) {
    case kGmClip: tensor_launch<T, kGmClip>(a, q, nr, nyp, nxp, nonUnity,
                                            stream); break;
    case kGmGkw91: tensor_launch<T, kGmGkw91>(a, q, nr, nyp, nxp, nonUnity,
                                              stream); break;
    case kGmLinear: tensor_launch<T, kGmLinear>(a, q, nr, nyp, nxp,
                                                nonUnity, stream); break;
    case kGmDm95: tensor_launch<T, kGmDm95>(a, q, nr, nyp, nxp, nonUnity,
                                            stream); break;
    case kGmLdd97: tensor_launch<T, kGmLdd97>(a, q, nr, nyp, nxp, nonUnity,
                                              stream); break;
    case kGmAc02: tensor_launch<T, kGmAc02>(a, q, nr, nyp, nxp, nonUnity,
                                            stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, int S>
void psi_launch(const PsiArgs<T>& a, const PsiParams& q, int nr, int nyp,
                int nxp, cudaStream_t stream) {
  gm_psi_b_kernel<T, S><<<grid3d(nr, nyp, nxp), dim3(BX, BY), 0, stream>>>(
      a, q, nr, nyp, nxp);
}

template <typename T>
int launch_gm_psi_b(const void* const* table, int n, const double* params,
                    int nparams, int nr, int nyp, int nxp, int scheme,
                    cudaStream_t stream) {
  PsiArgs<T> a;
  PsiParams q;
  if (!table_to<PsiArgs<T>, kPsiPointers>(table, n, &a) ||
      !params_to(params, nparams, &q) || nr < 1 || nyp < 1 || nxp < 1)
    return (int)cudaErrorInvalidValue;
  switch (scheme) {
    case kGmClip: psi_launch<T, kGmClip>(a, q, nr, nyp, nxp, stream); break;
    case kGmGkw91: psi_launch<T, kGmGkw91>(a, q, nr, nyp, nxp, stream); break;
    case kGmLinear: psi_launch<T, kGmLinear>(a, q, nr, nyp, nxp, stream);
      break;
    case kGmDm95: psi_launch<T, kGmDm95>(a, q, nr, nyp, nxp, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gm_residual_flow(const void* const* table, int n, int nr, int nyp,
                            int nxp, double flip, cudaStream_t stream) {
  FlowArgs<T> a;
  if (!table_to<FlowArgs<T>, kFlowPointers>(table, n, &a) || nr < 1 ||
      nyp < 1 || nxp < 1)
    return (int)cudaErrorInvalidValue;
  gm_residual_flow_kernel<T><<<grid3d(nr, nyp, nxp), dim3(BX, BY), 0,
                               stream>>>(a, nr, nyp, nxp, T(flip));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define MITGCM_GMREDI_ENTRY_POINTS(T, SUF)                                    \
  extern "C" int mitgcm_gm_tensor_##SUF(                                      \
      const void* const* table, int n, const double* params, int nparams,     \
      int nr, int nyp, int nxp, int scheme, int nonUnity, void* stream) {     \
    return mitgcm::launch_gm_tensor<T>(table, n, params, nparams, nr, nyp,    \
                                       nxp, scheme, nonUnity,                 \
                                       (cudaStream_t)stream);                 \
  }                                                                           \
  extern "C" int mitgcm_gm_psi_b_##SUF(                                       \
      const void* const* table, int n, const double* params, int nparams,     \
      int nr, int nyp, int nxp, int scheme, void* stream) {                   \
    return mitgcm::launch_gm_psi_b<T>(table, n, params, nparams, nr, nyp,     \
                                      nxp, scheme, (cudaStream_t)stream);     \
  }                                                                           \
  extern "C" int mitgcm_gm_residual_flow_##SUF(                               \
      const void* const* table, int n, int nr, int nyp, int nxp, double flip, \
      void* stream) {                                                         \
    return mitgcm::launch_gm_residual_flow<T>(table, n, nr, nyp, nxp, flip,   \
                                              (cudaStream_t)stream);          \
  }

MITGCM_GMREDI_ENTRY_POINTS(float, f32)
MITGCM_GMREDI_ENTRY_POINTS(double, f64)
