// Kernel F: the single-device halo wrap.
//
// Replaces: mitgcm_tpu/ops/stencil.py:cyclic_fill_halo (:54-69), the
// modular gather that XLA fused into a copy of each field: every padded
// cell takes the interior cell at ((j - oly) mod ny, (i - olx) mod nx). A
// step makes 12 to 24 such fills (the prognostic fields, u* and v*, the
// solvers' results, the sea ice's fields), on 3-D fields and on 2-D ones.
//
// Bound: bytes. A fill reads each interior cell once and writes every
// padded cell once (8 B/cell in float32); it does no arithmetic.
// Design: an out-of-place copy, one thread per padded cell (j, i) and per
// group of planes (i fastest, so a warp writes 32 neighbouring cells of one
// row and reads 32 neighbouring cells of the interior row it wraps to).
// The source index is wrapped once with a true modulo (common.cuh:wrap), so
// a halo wider than the interior repeats it as the gather does, and then
// serves up to kPlanesPerThread planes of a stacked field, whose loads are
// independent and stay in flight together. The output is a fresh tensor:
// the input's halo cells are never written, so autograd's saved input
// stays as it was.

#include "common.cuh"

namespace mitgcm {

constexpr int kPlanesPerThread = 4;

template <typename T>
__global__ void halo_fill_kernel(const T* __restrict__ src,
                                 T* __restrict__ dst, int planes, int ny,
                                 int nx, int oly, int olx) {
  const int nyp = ny + 2 * oly;
  const int nxp = nx + 2 * olx;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t plane = static_cast<size_t>(nyp) * nxp;
  const size_t from = static_cast<size_t>(wrap(j, oly, ny)) * nxp +
                      wrap(i, olx, nx);
  const size_t to = static_cast<size_t>(j) * nxp + i;
#pragma unroll 4
  for (int p = blockIdx.z; p < planes; p += gridDim.z)
    dst[p * plane + to] = src[p * plane + from];
}

template <typename T>
int launch_halo_fill(const void* src, void* dst, int planes, int ny, int nx,
                     int oly, int olx, void* stream) {
  if (planes < 1 || ny < 1 || nx < 1 || oly < 0 || olx < 0)
    return (int)cudaErrorInvalidValue;
  dim3 g = grid2d(ny + 2 * oly, nx + 2 * olx);
  const int groups = (planes + kPlanesPerThread - 1) / kPlanesPerThread;
  g.z = groups < 65535 ? groups : 65535;
  halo_fill_kernel<T><<<g, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      (const T*)src, (T*)dst, planes, ny, nx, oly, olx);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define MITGCM_HALO_FILL_ENTRY_POINT(T, SUF)                                  \
  extern "C" int mitgcm_halo_fill_##SUF(const void* src, void* dst,          \
                                        int planes, int ny, int nx, int oly,  \
                                        int olx, void* stream) {              \
    return mitgcm::launch_halo_fill<T>(src, dst, planes, ny, nx, oly, olx,    \
                                       stream);                               \
  }

MITGCM_HALO_FILL_ENTRY_POINT(float, f32)
MITGCM_HALO_FILL_ENTRY_POINT(double, f64)
