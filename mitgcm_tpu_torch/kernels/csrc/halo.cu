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
// Design: a row copy. Padded row j of a plane is interior row
// (j - oly) mod ny of the same plane, its columns wrapped, so the row wrap
// is taken once a row. The row's interior columns are the source row's
// same columns: where the two rows share their alignment (always for the
// interior rows of a fresh tensor; for the halo rows when a plane is a
// multiple of 16 bytes, as 1028 x 1028 floats are), they move in 16-byte
// vectors (float4 / double2), with scalar cells only at the unaligned
// ends; the 2 olx halo columns take their wrapped cells by scalar loads
// from the same source row (a true modulo, so a halo wider than the
// interior repeats it). A warp copies a chunk of a row, 4 vectors a lane
// loaded before any is stored (a 1028-float row is 2 chunks), so that a
// 2-D field has enough loads in flight too; warps walk the chunks of all
// rows of all planes (grid-stride), so one launch covers a stacked field.
// Rows that do not share their alignment (an input view whose offset is
// not a multiple of 16 bytes, or the halo rows of a plane that is not)
// copy the whole padded row in scalar cells, split evenly over the row's
// chunks, 4 loads a lane in flight. The output is a fresh tensor: the
// input's halo cells are never written, so autograd's saved input stays
// as it was.

#include <cstdint>

#include "common.cuh"

namespace mitgcm {

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

constexpr int kHaloWarps = 8;   // warps a block
constexpr int kHaloUnroll = 4;  // 16-byte loads in flight a lane

template <typename T>
__global__ void __launch_bounds__(32 * kHaloWarps)
    halo_fill_kernel(const T* __restrict__ src, T* __restrict__ dst,
                     long long rows, int chunks, int ny, int nx, int oly,
                     int olx) {
  using V = typename Vec16<T>::type;
  constexpr int kPer = sizeof(V) / sizeof(T);
  constexpr int kChunk = 32 * kHaloUnroll;   // vectors a warp's chunk
  const int nyp = ny + 2 * oly;
  const int nxp = nx + 2 * olx;
  const int lane = threadIdx.x & 31;
  const long long units = rows * chunks;
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long unit = blockIdx.x * (long long)(blockDim.x >> 5) +
                        (threadIdx.x >> 5);
       unit < units; unit += warps) {
    const long long row = unit / chunks;
    const int chunk = static_cast<int>(unit - row * chunks);
    const long long plane = row / nyp;
    const int j = static_cast<int>(row - plane * nyp);
    const T* s = src + (plane * nyp + wrap(j, oly, ny)) * nxp;
    T* d = dst + row * nxp;
    const uintptr_t sa = reinterpret_cast<uintptr_t>(s + olx);
    const uintptr_t da = reinterpret_cast<uintptr_t>(d + olx);
    if ((sa - da) % sizeof(V) != 0) {
      // rows that do not share their alignment: the padded row in scalar
      // cells, this chunk's share of its columns
      const int width = (nxp + chunks - 1) / chunks;
      const int end = min(chunk * width + width, nxp);
      for (int i0 = chunk * width + lane; i0 < end;
           i0 += 32 * kHaloUnroll) {
        T buf[kHaloUnroll];
#pragma unroll
        for (int u = 0; u < kHaloUnroll; ++u) {
          const int i = i0 + 32 * u;
          if (i < end)
            buf[u] = __ldg(s + (i >= olx && i < olx + nx ? i
                                                         : wrap(i, olx, nx)));
        }
#pragma unroll
        for (int u = 0; u < kHaloUnroll; ++u)
          if (i0 + 32 * u < end) d[i0 + 32 * u] = buf[u];
      }
      continue;
    }
    // the interior columns [olx, olx + nx): the same columns of the source
    // row, in 16-byte vectors after an unaligned head
    int head = static_cast<int>(
        ((sizeof(V) - da % sizeof(V)) % sizeof(V)) / sizeof(T));
    if (head > nx) head = nx;
    const int nvec = (nx - head) / kPer;
    const V* sv = reinterpret_cast<const V*>(s + olx + head);
    V* dv = reinterpret_cast<V*>(d + olx + head);
    V buf[kHaloUnroll];
    const int k0 = chunk * kChunk + lane;
#pragma unroll
    for (int u = 0; u < kHaloUnroll; ++u)
      if (k0 + 32 * u < nvec) buf[u] = __ldg(sv + k0 + 32 * u);
#pragma unroll
    for (int u = 0; u < kHaloUnroll; ++u)
      if (k0 + 32 * u < nvec) dv[k0 + 32 * u] = buf[u];
    if (chunk != 0) continue;
    // chunk 0's scalar cells: the unaligned head, the tail and the halo
    // columns
    const int tail = head + nvec * kPer;
    const int scalars = head + (nx - tail) + 2 * olx;
    for (int k = lane; k < scalars; k += 32) {
      int i;
      if (k < head)
        i = olx + k;
      else if (k < head + (nx - tail))
        i = olx + tail + (k - head);
      else if (k < head + (nx - tail) + olx)
        i = k - head - (nx - tail);
      else
        i = nx + k - head - (nx - tail);
      d[i] = __ldg(s + wrap(i, olx, nx));
    }
  }
}

template <typename T>
int launch_halo_fill(const void* src, void* dst, int planes, int ny, int nx,
                     int oly, int olx, void* stream) {
  if (planes < 1 || ny < 1 || nx < 1 || oly < 0 || olx < 0)
    return (int)cudaErrorInvalidValue;
  // a warp a chunk of 32 x kHaloUnroll vectors of an output row
  const long long rows = static_cast<long long>(planes) * (ny + 2 * oly);
  const int per = static_cast<int>(16 / sizeof(T)) * 32 * kHaloUnroll;
  const int chunks = (nx + per - 1) / per;
  const long long blocks = (rows * chunks + kHaloWarps - 1) / kHaloWarps;
  const int grid = blocks < (1 << 30) ? (int)blocks : (1 << 30);
  halo_fill_kernel<T><<<grid, 32 * kHaloWarps, 0, (cudaStream_t)stream>>>(
      (const T*)src, (T*)dst, rows, chunks, ny, nx, oly, olx);
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
