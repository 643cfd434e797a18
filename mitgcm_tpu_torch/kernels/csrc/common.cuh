// Shared helpers for the port's kernels: launch shape, pointer tables,
// halo wrap, a deterministic two-stage reduction and the start of a launch.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace mitgcm {

// 2-D blocks of 32 x 8 threads: i (x) fastest, so a warp reads 32
// neighbouring doubles or floats of one row.
constexpr int BX = 32;
constexpr int BY = 8;
constexpr int NT = BX * BY;

inline dim3 grid2d(int ny, int nx) {
  return dim3((nx + BX - 1) / BX, (ny + BY - 1) / BY, 1);
}

// Launches over every padded cell of `levels` planes of nyp x nxp cells:
// blocks of kCellX x kCellY threads, i fastest, the level the fastest
// block index, so that the blocks of one tile at neighbouring levels run
// together (a level's neighbour comes from the cache).
constexpr int kCellX = 32;
constexpr int kCellY = 8;

inline dim3 cell_grid(int levels, int nyp, int nxp) {
  return dim3(static_cast<unsigned>(levels),
              static_cast<unsigned>((nxp + kCellX - 1) / kCellX),
              static_cast<unsigned>((nyp + kCellY - 1) / kCellY));
}

// The cell of this thread in a cell_grid launch: level k, row j, column i,
// its 2-D index q and 3-D index p; false past the plane's edge.
struct GridCell {
  int k, j, i;
  size_t q, p;
};

__device__ __forceinline__ bool grid_cell_of(int nyp, int nxp, GridCell& c) {
  c.k = blockIdx.x;
  c.i = blockIdx.y * kCellX + threadIdx.x;
  c.j = blockIdx.z * kCellY + threadIdx.y;
  if (c.i >= nxp || c.j >= nyp) return false;
  c.q = static_cast<size_t>(c.j) * nxp + c.i;
  c.p = static_cast<size_t>(c.k) * nyp * nxp + c.q;
  return true;
}

// torch.maximum: NaN where either is NaN, else the larger (CUDA's fmax
// drops a NaN)
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

// torch.minimum: NaN where either is NaN, else the smaller
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

// Copy a launch's table of n pointers into Args, a struct of `want`
// pointers; false if n is not want.
template <typename Args>
bool unpack(Args* a, const void* const* table, int n, int want) {
  if (n != want) return false;
  std::memcpy(a, table, sizeof(Args));
  return true;
}

// V values of T at neighbouring addresses, moved as one access of
// V * sizeof(T) bytes (V = 16 / sizeof(T): float4, double2)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* a, size_t p) {
  return *reinterpret_cast<const Pack<T, V>*>(a + p);
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* a, size_t p,
                                           const Pack<T, V>& v) {
  *reinterpret_cast<Pack<T, V>*>(a + p) = v;
}

// Whether fields of rows of nxp values of T, at these n addresses, can all
// be moved in 16-byte Packs: nxp a multiple of a Pack and every address
// 16-byte aligned (a fresh tensor of 1028-float rows is).
template <typename T>
bool rows_of_packs(const void* const* ptrs, int n, int nxp) {
  bool ok = nxp % (16 / sizeof(T)) == 0;
  for (int t = 0; t < n; ++t)
    ok = ok && reinterpret_cast<uintptr_t>(ptrs[t]) % 16 == 0;
  return ok;
}

// Padded index p of an interior cell's neighbour, wrapped back into the
// interior [ol, ol+n): exactly what the single-device cyclic halo fill
// (ops/stencil.py:cyclic_fill_halo) would have stored at p.
__device__ __forceinline__ int wrap(int p, int ol, int n) {
  int q = (p - ol) % n;
  return (q < 0 ? q + n : q) + ol;
}

struct Add {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};

// Combine K values per thread over all threads of all blocks of a 2-D grid
// with op, into out[0..K), in a fixed order: a shared-memory tree inside
// each block, K partials per block, and the last block to finish combines
// the partials (strided from 0, then a tree) in index order. The result is
// the same from run to run. sh holds K * NT values, partials K per block.
// `counter` must be 0 before the launch; the last block resets it. Returns
// true in thread 0 of the last block, after out is written (a caller may
// act on the result there), false elsewhere.
template <typename T, int K, typename Op>
__device__ bool grid_reduce(const T (&v)[K], Op op, T* sh, T* partials,
                            unsigned int* counter, T* out) {
  __shared__ bool last;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const int nb = gridDim.x * gridDim.y;
  for (int c = 0; c < K; ++c) sh[c * NT + t] = v[c];
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (t < s)
      for (int c = 0; c < K; ++c)
        sh[c * NT + t] = op(sh[c * NT + t], sh[c * NT + t + s]);
    __syncthreads();
  }
  if (t == 0) {
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    for (int c = 0; c < K; ++c) partials[K * b + c] = sh[c * NT];
    __threadfence();
    last = (atomicAdd(counter, 1u) == static_cast<unsigned int>(nb - 1));
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  const volatile T* vp = partials;
  for (int c = 0; c < K; ++c) {
    T acc = T(0);
    for (int b = t; b < nb; b += NT) acc = op(acc, vp[K * b + c]);
    sh[c * NT + t] = acc;
  }
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (t < s)
      for (int c = 0; c < K; ++c)
        sh[c * NT + t] = op(sh[c * NT + t], sh[c * NT + t + s]);
    __syncthreads();
  }
  if (t == 0) {
    for (int c = 0; c < K; ++c) out[c] = sh[c * NT];
    *counter = 0u;
    return true;
  }
  return false;
}

// The sum of v over the grid into *out (grid_reduce with K = 1); sh holds
// NT values.
template <typename T>
__device__ bool grid_sum(T v, T* sh, T* partials, unsigned int* counter,
                         T* out) {
  const T vs[1] = {v};
  return grid_reduce(vs, Add(), sh, partials, counter, out);
}

#ifdef __CUDACC__
// The block's dynamic shared memory, as T (the tests' mock runtime gives
// its own).
template <typename T>
__device__ __forceinline__ T* dynamic_shared() {
  extern __shared__ __align__(16) unsigned char dynamic_shared_bytes[];
  return reinterpret_cast<T*>(dynamic_shared_bytes);
}

// Starts a kernel on a stream: the `start` that the entry points give the
// launches kept in headers (the tests' host check gives its own).
struct OnStream {
  cudaStream_t stream;
  template <typename Kernel, typename... Args>
  void operator()(Kernel kernel, dim3 grid, dim3 block, Args... args) const {
    kernel<<<grid, block, 0, stream>>>(args...);
  }
  // the same with `bytes` of dynamic shared memory, the kernel's limit
  // set to them first (the default, 48 KB, holds the static memory too)
  template <typename Kernel, typename... Args>
  void shared(Kernel kernel, size_t bytes, dim3 grid, dim3 block,
              Args... args) const {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    kernel<<<grid, block, bytes, stream>>>(args...);
  }
  // the most shared memory, static and dynamic, that a block may use
  size_t max_shared() const {
    int dev = 0, bytes = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    return static_cast<size_t>(bytes);
  }
};
#endif

}  // namespace mitgcm
