// A mock of the CUDA runtime for checking kernels on the host: the kernel
// sources compile with g++ against it, and host_launch runs a launch's
// blocks one after another on one std::thread per CUDA thread of a block,
// with a std::barrier for __syncthreads and one per warp for the warp
// shuffles and __syncwarp. A __shared__ variable becomes a static one,
// shared by the threads of the block that runs, and the dynamic shared
// memory one buffer, sized at the launch. Only what the port's kernels use
// is here.
#pragma once

#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)

using std::exp;    // CUDA's overloads for float and double
using std::fabs;
using std::sqrt;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* host_block_barrier = nullptr;

inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }

// The warp shuffles: each lane of the warp leaves its value in a slot, the
// warp meets at its barrier, each lane reads lane + delta's slot (its own
// value past the warp's edge, as on the card), and the warp meets again
// before the slots are reused. Every lane of the warp must take part.
inline std::vector<std::unique_ptr<std::barrier<>>> host_warp_barriers;
inline unsigned char host_shuffle_slots[1024 * 8];

template <typename T>
T host_shuffle(T v, int delta) {
  static_assert(sizeof(T) <= 8, "one slot a lane");
  const unsigned t =
      (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
  const unsigned nt = blockDim.x * blockDim.y * blockDim.z;
  const unsigned warp = t / 32, first = warp * 32;
  const unsigned width = nt - first < 32 ? nt - first : 32;
  std::memcpy(host_shuffle_slots + t * 8, &v, sizeof(T));
  host_warp_barriers[warp]->arrive_and_wait();
  const int src = static_cast<int>(t - first) + delta;
  T out = v;
  if (src >= 0 && src < static_cast<int>(width))
    std::memcpy(&out, host_shuffle_slots + (first + src) * 8, sizeof(T));
  host_warp_barriers[warp]->arrive_and_wait();
  return out;
}
// __syncwarp: the warp meets at its barrier (every lane must take part)
inline void __syncwarp(unsigned = 0xffffffffu) {
  const unsigned t =
      (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
  host_warp_barriers[t / 32]->arrive_and_wait();
}
template <typename T>
T __shfl_up_sync(unsigned, T v, unsigned delta) {
  return host_shuffle(v, -static_cast<int>(delta));
}
template <typename T>
T __shfl_down_sync(unsigned, T v, unsigned delta) {
  return host_shuffle(v, static_cast<int>(delta));
}
inline void __threadfence() {}
inline unsigned int atomicAdd(unsigned int* p, unsigned int v) {
  const unsigned int old = *p;
  *p += v;
  return old;
}

// the dynamic shared memory of the block that runs
inline std::vector<unsigned char> host_dynamic_shared_bytes;
template <typename T>
T* dynamic_shared() {
  return reinterpret_cast<T*>(host_dynamic_shared_bytes.data());
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// Run body() as every thread of every block of a (grid, block) launch: one
// std::thread per thread of a block walks the blocks in order, and all of
// them finish a block before any starts the next (its __shared__ data is
// then the next block's). Every thread of a block must reach the same
// __syncthreads, as on the card.
template <typename Body>
void host_launch(dim3 grid, dim3 block, Body body) {
  gridDim = grid;
  blockDim = block;
  const unsigned nt = block.x * block.y * block.z;
  std::barrier<> bar(nt);
  host_block_barrier = &bar;
  host_warp_barriers.clear();
  for (unsigned first = 0; first < nt; first += 32)
    host_warp_barriers.push_back(std::make_unique<std::barrier<>>(
        static_cast<std::ptrdiff_t>(nt - first < 32 ? nt - first : 32)));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (unsigned tz = 0; tz < block.z; ++tz)
    for (unsigned ty = 0; ty < block.y; ++ty)
      for (unsigned tx = 0; tx < block.x; ++tx)
        threads.emplace_back([&body, &bar, grid, tx, ty, tz] {
          threadIdx = dim3(tx, ty, tz);
          for (unsigned bz = 0; bz < grid.z; ++bz)
            for (unsigned by = 0; by < grid.y; ++by)
              for (unsigned bx = 0; bx < grid.x; ++bx) {
                blockIdx = dim3(bx, by, bz);
                body();
                bar.arrive_and_wait();
              }
        });
  for (auto& th : threads) th.join();
}
