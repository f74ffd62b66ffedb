// Cooperative-group tile reduction (vx_tile + cg::reduce) on Hopper.
//
// Replaces: src/repro/kernels/tile_reduce/tile_reduce.py::tile_reduce
// (tile_reduce_kernel).  The butterfly makes tiles free: lane ^ offset
// stays inside a power-of-two tile whenever offset < tile_size, so a tiled
// reduction is the __shfl_xor_sync tree cut to log2(tile_size) steps, and
// every lane ends with its tile's result.  That is how cg::reduce runs on a
// thread_block_tile<g>.
//
// Layout: one thread per element of the flat (n, width) operand.  With
// width % tile_size == 0 every tile is tile_size contiguous elements
// aligned to its size, so a tile of <= 32 lanes lies inside one warp and a
// larger tile inside one block (blocks are max(256, tile) threads).  Steps
// with offset >= 32 exchange through shared memory, the rest are register
// shuffles.  Threads past the end form whole dead tiles: they shuffle and
// synchronise like the others and store nothing.
//
// Numerics follow the Pallas kernel exactly: f32 and int32 (wrapping sum)
// operate in their own type; bf16 is rounded back to bf16 after *every*
// step, as the kernel's bf16 ops do.  max/min propagate NaN like
// jnp.maximum / torch.maximum.
//
// Bound on the H100: bytes (one read, one write per element; log2(tile)
// ops each).
#include "common.cuh"

namespace {

enum Op : int { kSum = 0, kMax = 1, kMin = 2 };

template <typename A>
__device__ __forceinline__ A combine(int op, A a, A b);

template <>
__device__ __forceinline__ float combine<float>(int op, float a, float b) {
  switch (op) {
    case kSum: return a + b;
    case kMax: return (a > b || a != a) ? a : b;
    default:   return (a < b || a != a) ? a : b;
  }
}

template <>
__device__ __forceinline__ int combine<int>(int op, int a, int b) {
  switch (op) {
    case kSum: return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
    case kMax: return a > b ? a : b;
    default:   return a < b ? a : b;
  }
}

// the value after one step, in the storage type's precision
template <typename T> __device__ __forceinline__ float round_to(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T> struct Acc { using type = float; };
template <> struct Acc<int> { using type = int; };

__device__ __forceinline__ float load_acc(float v) { return v; }
__device__ __forceinline__ float load_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int load_acc(int v) { return v; }

template <typename T> __device__ __forceinline__ T store_acc(typename Acc<T>::type v);
template <> __device__ __forceinline__ float store_acc<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 store_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ int store_acc<int>(int v) { return v; }

template <typename T>
__global__ void tile_reduce_kernel(const T* __restrict__ x, T* __restrict__ y,
                                   long long total, int tile, int op) {
  using A = typename Acc<T>::type;
  extern __shared__ unsigned char smem[];   // blockDim words, tiles > 32 only
  A* buf = reinterpret_cast<A*>(smem);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = i < total;
  A acc = live ? load_acc(x[i]) : A(0);
  for (int off = tile / 2; off >= 1; off >>= 1) {
    A other;
    if (off >= 32) {                        // partner in another warp
      buf[threadIdx.x] = acc;
      __syncthreads();
      other = buf[threadIdx.x ^ off];
      __syncthreads();
    } else {
      other = __shfl_xor_sync(repro::kFullMask, acc, off);
    }
    acc = combine<A>(op, acc, other);
    if constexpr (sizeof(T) == 2) acc = round_to<T>(acc);
  }
  if (live) y[i] = store_acc<T>(acc);
}

template <typename T>
void launch(const void* x, void* y, long long total, int tile, int op, cudaStream_t s) {
  const int threads = tile > 256 ? tile : 256;
  const long long blocks = (total + threads - 1) / threads;
  const size_t smem = tile > 32 ? threads * sizeof(typename Acc<T>::type) : 0;
  tile_reduce_kernel<T><<<static_cast<unsigned>(blocks), threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), total, tile, op);
}

}  // namespace

extern "C" int repro_tile_reduce(const void* x, void* y, long long total, int tile,
                                 int op, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    if (dtype == repro::kBF16) {
      launch<__nv_bfloat16>(x, y, total, tile, op, s);
    } else if (dtype == repro::kI32) {
      launch<int>(x, y, total, tile, op, s);
    } else {
      launch<float>(x, y, total, tile, op, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
