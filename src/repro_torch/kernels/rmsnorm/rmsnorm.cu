// Row RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * w, cast back.
// The weight may be fp32 under bf16 rows (training's fp32 master weights):
// it is multiplied in fp32 either way, as the Pallas kernel does
// (rmsnorm.py:26).
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py::rmsnorm (Pallas,
// rmsnorm_kernel), which every dense layer calls twice plus once for ln_f.
// That kernel keeps a block of rows in VMEM: one HBM read, one write.
//
// Bound on the H100: bytes (one read and one write of the rows, ~4 flops
// an element against the ~20 flop/byte the f32 CUDA cores need to be the
// limit).  Two branches behind one entry point; the wrapper picks one and
// counts them apart (rmsnorm.launches, rmsnorm.launches_ragged):
//
// Warp branch (every serving and training path): one warp a row, 4 rows a
// block.  Each lane reads its share of the row once, as 16-byte vectors
// (8 bf16 or 4 f32; vector i of lane l is the row's vector 32 i + l, so a
// warp's loads are 512 contiguous bytes), and keeps it in registers as
// floats: V vectors a lane, a template on the widths the configs use (6 at
// qwen2's d 1536, 8 at OLMoE's 2048 in bf16).  The fp32 sum of squares
// is a __shfl_xor_sync butterfly alone (the paper's HW warp-reduce: no
// shared memory, no __syncthreads); w is read as 16-byte vectors too (two
// float4 for 8 bf16 rows under an fp32 w), y written as 16-byte vectors.
// At 2048 rows that is 512 blocks, one wave whose warps each keep the
// whole row's loads in flight at once.  It takes rows of d a multiple of
// the vector and at most 2048 wide (64 floats a lane), x and w 16-byte
// aligned.
//
// Ragged branch (any other width or alignment): one 256-thread block a
// row; scalar loads in a strided loop, the warp sums then the 8 warps'
// through shared memory, and a second pass over the row (an L1/L2 hit).
//
// Both keep the reference's rounding points: f32 x, an f32 mean, rsqrtf,
// f32 w, one cast.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRowsPerBlock = 4;  // warp branch: one warp a row
constexpr int kRaggedThreads = 256;

// N consecutive elements at p (aligned to their size, up to 16 bytes) as
// floats, and back
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float* f) {
  static_assert(N % 4 == 0, "float4 vectors");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    f[i] = v.x, f[i + 1] = v.y, f[i + 2] = v.z, f[i + 3] = v.w;
  }
}

__device__ __forceinline__ void unpack(uint32_t u, float* f) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  f[0] = v.x, f[1] = v.y;
}

template <int N>
__device__ __forceinline__ void load_floats(const bf16* p, float* f) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      unpack(v.x, f + i), unpack(v.y, f + i + 2), unpack(v.z, f + i + 4), unpack(v.w, f + i + 6);
    }
  } else {  // four bf16 weights under four f32 rows: 8 bytes
    static_assert(N == 4, "bf16 vectors of 4 or 8k");
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    unpack(v.x, f), unpack(v.y, f + 2);
  }
}

template <int N>
__device__ __forceinline__ void store_floats(float* p, const float* f) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int N>
__device__ __forceinline__ void store_floats(bf16* p, const float* f) {
  static_assert(N % 8 == 0, "uint4 vectors");
#pragma unroll
  for (int i = 0; i < N; i += 8)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(pack(f[i], f[i + 1]), pack(f[i + 2], f[i + 3]),
                                                  pack(f[i + 4], f[i + 5]),
                                                  pack(f[i + 6], f[i + 7]));
}

// warp branch: V 16-byte vectors a lane at most (lanes past the row's last
// vector hold none)
template <typename T, typename W, int V>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
rmsnorm_warp_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
                    int n_rows, int d, float eps) {
  constexpr int E = 16 / sizeof(T);  // elements a vector
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= n_rows) return;  // the whole warp: the butterfly below needs all 32 lanes
  const int nv = d / E;
  const T* xr = x + static_cast<long long>(row) * d;
  T* yr = y + static_cast<long long>(row) * d;

  // every load of the row and of w is issued before the first is used
  float xv[V][E], wv[V][E];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = (32 * i + lane) * E;
    if (c < nv * E) {
      load_floats<E>(xr + c, xv[i]);
      load_floats<E>(w + c, wv[i]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if ((32 * i + lane) < nv) {
#pragma unroll
      for (int e = 0; e < E; ++e) ss += xv[i][e] * xv[i][e];
    }
  }
  const float r = rsqrtf(repro::warp_sum(ss) / static_cast<float>(d) + eps);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = (32 * i + lane) * E;
    if (c < nv * E) {
      float o[E];
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = xv[i][e] * r * wv[i][e];
      store_floats<E>(yr + c, o);
    }
  }
}

// ragged branch: one block a row, any d and alignment
template <typename T, typename W>
__global__ void __launch_bounds__(kRaggedThreads)
rmsnorm_ragged_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
                      int d, float eps) {
  const int row = blockIdx.x;
  const T* xr = x + static_cast<long long>(row) * d;
  T* yr = y + static_cast<long long>(row) * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kRaggedThreads) {
    const float v = repro::to_f32(xr[i]);
    ss += v * v;
  }
  ss = repro::warp_sum(ss);
  __shared__ float partial[kRaggedThreads / 32];
  __shared__ float inv_rms;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kRaggedThreads / 32 ? partial[lane] : 0.f;
    t = repro::warp_sum(t);
    if (lane == 0) inv_rms = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int i = threadIdx.x; i < d; i += kRaggedThreads) {
    yr[i] = repro::from_f32<T>(repro::to_f32(xr[i]) * r * repro::to_f32(w[i]));
  }
}

template <typename T, typename W, int V>
cudaError_t launch_warp(const T* x, const W* w, T* y, int n_rows, int d, float eps,
                        cudaStream_t s) {
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_warp_kernel<T, W, V><<<blocks, kRowsPerBlock * 32, 0, s>>>(x, w, y, n_rows, d, eps);
  return cudaGetLastError();
}

// the smallest instantiated V that holds the row: 64 floats a lane at most
template <typename T, typename W>
cudaError_t launch_rows(const void* xp, const void* wp, void* yp, int n_rows, int d, float eps,
                        int ragged, cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const W* w = static_cast<const W*>(wp);
  T* y = static_cast<T*>(yp);
  if (ragged) {
    rmsnorm_ragged_kernel<T, W><<<n_rows, kRaggedThreads, 0, s>>>(x, w, y, d, eps);
    return cudaGetLastError();
  }
  constexpr int E = 16 / sizeof(T);
  if (d % E != 0) return cudaErrorInvalidValue;
  const int v = (d / E + 31) / 32;
  if (v <= 1) return launch_warp<T, W, 1>(x, w, y, n_rows, d, eps, s);
  if (v <= 2) return launch_warp<T, W, 2>(x, w, y, n_rows, d, eps, s);
  if (v <= 4) return launch_warp<T, W, 4>(x, w, y, n_rows, d, eps, s);
  if (v <= 6) return launch_warp<T, W, 6>(x, w, y, n_rows, d, eps, s);
  if (v <= 8) return launch_warp<T, W, 8>(x, w, y, n_rows, d, eps, s);
  if constexpr (E == 4) {  // f32 rows: 4 floats a vector, up to 16 vectors
    if (v <= 12) return launch_warp<T, W, 12>(x, w, y, n_rows, d, eps, s);
    if (v <= 16) return launch_warp<T, W, 16>(x, w, y, n_rows, d, eps, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_w(const void* x, const void* w, int w_dtype, void* y, int n_rows, int d,
                     float eps, int ragged, cudaStream_t s) {
  return w_dtype == repro::kBF16 ? launch_rows<T, bf16>(x, w, y, n_rows, d, eps, ragged, s)
                                 : launch_rows<T, float>(x, w, y, n_rows, d, eps, ragged, s);
}

}  // namespace

// x and y (n_rows, d) contiguous in dtype; w (d,) in w_dtype (f32 or bf16).
// ragged 0 takes the warp branch: d a multiple of 16 bytes of x's dtype and
// at most 2048, x and w 16-byte aligned (the wrapper checks; a width it
// cannot hold returns cudaErrorInvalidValue); ragged 1 the block-per-row
// branch, which takes anything.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y, int n_rows, int d, float eps,
                             int dtype, int w_dtype, int ragged, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t e = dtype == repro::kBF16
                            ? launch_w<bf16>(x, w, w_dtype, y, n_rows, d, eps, ragged, s)
                            : launch_w<float>(x, w, w_dtype, y, n_rows, d, eps, ragged, s);
  return static_cast<int>(e);
}
