// Row RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * w, cast back.
// The weight may be fp32 under bf16 rows (training's fp32 master weights):
// it is multiplied in fp32 either way, as the Pallas kernel does
// (rmsnorm.py:26).
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py::rmsnorm (Pallas,
// rmsnorm_kernel), which every dense layer calls twice plus once for ln_f.
//
// Bound on the H100: bytes.  Each row is read twice and written once
// against ~4 flops per element, far below the ~295 flop/byte the card
// needs before compute limits.  Design: one 256-thread block per row; the
// fp32 sum of squares is reduced inside each warp with __shfl_xor_sync
// (the paper's HW warp-reduce, literally), then across the 8 warps
// through shared memory.  The second read of the row hits L1/L2 (a row
// of d=1536 bf16 is 3 KB), so device memory sees one read and one write.
// At decode (4 rows) the launch is all there is; fusing it into the
// neighbouring matmul epilogue is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename W>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                               T* __restrict__ y, int d, float eps) {
  const int row = blockIdx.x;
  const T* xr = x + static_cast<long long>(row) * d;
  T* yr = y + static_cast<long long>(row) * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = repro::to_f32(xr[i]);
    ss += v * v;
  }
  ss = repro::warp_sum(ss);
  __shared__ float partial[kThreads / 32];
  __shared__ float inv_rms;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? partial[lane] : 0.f;
    t = repro::warp_sum(t);
    if (lane == 0) inv_rms = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    yr[i] = repro::from_f32<T>(repro::to_f32(xr[i]) * r * repro::to_f32(w[i]));
  }
}

template <typename T>
void launch_rows(const void* x, const void* w, int w_dtype, void* y, int n_rows, int d,
                 float eps, cudaStream_t s) {
  if (w_dtype == repro::kBF16) {
    rmsnorm_kernel<T, __nv_bfloat16><<<n_rows, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(w), static_cast<T*>(y),
        d, eps);
  } else {
    rmsnorm_kernel<T, float><<<n_rows, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(y), d, eps);
  }
}

}  // namespace

// x and y (n_rows, d) contiguous in dtype; w (d,) in w_dtype (f32 or bf16).
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y, int n_rows,
                             int d, float eps, int dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows > 0) {
    if (dtype == repro::kBF16)
      launch_rows<__nv_bfloat16>(x, w, w_dtype, y, n_rows, d, eps, s);
    else
      launch_rows<float>(x, w, w_dtype, y, n_rows, d, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}
