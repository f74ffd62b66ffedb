// Sum of squared errors, the unet.cu mse_forward microbenchmark, on Hopper.
//
// Replaces: src/repro/kernels/mse/mse.py::mse_partial_sum (_mse_kernel).
// The TPU kernel carried its scalar across a sequential grid in VMEM (the
// atomic-add analogue).  Hopper's blocks run in parallel and in no order,
// so this is the CUDA original's shape again: squared error in registers,
// a __shfl_down_sync tree over `width` lanes that leaves each segment's
// sum in its lane 0, the segment sums added through shared memory, and
// one atomicAdd per block into an f32 scalar that the entry point zeroes
// on the same stream first.  Each thread first accumulates a grid-stride
// run of elements in its register, so a few hundred blocks (and atomics)
// cover any n.  Float atomics land in no fixed order: the result varies
// in its last bits from run to run.
//
// width is the Fig. 5 warp size (8) or a CUDA warp (32); a wider
// reference warp_size still reduces through 32-lane trees (the sum is the
// same function, in another order).
//
// Bound on the H100: bytes (two f32 or bf16 reads per element, 3 flops).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

template <typename T>
__global__ void mse_kernel(const T* __restrict__ p, const T* __restrict__ t,
                           float* __restrict__ out, long long n, int width) {
  __shared__ float seg_sum[kThreads];
  float acc = 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float d = repro::to_f32(p[i]) - repro::to_f32(t[i]);
    acc += d * d;
  }
  for (int off = width / 2; off >= 1; off >>= 1) {
    acc += __shfl_down_sync(repro::kFullMask, acc, off, width);
  }
  if ((threadIdx.x & (width - 1)) == 0) seg_sum[threadIdx.x / width] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (int j = threadIdx.x; j < kThreads / width; j += 32) s += seg_sum[j];
    s = repro::warp_sum(s);
    if (threadIdx.x == 0) atomicAdd(out, s);
  }
}

}  // namespace

extern "C" int repro_mse_partial_sum(const void* p, const void* t, void* out, long long n,
                                     int width, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > static_cast<long long>(sms) * kBlocksPerSM) blocks = sms * kBlocksPerSM;
    if (dtype == repro::kBF16) {
      mse_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(t),
          static_cast<float*>(out), n, width);
    } else {
      mse_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<const float*>(p), static_cast<const float*>(t),
          static_cast<float*>(out), n, width);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
