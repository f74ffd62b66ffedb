// Tiled GEMM with f32 accumulation on the CUDA cores: the paper's Fig. 5
// control benchmark, which has no warp collectives.
//
// Replaces: src/repro/kernels/matmul/matmul.py::matmul (_matmul_kernel).
// The TPU kernel fed the MXU with 256x256x512 VMEM blocks and carried the
// f32 accumulator across a sequential K grid axis in scratch.  Here each
// block owns a 64x64 output tile and walks K itself in slices of 16: the
// A and B slices are staged in shared memory (converted to f32 on the
// way in), and each of the 256 threads accumulates a 4x4 micro-tile in
// registers, rows ty + 16 i and columns tx + 16 j, so shared-memory reads
// are conflict-free and stores coalesce.  Edges are guarded: any M, N, K.
// The output is rounded once to a's dtype.
//
// Bound on the H100: operations at large sizes (2 M N K f32 flops at
// 67 TFLOP/s against 4-byte operands), bytes for the 64^3 Fig. 5 case.
// It does not use the tensor cores (wgmma/TMA is later work), so it sits
// well below the f32 peak.
#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
              int m, int n, int k) {
  __shared__ float as[kBK][kBM + 4];   // A slice, transposed: as[kk][row]
  __shared__ float bs[kBK][kBN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int l = threadIdx.x; l < kBM * kBK; l += kThreads) {
      const int r = l / kBK, kk = l % kBK, gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k)
                      ? repro::to_f32(a[static_cast<long long>(gr) * k + gk]) : 0.f;
    }
    for (int l = threadIdx.x; l < kBK * kBN; l += kThreads) {
      const int kk = l / kBN, cc = l % kBN, gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < k && gc < n)
                       ? repro::to_f32(b[static_cast<long long>(gk) * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gr < m && gc < n) c[static_cast<long long>(gr) * n + gc] = repro::from_f32<T>(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" int repro_matmul(const void* a, const void* b, void* c, int m, int n, int k,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m > 0 && n > 0) {
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    if (dtype == repro::kBF16) {
      matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
          static_cast<__nv_bfloat16*>(c), m, n, k);
    } else {
      matmul_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(c), m, n, k);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
