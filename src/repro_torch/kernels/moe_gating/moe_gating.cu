// MoE top-k gating for Hopper: k rounds of (row max -> lowest hit expert
// -> mask it out with -1e30), then a softmax over the selected experts.
// Outputs f32 combine weights and an int32 selection mask, (tokens, E).
//
// Replaces: src/repro/kernels/moe_gating/moe_gating.py::moe_gating
// (Pallas, _gating_kernel), which the MoE layer's router calls once per
// layer per forward.
//
// Bound on the H100: bytes, and in practice the launch.  Each token row
// is read once (E bf16 or f32) and written twice (E f32 + E int32), with
// ~k * E compares and E exps: a few operations per byte.  At decode the
// whole call is 4 rows, one block.
//
// Design: the paper's vote primitive used literally.  One warp per token
// row; lane l holds experts l, l+32, l+64 and l+96 in registers (E <= 128).
// Each round takes the warp max by a __shfl_xor_sync butterfly, then the
// lowest expert id equal to it by one __ballot_sync per register slot
// (slot j covers ids [32j, 32j + 32), so the first non-empty ballot's
// __ffs is the lowest id) and the owning lane writes the sentinel.  The
// softmax takes two more butterflies (max, sum).  The max keeps a NaN, as
// jnp.max does and fmaxf does not: a row holding a NaN matches no lane,
// selects nothing and gets NaN weights, the Pallas kernel's rule.  The
// sentinel stays in selected lanes, so a row with fewer than k values
// above -1e30 selects fewer than k experts, again as the Pallas kernel.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;          // token rows per 256-thread block
constexpr int kSlots = 4;          // experts per lane: E <= 32 * kSlots
constexpr float kNeg = -1e30f;     // moe_gating.py:23

// max that propagates a NaN from either side
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_nan_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = nan_max(x, __shfl_xor_sync(repro::kFullMask, x, o));
  return x;
}

template <typename T>
__global__ void moe_gating_kernel(const T* __restrict__ logits, float* __restrict__ w,
                                  int* __restrict__ mask, int n_tokens, int n_experts,
                                  int top_k) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= n_tokens) return;       // the whole warp leaves together
  const T* xr = logits + row * n_experts;

  float x[kSlots], rem[kSlots];
  bool valid[kSlots], sel[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int e = j * 32 + lane;
    valid[j] = e < n_experts;
    x[j] = valid[j] ? repro::to_f32(xr[e]) : -INFINITY;
    rem[j] = x[j];
    sel[j] = false;
  }

  for (int r = 0; r < top_k; ++r) {
    float m = rem[0];
#pragma unroll
    for (int j = 1; j < kSlots; ++j) m = nan_max(m, rem[j]);
    m = warp_nan_max(m);
    // the ballot is the same on every lane, so the warp breaks together
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const unsigned hits = __ballot_sync(repro::kFullMask, valid[j] && rem[j] == m);
      if (hits != 0u) {
        if (lane == __ffs(hits) - 1) {
          sel[j] = true;
          rem[j] = kNeg;
        }
        break;
      }
    }
  }

  // softmax over the selected lanes; unselected ones enter the max as
  // -1e30, as the Pallas kernel's masked row does
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    if (valid[j]) m = nan_max(m, sel[j] ? x[j] : kNeg);
  m = warp_nan_max(m);
  float p[kSlots], s = 0.f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    p[j] = sel[j] ? expf(x[j] - m) : 0.f;
    s += p[j];
  }
  s = repro::warp_sum(s);
  float* wr = w + row * n_experts;
  int* mr = mask + row * n_experts;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int e = j * 32 + lane;
    if (valid[j]) {
      wr[e] = p[j] / s;              // 0 / 0 = NaN when nothing is selected
      mr[e] = sel[j] ? 1 : 0;
    }
  }
}

}  // namespace

// logits (n_tokens, n_experts) contiguous in dtype (f32 or bf16),
// n_experts <= 128; w (f32) and mask (int32) of the same shape.
extern "C" int repro_moe_gating(const void* logits, void* w, void* mask, int n_tokens,
                                int n_experts, int top_k, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tokens > 0) {
    const int blocks = (n_tokens + kWarps - 1) / kWarps;
    if (dtype == repro::kBF16)
      moe_gating_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, s>>>(
          static_cast<const __nv_bfloat16*>(logits), static_cast<float*>(w),
          static_cast<int*>(mask), n_tokens, n_experts, top_k);
    else
      moe_gating_kernel<float><<<blocks, kWarps * 32, 0, s>>>(
          static_cast<const float*>(logits), static_cast<float*>(w),
          static_cast<int*>(mask), n_tokens, n_experts, top_k);
  }
  return static_cast<int>(cudaGetLastError());
}
