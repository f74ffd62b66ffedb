// MoE top-k gating for Hopper: each expert's rank counted in one pass,
// then a softmax over the selected experts.  Outputs f32 combine weights
// and an int32 selection mask, (tokens, E).
//
// Replaces: src/repro/kernels/moe_gating/moe_gating.py::moe_gating
// (Pallas, _gating_kernel), which the MoE layer's router calls once per
// layer per forward.
//
// Bound on the H100: the launch, at the router's shapes.  Each token row
// is read once (E bf16 or f32) and written twice (E f32 + E int32): 2.5
// KB at OLMoE's 4 x 64 decode call and 328 KB at a 512 x 64 prefill,
// 0.0001 ms of HBM time or less, well under an empty launch's ~0.002 ms
// queued.  What the kernel can still lose is latency: the Pallas
// kernel's k rounds of (row max -> lowest hit -> mask out with -1e30),
// taken literally, are k dependent warp-wide reductions (40 dependent
// shuffles and 8-32 ballots at top-8; 0.0041-0.0047 ms queued, PERF.md).
//
// Design: no dependent rounds.  An expert's place in the order (value
// descending, id ascending) is the count of experts that beat it,
//   rank(i) = #{ j : x_j > x_i  or  (x_j == x_i and j < i) },
// which does not depend on k.  The rounds select rank < k, except at the
// edges, where their sentinel re-hits; with n = #{x > -1e30}:
//   - a row holding a NaN selects nothing and gets NaN weights;
//   - n >= k: rank < k;
//   - 1 <= n < k: every x > -1e30, and the lowest id g with x == -1e30
//     if g is below every id already selected;
//   - n = 0: one expert, the lowest id of the row's max (rank 0).
// (moe_gating_rank_ref in ref.py; the tests hold it bit for bit to the
// rounds.)  One warp owns a row; lane l holds experts l + 32 j (j < S,
// S = ceil(E / 32) register slots) and stages them in shared memory,
// padded with NaN to 32 S, which beats no one.  After a __syncwarp each
// lane reads the row back as 16-byte broadcast loads and counts the
// beaters of its experts: 32 S compares an expert, all independent, in
// a loop of compile-time length that unrolls whole (10 % faster than
// one over ceil(E / 4) loads).  A vote and a ballot a slot give the NaN
// test, n and the lowest id above -1e30.  The softmax is the rounds
// kernel's: a NaN-keeping warp max over (sel ? x : -1e30), expf, the
// warp sum in the same lane order, and the divide, so the weights are
// its bits.  kWarps rows a block: 512 rows fill 128 blocks, one an SM,
// rather than 64.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // token rows per block
constexpr int kMaxSlots = 4;       // experts per lane: E <= 32 * kMaxSlots
constexpr int kMaxExperts = 32 * kMaxSlots;
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

template <typename T, int S>
__global__ void __launch_bounds__(kWarps * 32)
moe_gating_kernel(const T* __restrict__ logits, float* __restrict__ w,
                  int* __restrict__ mask, int n_tokens, int n_experts, int top_k) {
  __shared__ __align__(16) float rows[kWarps][kMaxExperts];
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= n_tokens) return;       // the whole warp leaves together
  const T* xr = logits + row * n_experts;
  float* sx = rows[threadIdx.x / 32];

  float x[S];
  bool valid[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int e = j * 32 + lane;
    valid[j] = e < n_experts;
    x[j] = valid[j] ? repro::to_f32(xr[e]) : __int_as_float(0x7fc00000);   // NaN pad
    sx[e] = x[j];
  }
  __syncwarp();

  // ranks: the experts that beat each of this lane's, E compares apiece
  int rank[S];
#pragma unroll
  for (int j = 0; j < S; ++j) rank[j] = 0;
  const float4* row4 = reinterpret_cast<const float4*>(sx);
  constexpr int n_chunks = 8 * S;    // through the NaN pad: unrolled whole
#pragma unroll
  for (int c = 0; c < n_chunks; ++c) {
    const float4 v4 = row4[c];
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int id = 4 * c + q;
#pragma unroll
      for (int j = 0; j < S; ++j)
        rank[j] += (v[q] > x[j]) | ((v[q] == x[j]) & (id < j * 32 + lane));
    }
  }

  // the row's NaN test, n = #{x > -1e30} and the lowest id above -1e30
  bool nan_row = false;
  int n_above = 0, first_above = n_experts;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    nan_row |= __any_sync(repro::kFullMask, valid[j] && x[j] != x[j]);
    const unsigned above = __ballot_sync(repro::kFullMask, valid[j] && x[j] > kNeg);
    n_above += __popc(above);
    if (first_above == n_experts && above != 0u) first_above = j * 32 + __ffs(above) - 1;
  }
  bool sel[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int e = j * 32 + lane;
    bool pick;
    if (n_above >= top_k)
      pick = rank[j] < top_k;
    else                             // the sentinel re-hits after round n
      pick = rank[j] < n_above ||
             (rank[j] == n_above && (n_above == 0 || (x[j] == kNeg && e < first_above)));
    sel[j] = pick && valid[j] && !nan_row;
  }

  // softmax over the selected lanes; unselected ones enter the max as
  // -1e30, as the Pallas kernel's masked row does
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (valid[j]) m = nan_max(m, sel[j] ? x[j] : kNeg);
  m = warp_nan_max(m);
  float p[S], s = 0.f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    p[j] = sel[j] ? expf(x[j] - m) : 0.f;
    s += p[j];
  }
  s = repro::warp_sum(s);
  float* wr = w + row * n_experts;
  int* mr = mask + row * n_experts;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int e = j * 32 + lane;
    if (valid[j]) {
      wr[e] = p[j] / s;              // 0 / 0 = NaN when nothing is selected
      mr[e] = sel[j] ? 1 : 0;
    }
  }
}

template <typename T>
void launch(const void* logits, void* w, void* mask, int n_tokens, int n_experts,
            int top_k, cudaStream_t s) {
  const int blocks = (n_tokens + kWarps - 1) / kWarps;
  const T* x = static_cast<const T*>(logits);
  float* wp = static_cast<float*>(w);
  int* mp = static_cast<int*>(mask);
  switch ((n_experts + 31) / 32) {
    case 1: moe_gating_kernel<T, 1><<<blocks, kWarps * 32, 0, s>>>(x, wp, mp, n_tokens, n_experts, top_k); break;
    case 2: moe_gating_kernel<T, 2><<<blocks, kWarps * 32, 0, s>>>(x, wp, mp, n_tokens, n_experts, top_k); break;
    case 3: moe_gating_kernel<T, 3><<<blocks, kWarps * 32, 0, s>>>(x, wp, mp, n_tokens, n_experts, top_k); break;
    default: moe_gating_kernel<T, 4><<<blocks, kWarps * 32, 0, s>>>(x, wp, mp, n_tokens, n_experts, top_k); break;
  }
}

}  // namespace

// logits (n_tokens, n_experts) contiguous in dtype (f32 or bf16),
// 1 <= n_experts <= 128, 1 <= top_k <= n_experts; w (f32) and mask
// (int32) of the same shape.
extern "C" int repro_moe_gating(const void* logits, void* w, void* mask, int n_tokens,
                                int n_experts, int top_k, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tokens > 0) {
    if (dtype == repro::kBF16)
      launch<__nv_bfloat16>(logits, w, mask, n_tokens, n_experts, top_k, s);
    else
      launch<float>(logits, w, mask, n_tokens, n_experts, top_k, s);
  }
  return static_cast<int>(cudaGetLastError());
}
