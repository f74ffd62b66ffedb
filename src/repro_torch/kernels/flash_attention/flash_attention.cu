// Causal flash-attention forward for Hopper, GQA-grouped, with per-row
// valid length: O and lse = m + log(l).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_fwd (Pallas _fwd_kernel) and the K/V head expansion of
// ops.py::flash_mha (the jnp.repeat there exists for the backward pass
// only; here query head h reads KV head h / G directly).
//
// Bound on the H100: operations at prefill lengths (4 * S^2/2 * D flops
// per head against 2 * S * D K/V bytes).  This first version computes in
// fp32 on the CUDA cores, not the tensor cores, so it sits far from the
// bf16 tensor-core bound; wgmma/TMA tiles are later work.  What the design
// does keep: K/V are read from device memory once per 16-row query tile
// (staged in shared memory and shared by its 4 warps), kv tiles past the
// causal diagonal or past kv_len are neither loaded nor computed, and the
// running max / sum / accumulator stay in registers.  Each warp owns 4
// query rows; lane j scores key j of a 32-key tile, the row max and sum
// are __shfl_xor_sync butterflies, and for P @ V lane c owns output
// columns c, c+32, ...
//
// Masking follows the Pallas kernel exactly: masked scores are
// -0.7 * f32max, masked probabilities are zeroed, fully masked rows get
// l := 1 (O = 0) and lse = FULLY_MASKED_LSE.
#include "common.cuh"

namespace {

constexpr int kRowsPerWarp = 4;
constexpr int kWarps = 4;
constexpr int kBlockQ = kRowsPerWarp * kWarps;  // 16 query rows per block
constexpr int kBlockK = 32;                     // one key per lane

struct Strides {
  long long b, s, h;  // elements; the last (head-dim) stride is 1
};

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_len,
                 T* __restrict__ o, float* __restrict__ lse, Strides qs_, Strides ks_,
                 Strides vs_, int sq, int skv, int hq, int hkv, int causal,
                 float scale) {
  constexpr int C = D / 32;  // output columns per lane
  __shared__ float q_s[kBlockQ][D];
  __shared__ float k_s[kBlockK][D + 1];  // +1: lane j reads row j conflict-free
  __shared__ float v_s[kBlockK][D];

  const int q0 = blockIdx.x * kBlockQ;
  const int b = blockIdx.y / hq;
  const int h = blockIdx.y % hq;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(kv_len[b], skv);

  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + hk * ks_.h;
  const T* vb = v + b * vs_.b + hk * vs_.h;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kWarps * 32) {
    const int r = i / D, c = i % D;
    q_s[r][c] = q0 + r < sq ? repro::to_f32(qb[(q0 + r) * qs_.s + c]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][C];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  // kv tiles past the causal diagonal of this query tile, or past the
  // valid length, are neither loaded nor computed
  int kv_end = len;
  if (causal) kv_end = min(kv_end, min(q0 + kBlockQ, sq));
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBlockK;
    __syncthreads();  // the previous tile is fully consumed (and q_s is in)
    for (int i = threadIdx.x; i < kBlockK * D; i += kWarps * 32) {
      const int j = i / D, c = i % D;
      const bool in = kv0 + j < len;
      k_s[j][c] = in ? repro::to_f32(kb[(kv0 + j) * ks_.s + c]) : 0.f;
      v_s[j][c] = in ? repro::to_f32(vb[(kv0 + j) * vs_.s + c]) : 0.f;
    }
    __syncthreads();

    const int kid = kv0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int qi = q0 + r;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s += q_s[r][c] * k_s[lane][c];
      s *= scale;
      const bool valid = kid < len && (!causal || kid <= qi);
      s = valid ? s : repro::kMaskValue;
      const float m_new = fmaxf(m[i], repro::warp_max(s));
      const float alpha = expf(m[i] - m_new);
      const float p = valid ? expf(s - m_new) : 0.f;
      l[i] = alpha * l[i] + repro::warp_sum(p);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
#pragma unroll 8
      for (int j = 0; j < kBlockK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] += pj * v_s[j][lane + 32 * c];
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    if (qi >= sq) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((static_cast<long long>(b) * sq + qi) * hq + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) orow[lane + 32 * c] = repro::from_f32<T>(acc[i][c] / safe);
    if (lane == 0) {
      lse[(static_cast<long long>(b) * hq + h) * sq + qi] =
          l[i] == 0.f ? repro::kFullyMaskedLse : m[i] + logf(safe);
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const int* kv_len, void* o,
            float* lse, Strides qs, Strides ks, Strides vs, int b, int sq, int skv,
            int hq, int hkv, int causal, float scale, cudaStream_t stream) {
  dim3 grid((sq + kBlockQ - 1) / kBlockQ, b * hq);
  flash_fwd_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      kv_len, static_cast<T*>(o), lse, qs, ks, vs, sq, skv, hq, hkv, causal, scale);
}

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) with the given element strides
// for the B, S and H axes (D contiguous); kv_len (B,) int32; o (B, Sq, Hq,
// D) and lse (B, Hq, Sq) float32, both contiguous.  D is 64 or 128.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_len, void* o, void* lse,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, int b, int sq,
    int skv, int hq, int hkv, int d, int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const int* len = static_cast<const int*>(kv_len);
  float* l = static_cast<float*>(lse);
  if (b > 0 && sq > 0) {
    if (dtype == repro::kBF16) {
      if (d == 128)
        launch<__nv_bfloat16, 128>(q, k, v, len, o, l, qs, ks, vs, b, sq, skv, hq, hkv, causal, scale, s);
      else
        launch<__nv_bfloat16, 64>(q, k, v, len, o, l, qs, ks, vs, b, sq, skv, hq, hkv, causal, scale, s);
    } else {
      if (d == 128)
        launch<float, 128>(q, k, v, len, o, l, qs, ks, vs, b, sq, skv, hq, hkv, causal, scale, s);
      else
        launch<float, 64>(q, k, v, len, o, l, qs, ks, vs, b, sq, skv, hq, hkv, causal, scale, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
