// One-token GQA decode attention for Hopper over a dense or a paged KV
// cache, online softmax, work bounded by each row's live length.
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py::
// flash_decode (Pallas _decode_kernel) and ::paged_flash_decode (Pallas
// _paged_decode_kernel, bf16/f32 pages; the int8 variant is not ported yet).
//
// Bound on the H100: bytes.  Every cached K/V row up to pos is read once
// against 4 * G flops per element (G = 6 for qwen2-1.5b), ~50x below the
// card's flop/byte balance.  Design: one block per (batch row, KV head)
// with one warp per query head of the group, so a K/V tile staged in
// shared memory is read from device memory once and used by all G query
// heads (the GQA sharing the Pallas kernel gets from its (G, D) q block).
// Tiles of 32 keys run up to pos[b] inclusive and no further; rows past
// pos are never loaded and stay zero in shared memory (pages and dense
// tails can hold garbage and 0 * NaN would poison the sum).  Lane j scores
// key j, the row max and sum are __shfl_xor_sync butterflies, and lane c
// owns output columns c, c+32, ...  The dense cache arrives as a strided
// view (the model slices [:, :attend_len] without copying); the paged
// cache resolves position t through block_tables[b, min(t / page_size,
// pos / page_size)], exactly the Pallas index map's clamp.
//
// Known limit: B * Hkv blocks (8 at batch 4 for qwen2-1.5b) occupy a few
// of the 132 SMs, so one SM's bandwidth bounds a step.  Splitting the KV
// axis across blocks with a combine pass is later work.
#include "common.cuh"

namespace {

constexpr int kBlockK = 32;  // keys per tile, one per lane
constexpr int kMaxGroup = 16;

struct Strides {
  long long b, s, h;  // dense: batch/seq/head; paged: page/offset/head
};

template <typename T, int D, bool kPaged>
__global__ void __launch_bounds__(kMaxGroup * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ pos, const int* __restrict__ block_tables,
              T* __restrict__ o, Strides ks_, Strides vs_, long long bt_stride,
              int page_size, int n_keys_max, int hkv, int group, float scale) {
  constexpr int C = D / 32;
  __shared__ float q_s[kMaxGroup][D];
  __shared__ float k_s[kBlockK][D + 1];  // +1: lane j reads row j conflict-free
  __shared__ float v_s[kBlockK][D];

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nthreads = blockDim.x;
  const int p = pos[b];
  const int n_keys = min(p + 1, n_keys_max);

  const long long row = (static_cast<long long>(b) * hkv + h) * group + warp;
  for (int c = lane; c < D; c += 32) q_s[warp][c] = repro::to_f32(q[row * D + c]);

  float m = -INFINITY, l = 0.f, acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;

  const int n_tiles = (n_keys + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed (and q_s is in)
    for (int i = threadIdx.x; i < kBlockK * D; i += nthreads) {
      const int j = i / D, c = i % D, kid = kv0 + j;
      float kx = 0.f, vx = 0.f;
      if (kid < n_keys) {
        long long ko, vo;
        if (kPaged) {
          const int blk = min(kid / page_size, p / page_size);
          const long long page = block_tables[b * bt_stride + blk];
          const int off = kid % page_size;
          ko = page * ks_.b + off * ks_.s + h * ks_.h;
          vo = page * vs_.b + off * vs_.s + h * vs_.h;
        } else {
          ko = b * ks_.b + kid * ks_.s + h * ks_.h;
          vo = b * vs_.b + kid * vs_.s + h * vs_.h;
        }
        kx = repro::to_f32(k[ko + c]);
        vx = repro::to_f32(v[vo + c]);
      }
      k_s[j][c] = kx;
      v_s[j][c] = vx;
    }
    __syncthreads();

    const int kid = kv0 + lane;
    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) s += q_s[warp][c] * k_s[lane][c];
    s *= scale;
    const bool valid = kid < n_keys;
    s = valid ? s : repro::kMaskValue;
    const float m_new = fmaxf(m, repro::warp_max(s));
    const float alpha = expf(m - m_new);
    const float pr = valid ? expf(s - m_new) : 0.f;
    l = alpha * l + repro::warp_sum(pr);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] *= alpha;
#pragma unroll 8
    for (int j = 0; j < kBlockK; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += pj * v_s[j][lane + 32 * c];
    }
    m = m_new;
  }

  const float safe = l == 0.f ? 1.f : l;
#pragma unroll
  for (int c = 0; c < C; ++c) o[row * D + lane + 32 * c] = repro::from_f32<T>(acc[c] / safe);
}

template <typename T, int D, bool kPaged>
void launch(const void* q, const void* k, const void* v, const int* pos, const int* bt,
            void* o, Strides ks, Strides vs, long long bt_stride, int page_size,
            int n_keys_max, int b, int hkv, int group, float scale, cudaStream_t stream) {
  decode_kernel<T, D, kPaged><<<dim3(b, hkv), group * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos, bt,
      static_cast<T*>(o), ks, vs, bt_stride, page_size, n_keys_max, hkv, group, scale);
}

template <bool kPaged>
int dispatch(const void* q, const void* k, const void* v, const void* pos, const void* bt,
             void* o, Strides ks, Strides vs, long long bt_stride, int page_size,
             int n_keys_max, int b, int hkv, int group, int d, float scale, int dtype,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(bt);
  if (b > 0 && hkv > 0) {
    if (dtype == repro::kBF16) {
      if (d == 128)
        launch<__nv_bfloat16, 128, kPaged>(q, k, v, p, t, o, ks, vs, bt_stride, page_size, n_keys_max, b, hkv, group, scale, s);
      else
        launch<__nv_bfloat16, 64, kPaged>(q, k, v, p, t, o, ks, vs, bt_stride, page_size, n_keys_max, b, hkv, group, scale, s);
    } else {
      if (d == 128)
        launch<float, 128, kPaged>(q, k, v, p, t, o, ks, vs, bt_stride, page_size, n_keys_max, b, hkv, group, scale, s);
      else
        launch<float, 64, kPaged>(q, k, v, p, t, o, ks, vs, bt_stride, page_size, n_keys_max, b, hkv, group, scale, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hkv, G, D) and o contiguous; k/v (B, S, Hkv, D) with element
// strides for B, S and Hkv (D contiguous); pos (B,) int32.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* pos, void* o, long long k_sb, long long k_ss,
                                  long long k_sh, long long v_sb, long long v_ss,
                                  long long v_sh, int b, int s, int hkv, int group, int d,
                                  float scale, int dtype, void* stream) {
  return dispatch<false>(q, k, v, pos, nullptr, o, Strides{k_sb, k_ss, k_sh},
                         Strides{v_sb, v_ss, v_sh}, 0, 1, s, b, hkv, group, d, scale,
                         dtype, stream);
}

// q (B, Hkv, G, D) and o contiguous; k/v pages (P, page_size, Hkv, D) with
// element strides for P, page_size and Hkv; block_tables (B, NB) int32
// with row stride bt_stride; pos (B,) int32.
extern "C" int repro_paged_flash_decode(const void* q, const void* k_pages,
                                        const void* v_pages, const void* block_tables,
                                        const void* pos, void* o, long long k_sp,
                                        long long k_so, long long k_sh, long long v_sp,
                                        long long v_so, long long v_sh, long long bt_stride,
                                        int b, int nb, int page_size, int hkv, int group,
                                        int d, float scale, int dtype, void* stream) {
  return dispatch<true>(q, k_pages, v_pages, pos, block_tables, o,
                        Strides{k_sp, k_so, k_sh}, Strides{v_sp, v_so, v_sh}, bt_stride,
                        page_size, nb * page_size, b, hkv, group, d, scale, dtype, stream);
}
