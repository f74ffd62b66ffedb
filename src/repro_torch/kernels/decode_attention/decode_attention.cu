// One-token GQA decode attention for Hopper over a dense or a paged KV
// cache, online softmax, work bounded by each row's live length.
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py::
// flash_decode (Pallas _decode_kernel) and ::paged_flash_decode (Pallas
// _paged_decode_kernel over bf16/f32 pages, and over int8 pages with f32
// row scales: the ks_ref/vs_ref multiplies of _decode_kernel).
//
// Bound on the H100: bytes.  Every cached K/V row up to pos is read once
// against 4 * G flops per element (G = 6 for qwen2-1.5b), ~50x below the
// card's flop/byte balance.  int8 pages read 1 B per element plus one 4 B
// scale per row for K and for V, against 2 B for bf16: about half the
// bytes of the same rows.  Design: one block per (batch row, KV head)
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
// pos / page_size)], exactly the Pallas index map's clamp.  With int8
// pages (the cache type TC is int8_t, apart from q's type T) each element
// is dequantized as it is staged, float(q8) * scale, the row's scale read
// through the same clamped page lookup (the D lanes of a warp that stage
// one row read one scale, one broadcast load): the dot product then runs
// on (k * s) . q in f32, as the Pallas kernel dequantizes before its dot.
//
// Known limit: B * Hkv blocks (8 at batch 4 for qwen2-1.5b) occupy a few
// of the 132 SMs, so one SM's bandwidth bounds a step.  Splitting the KV
// axis across blocks with a combine pass is later work.
#include "common.cuh"

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBlockK = 32;  // keys per tile, one per lane
constexpr int kMaxGroup = 16;

struct Strides {
  long long b, s, h;  // dense: batch/seq/head; paged: page/offset/head
};

// int8 pages' row scales, (P, page_size) f32 each, with page / offset
// element strides (unused for float pages)
struct Scales {
  const float* k;
  const float* v;
  long long kp, ko, vp, vo;
};

template <typename T, typename TC, int D, bool kPaged>
__global__ void __launch_bounds__(kMaxGroup * 32)
decode_kernel(const T* __restrict__ q, const TC* __restrict__ k, const TC* __restrict__ v,
              const int* __restrict__ pos, const int* __restrict__ block_tables,
              T* __restrict__ o, Strides ks_, Strides vs_, Scales sc, long long bt_stride,
              int page_size, int n_keys_max, int hkv, int group, float scale) {
  constexpr int C = D / 32;
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  static_assert(!kQuant || kPaged, "int8 caches are paged");
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
        long long ko, vo, page = 0;
        int off = 0;
        if (kPaged) {
          const int blk = min(kid / page_size, p / page_size);
          page = block_tables[b * bt_stride + blk];
          off = kid % page_size;
          ko = page * ks_.b + off * ks_.s + h * ks_.h;
          vo = page * vs_.b + off * vs_.s + h * vs_.h;
        } else {
          ko = b * ks_.b + kid * ks_.s + h * ks_.h;
          vo = b * vs_.b + kid * vs_.s + h * vs_.h;
        }
        kx = repro::to_f32(k[ko + c]);
        vx = repro::to_f32(v[vo + c]);
        if constexpr (kQuant) {
          kx *= sc.k[page * sc.kp + off * sc.ko];
          vx *= sc.v[page * sc.vp + off * sc.vo];
        }
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

template <typename T, typename TC, int D, bool kPaged>
void launch(const void* q, const void* k, const void* v, const int* pos, const int* bt,
            void* o, Strides ks, Strides vs, Scales sc, long long bt_stride, int page_size,
            int n_keys_max, int b, int hkv, int group, float scale, cudaStream_t stream) {
  decode_kernel<T, TC, D, kPaged><<<dim3(b, hkv), group * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v), pos, bt,
      static_cast<T*>(o), ks, vs, sc, bt_stride, page_size, n_keys_max, hkv, group, scale);
}

// q's type T from dtype; the cache's type is T, or int8_t when kInt8
template <bool kPaged, bool kInt8>
int dispatch(const void* q, const void* k, const void* v, const void* pos, const void* bt,
             void* o, Strides ks, Strides vs, Scales sc, long long bt_stride, int page_size,
             int n_keys_max, int b, int hkv, int group, int d, float scale, int dtype,
             void* stream) {
  using BF = __nv_bfloat16;
  using CB = typename std::conditional<kInt8, int8_t, BF>::type;
  using CF = typename std::conditional<kInt8, int8_t, float>::type;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(bt);
  if (b > 0 && hkv > 0) {
    if (dtype == repro::kBF16) {
      if (d == 128)
        launch<BF, CB, 128, kPaged>(q, k, v, p, t, o, ks, vs, sc, bt_stride, page_size, n_keys_max, b, hkv, group, scale, s);
      else
        launch<BF, CB, 64, kPaged>(q, k, v, p, t, o, ks, vs, sc, bt_stride, page_size, n_keys_max, b, hkv, group, scale, s);
    } else {
      if (d == 128)
        launch<float, CF, 128, kPaged>(q, k, v, p, t, o, ks, vs, sc, bt_stride, page_size, n_keys_max, b, hkv, group, scale, s);
      else
        launch<float, CF, 64, kPaged>(q, k, v, p, t, o, ks, vs, sc, bt_stride, page_size, n_keys_max, b, hkv, group, scale, s);
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
  return dispatch<false, false>(q, k, v, pos, nullptr, o, Strides{k_sb, k_ss, k_sh},
                                Strides{v_sb, v_ss, v_sh}, Scales{}, 0, 1, s, b, hkv, group,
                                d, scale, dtype, stream);
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
  return dispatch<true, false>(q, k_pages, v_pages, pos, block_tables, o,
                               Strides{k_sp, k_so, k_sh}, Strides{v_sp, v_so, v_sh},
                               Scales{}, bt_stride, page_size, nb * page_size, b, hkv,
                               group, d, scale, dtype, stream);
}

// The int8 branch: k/v pages (P, page_size, Hkv, D) int8 as above; row
// scales k_scales / v_scales (P, page_size) f32 with element strides for
// P and page_size; q and o f32 or bf16 (dtype).
extern "C" int repro_paged_flash_decode_int8(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* block_tables, const void* pos, void* o, long long k_sp,
    long long k_so, long long k_sh, long long v_sp, long long v_so, long long v_sh,
    long long ks_p, long long ks_o, long long vs_p, long long vs_o, long long bt_stride, int b,
    int nb, int page_size, int hkv, int group, int d, float scale, int dtype, void* stream) {
  const Scales sc{static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
                  ks_p, ks_o, vs_p, vs_o};
  return dispatch<true, true>(q, k_pages, v_pages, pos, block_tables, o,
                              Strides{k_sp, k_so, k_sh}, Strides{v_sp, v_so, v_sh}, sc,
                              bt_stride, page_size, nb * page_size, b, hkv, group, d, scale,
                              dtype, stream);
}
