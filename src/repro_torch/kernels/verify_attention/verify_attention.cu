// k-token speculative verify attention for Hopper over the paged KV cache:
// every window position scored in one launch, online softmax, work
// bounded by the window's last position.
//
// Replaces: src/repro/kernels/verify_attention/verify_attention.py::
// paged_flash_verify (Pallas _verify_kernel over bf16/f32 pages, and over
// int8 pages with f32 row scales: its ks_ref/vs_ref dequant).
//
// What it computes: q (B, Hkv, T*G, D) holds T window positions x G
// grouped queries per KV head, rows t-major, so row r = t*G + g is the
// query at position pos + r/G and attends keys <= pos + r/G (causal within
// the window; every window row's K/V was written before the launch).
// Keys past the window's last position last = pos + T - 1 are neither
// loaded nor scored, and those V rows stay zero (fresh growth pages hold
// garbage and 0 * NaN would poison the sum).  Position t resolves through
// block_tables[b, min(t / page_size, last / page_size, NB - 1)], the
// Pallas index map's clamp (a dead slot's runaway pos clamps to the last
// table column).  A zero softmax sum finalizes as 1.  With int8 pages
// (cache type TC = int8_t, apart from q's T) each staged element is
// float(q8) * its row's scale, the scale read through the same clamped
// page lookup, so the dot runs on (k * s) . q as in the Pallas kernel.
//
// Bound on the H100: bytes.  Each cached K/V row up to last is read once
// against 4 * T * G flops per element (24 at qwen2-1.5b's G = 6 and
// spec_k = 4), far below the card's flop/byte balance; int8 pages read
// 1 B per element plus a 4 B scale per row for K and for V.  Design: the
// first port's paged decode kernel with the query block widened to the
// window.  One block per (batch row, KV head), one warp per query row, so
// a 32-key K/V tile staged in shared memory is read from device memory
// once for all T*G rows.  Lane j scores key j; the row's live limit is a
// lane mask; the row max and sum are __shfl_xor_sync butterflies (the
// paper's HW warp reduce); lane c owns output columns c, c+32, ...  Up to
// 32 rows in f32 need 49 KB of shared memory at D = 128, past the 48 KB
// static limit, so the buffers are dynamic and the launch raises the
// kernel's limit when it needs to.  The shared tiles hold f32 after the
// dequant, so int8 pages take the same 49 KB.
//
// Known limit: B * Hkv blocks (8 at batch 4 for qwen2-1.5b).  Splitting the
// KV axis across blocks with a combine pass, as decode_attention.cu does,
// is later work.
#include "common.cuh"

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBlockK = 32;   // keys per tile, one per lane
constexpr int kMaxRows = 32;  // T * G query rows, one warp each

struct Strides {
  long long p, o, h;  // page / in-page offset / head element strides
};

// int8 pages' row scales, (P, page_size) f32 each, with page / offset
// element strides (unused for float pages)
struct Scales {
  const float* k;
  const float* v;
  long long kp, ko, vp, vo;
};

constexpr size_t smem_bytes(int rows, int d) {
  // q_s[rows][D], k_s[32][D + 1] (+1: lane j reads row j conflict-free), v_s[32][D]
  return sizeof(float) * (static_cast<size_t>(rows) * d + kBlockK * (d + 1) + kBlockK * d);
}

template <typename T, typename TC, int D>
__global__ void __launch_bounds__(kMaxRows * 32)
verify_kernel(const T* __restrict__ q, const TC* __restrict__ k, const TC* __restrict__ v,
              const int* __restrict__ pos, const int* __restrict__ block_tables,
              T* __restrict__ o, Strides ks_, Strides vs_, Scales sc, long long bt_stride,
              int nb, int page_size, int hkv, int rows, int group, int t_window,
              float scale) {
  constexpr int C = D / 32;
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + rows * D;
  float* v_s = k_s + kBlockK * (D + 1);

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nthreads = blockDim.x;
  const int p = pos[b];
  const int last = p + t_window - 1;                 // the window's last position
  const int n_keys = min(last + 1, nb * page_size);  // keys loaded at all
  const int last_blk = min(last / page_size, nb - 1);
  const int limit = p + warp / group;                // this row's last live key

  const long long row = (static_cast<long long>(b) * hkv + h) * rows + warp;
  for (int c = lane; c < D; c += 32) q_s[warp * D + c] = repro::to_f32(q[row * D + c]);

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
        const int blk = min(kid / page_size, last_blk);
        const long long page = block_tables[b * bt_stride + blk];
        const int off = kid % page_size;
        kx = repro::to_f32(k[page * ks_.p + off * ks_.o + h * ks_.h + c]);
        vx = repro::to_f32(v[page * vs_.p + off * vs_.o + h * vs_.h + c]);
        if constexpr (kQuant) {
          kx *= sc.k[page * sc.kp + off * sc.ko];
          vx *= sc.v[page * sc.vp + off * sc.vo];
        }
      }
      k_s[j * (D + 1) + c] = kx;
      v_s[j * D + c] = vx;
    }
    __syncthreads();

    const int kid = kv0 + lane;
    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) s += q_s[warp * D + c] * k_s[lane * (D + 1) + c];
    s *= scale;
    const bool valid = kid <= limit && kid < n_keys;
    s = valid ? s : repro::kMaskValue;
    const float m_new = fmaxf(m, repro::warp_max(s));
    const float alpha = expf(m - m_new);
    const float pr = valid ? expf(s - m_new) : 0.f;
    l = alpha * l + repro::warp_sum(pr);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] *= alpha;
#pragma unroll 8
    for (int j = 0; j < kBlockK; ++j) {
      const float pj = __shfl_sync(repro::kFullMask, pr, j);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += pj * v_s[j * D + lane + 32 * c];
    }
    m = m_new;
  }

  const float safe = l == 0.f ? 1.f : l;
#pragma unroll
  for (int c = 0; c < C; ++c) o[row * D + lane + 32 * c] = repro::from_f32<T>(acc[c] / safe);
}

template <typename T, typename TC, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos, const int* bt,
                   void* o, Strides ks, Strides vs, Scales sc, long long bt_stride, int nb,
                   int page_size, int b, int hkv, int rows, int t_window, float scale,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(rows, D);
  if (bytes > 48 * 1024) {
    // above 48 KB a block gets dynamic shared memory only after opting in
    const cudaError_t e = cudaFuncSetAttribute(
        verify_kernel<T, TC, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxRows, D)));
    if (e != cudaSuccess) return e;
  }
  verify_kernel<T, TC, D><<<dim3(b, hkv), rows * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v), pos, bt,
      static_cast<T*>(o), ks, vs, sc, bt_stride, nb, page_size, hkv, rows, rows / t_window,
      t_window, scale);
  return cudaGetLastError();
}

// q's type T from dtype; the cache's type is T, or int8_t when kInt8
template <bool kInt8>
int dispatch(const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
             const void* pos, void* o, Strides ks, Strides vs, Scales sc, long long bt_stride,
             int b, int nb, int page_size, int hkv, int rows, int t_window, int d, float scale,
             int dtype, void* stream) {
  using BF = __nv_bfloat16;
  using CB = typename std::conditional<kInt8, int8_t, BF>::type;
  using CF = typename std::conditional<kInt8, int8_t, float>::type;
  if (b <= 0 || hkv <= 0) return static_cast<int>(cudaGetLastError());
  if (rows <= 0 || rows > kMaxRows || t_window <= 0 || rows % t_window != 0 ||
      (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(block_tables);
  cudaError_t e;
  if (dtype == repro::kBF16) {
    e = d == 128 ? launch<BF, CB, 128>(q, k_pages, v_pages, p, t, o, ks, vs, sc, bt_stride, nb, page_size, b, hkv, rows, t_window, scale, s)
                 : launch<BF, CB, 64>(q, k_pages, v_pages, p, t, o, ks, vs, sc, bt_stride, nb, page_size, b, hkv, rows, t_window, scale, s);
  } else {
    e = d == 128 ? launch<float, CF, 128>(q, k_pages, v_pages, p, t, o, ks, vs, sc, bt_stride, nb, page_size, b, hkv, rows, t_window, scale, s)
                 : launch<float, CF, 64>(q, k_pages, v_pages, p, t, o, ks, vs, sc, bt_stride, nb, page_size, b, hkv, rows, t_window, scale, s);
  }
  return static_cast<int>(e);
}

}  // namespace

// q (B, Hkv, T*G, D) and o contiguous; k/v pages (P, page_size, Hkv, D)
// with element strides for P, page_size and Hkv (D contiguous);
// block_tables (B, NB) int32 with row stride bt_stride; pos (B,) int32,
// the window's first position.  rows = T*G <= 32, D in {64, 128}.
extern "C" int repro_paged_flash_verify(const void* q, const void* k_pages,
                                        const void* v_pages, const void* block_tables,
                                        const void* pos, void* o, long long k_sp,
                                        long long k_so, long long k_sh, long long v_sp,
                                        long long v_so, long long v_sh, long long bt_stride,
                                        int b, int nb, int page_size, int hkv, int rows,
                                        int t_window, int d, float scale, int dtype,
                                        void* stream) {
  return dispatch<false>(q, k_pages, v_pages, block_tables, pos, o, Strides{k_sp, k_so, k_sh},
                         Strides{v_sp, v_so, v_sh}, Scales{}, bt_stride, b, nb, page_size,
                         hkv, rows, t_window, d, scale, dtype, stream);
}

// The int8 branch: k/v pages int8 as above; row scales k_scales /
// v_scales (P, page_size) f32 with element strides for P and page_size.
extern "C" int repro_paged_flash_verify_int8(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* block_tables, const void* pos, void* o, long long k_sp,
    long long k_so, long long k_sh, long long v_sp, long long v_so, long long v_sh,
    long long ks_p, long long ks_o, long long vs_p, long long vs_o, long long bt_stride, int b,
    int nb, int page_size, int hkv, int rows, int t_window, int d, float scale, int dtype,
    void* stream) {
  const Scales sc{static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
                  ks_p, ks_o, vs_p, vs_o};
  return dispatch<true>(q, k_pages, v_pages, block_tables, pos, o, Strides{k_sp, k_so, k_sh},
                        Strides{v_sp, v_so, v_sh}, sc, bt_stride, b, nb, page_size, hkv, rows,
                        t_window, d, scale, dtype, stream);
}
