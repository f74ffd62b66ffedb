// k-token speculative verify attention for Hopper over the paged KV cache:
// every window position scored in one launch, the KV axis split across
// blocks, then a combine pass.
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
// block_tables[b, min(t / page_size, last / page_size)], the Pallas index
// map's clamp (a dead slot's runaway pos clamps to the last table column).
// A zero softmax sum finalizes as 1.  With int8 pages each element is
// float(q8) * its row's scale when read, the scale staged through the same
// page lookup, so the dot runs on (k * s) . q as in the Pallas kernel.
//
// Bound on the H100: bytes.  Each cached K/V row up to last is read once
// against 4 * T * G flops per element (24 at qwen2-1.5b's G = 6 and
// spec_k = 4), far below the card's flop/byte balance; int8 pages read
// 1 B per element plus a 4 B scale per row for K and for V.
//
// Design: verify is a windowed decode, so it runs decode's own split
// kernel and combine pass (decode_attention/split.cuh) with the window T:
// rows = T*G query rows a KV head in register blocks of GR = 6 (4 row
// blocks at qwen2's T*G = 24, one window position each), the window's
// live keys n = min(pos + T, NB * page_size) cut into splits of
// split_keys(n, splits) keys, and row r's scores masked past pos + r/G.
// At T = 1 the arithmetic is paged decode's, on the same split count
// (ops.verify_splits), so the two agree bit for bit in f32.  For T > 1
// the split count also counts the row blocks in the grid's target of two
// blocks an SM: at qwen2's T*G = 24 over 576 keys that is 9 splits of 64
// keys (288 blocks), which ran in 0.0142 ms on one H100 at 700 W against
// 0.0163 for decode's 18 one-tile splits (576 blocks, 2.2 waves;
// src/repro_torch/bench/kernel_ab.py).
//
// The long-window branch (T*G > 32 query rows a KV head, past the split
// kernel's register blocks): a shared prefix's suffix prefill, T a
// 16-token bucket of the suffix, so 96 to 3072 rows at qwen2's G = 6.
// The work is prefill-shaped, bound by operations (4 * D flops for each
// live (row, key) pair against each K/V row read once a block of rows),
// so bf16 q takes the flash forward's tensor-core tile (flash_attention.cu's
// flash_fwd_tc_kernel on flash_attention/tc.cuh) with the verify mask:
// a block of 4 warps owns 64 query rows of one (b, KV head), 16 a warp.
// A suffix prefill has few row blocks (48 at T 256 over qwen2's 2 KV
// heads, on 132 SMs), so the key axis is split across blocks as decode's
// is: the grid is (row blocks, B * Hkv, splits), splits from the shapes
// alone (the wrapper's verify_long_splits), and split s takes keys
// [s * chunk, (s + 1) * chunk) of the window's n = min(pos + T, NB *
// page_size) live keys, chunk = split_keys(n, splits), the combine pass's
// own rule.  Each block writes its rows' partials (m, l, unnormalized acc)
// in split.cuh's layout, and split.cuh's decode_combine_kernel reduces
// them unchanged, a programmatic dependent launch; at one split the
// kernel finalizes its rows in place, with no scratch and no combine.  A
// block walks its split in 64-key K/V tiles through a 2-stage cp.async
// ring, each tile gathered row by row through the block table (16-token
// pages give 4 pages a tile; each thread resolves the table entry of the
// rows it copies).  Rows at or past the block's key limit (its split's
// end, the window's, its last row's) are zero-filled (src-size 0), so no
// key past the window's last position pos + T - 1 is loaded and those V
// rows are zeros.  S = Q.K^T is m16n8k16 bf16 mma.sync with fp32 sums;
// row r's limit pos + r/G is computed once a fragment row, since G (6)
// need not divide the 16 rows of a warp, whose rows then straddle window
// positions; a tile is masked only where it reaches past a row's limit
// or the split's end (masked scores kMaskValue, their p zeroed by the
// mask); P enters P.V as bf16 hi + lo, as in the flash forward.  Scores
// run in log2 units, and a partial's m is written as m * ln 2 for the
// combine's expf: the two roundings move a combine factor by at most
// (|m_s| + |M|) * ln 2 * 2^-24 relative.  A row whose limit lies before
// its split's keys (an early window position in a late split) leaves (m =
// kMaskValue * ln 2, l = 0, acc = 0), weighed by exactly 0, and a block
// whose split starts past its own last row's limit writes (-inf, 0, 0)
// and stops.  Key tiles past the block's last row's limit are neither
// loaded nor computed, and the row blocks with the most keys launch
// first.  int8 pages under bf16 q take the same tile: each tile is staged
// as int8 (16-byte pieces) with its 64 K and 64 V row scales, then widened
// to bf16 into the padded tile that ldmatrix reads (exact: |q8| <= 127);
// the K scale multiplies the score column after the product, s_j =
// scale * (q . k8_j) * ks_j, and the V scale multiplies P before its hi +
// lo split, p_j * vs_j, the row sum l adding p_j unscaled.  f32 pages (the
// fp32 controls) and int8 pages under f32 q take a CUDA-core kernel
// instead, split the same way: 16 rows a block, 4 a warp, 32-key tiles,
// lane j scoring key j; int8 elements are dequantized while staged, as
// float(q8) * the row's scale, as the plain version dequantizes.
#include "decode_attention/split.cuh"

namespace split = repro::split;

// q (B, Hkv, T*G, D) and o contiguous; k/v pages (P, page_size, Hkv, D)
// with element strides for P, page_size and Hkv (D contiguous; bases and
// strides 16-byte aligned); block_tables (B, NB) int32 with row stride
// bt_stride; pos (B,) int32, the window's first position.  rows = T*G <=
// 32, D in {64, 128}; work: B * Hkv * splits * rows * (D + 2) f32 of
// scratch for the partials.
extern "C" int repro_paged_flash_verify(const void* q, const void* k_pages,
                                        const void* v_pages, const void* block_tables,
                                        const void* pos, void* o, long long k_sp,
                                        long long k_so, long long k_sh, long long v_sp,
                                        long long v_so, long long v_sh, long long bt_stride,
                                        int b, int nb, int page_size, int hkv, int rows,
                                        int t_window, int d, float scale, int dtype, void* work,
                                        int splits, void* stream) {
  if (t_window <= 0 || rows % t_window != 0) return static_cast<int>(cudaErrorInvalidValue);
  const split::Args a{q, k_pages, v_pages, static_cast<const int*>(pos),
                      static_cast<const int*>(block_tables), o, static_cast<float*>(work),
                      splits, {k_sp, k_so, k_sh}, {v_sp, v_so, v_sh}, {}, bt_stride,
                      page_size, nb * page_size, b, hkv, rows, rows / t_window, scale};
  return split::dispatch<true, false, true>(a, d, dtype, stream);
}

// The int8 branch: k/v pages int8 as above; row scales k_scales /
// v_scales (P, page_size) f32 with element strides for P and page_size.
extern "C" int repro_paged_flash_verify_int8(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* block_tables, const void* pos, void* o, long long k_sp,
    long long k_so, long long k_sh, long long v_sp, long long v_so, long long v_sh,
    long long ks_p, long long ks_o, long long vs_p, long long vs_o, long long bt_stride, int b,
    int nb, int page_size, int hkv, int rows, int t_window, int d, float scale, int dtype,
    void* work, int splits, void* stream) {
  if (t_window <= 0 || rows % t_window != 0) return static_cast<int>(cudaErrorInvalidValue);
  const split::Args a{q, k_pages, v_pages, static_cast<const int*>(pos),
                      static_cast<const int*>(block_tables), o, static_cast<float*>(work),
                      splits, {k_sp, k_so, k_sh}, {v_sp, v_so, v_sh},
                      {static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
                       ks_p, ks_o, vs_p, vs_o},
                      bt_stride, page_size, nb * page_size, b, hkv, rows, rows / t_window,
                      scale};
  return split::dispatch<true, true, true>(a, d, dtype, stream);
}

// ---------------------------------------------------------------------------
// the long-window branch: T*G > 32 rows a KV head
// ---------------------------------------------------------------------------

namespace {

namespace tc = repro::tc;
using bf16 = __nv_bfloat16;

// one call's operands; k_scales / v_scales are null for float pages; part
// is the partials' scratch in split.cuh's layout, null at one split (the
// kernel then finalizes its rows in place)
struct Window {
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* bt;
  const int* pos;
  float* part;
  long long k_sp, k_so, k_sh, v_sp, v_so, v_sh;
  long long ks_p, ks_o, vs_p, vs_o;
  long long bt_stride;
  int page_size, nb, hkv, rows, group, t_window, splits;
  float scale;
};

// the keys that split `split` of a block of query rows [q0, q0 + n) reads:
// of the window's live keys n_keys = min(pos + T, NB * page_size), the
// split's [k0, k_end) (split_keys(n_keys, splits) keys a split, the
// combine pass's own rule), cut at the block's last row's limit pos + r /
// G into [k0, kv_end)
struct Span {
  int p, n_keys, k0, k_end, kv_end, last_blk;
};

__device__ __forceinline__ Span window_keys(const Window& a, int b, int q0, int n, int split) {
  Span s;
  s.p = a.pos[b];
  s.n_keys = max(0, min(s.p + a.t_window, a.nb * a.page_size));
  const int chunk = split::split_keys(s.n_keys, a.splits);
  s.k0 = split * chunk;
  s.k_end = min(s.k0 + chunk, s.n_keys);
  const int last_row = min(q0 + n, a.rows) - 1;
  s.kv_end = min(s.k_end, s.p + last_row / a.group + 1);
  s.last_blk = (s.p + a.t_window - 1) / a.page_size;
  return s;
}

// the page and offset of key kj: the block table entry min(kj /
// page_size, last_blk), the Pallas index map's clamp
__device__ __forceinline__ void key_row(const Window& a, const Span& s, int b, int kj,
                                        long long& page, int& off) {
  page = a.bt[b * a.bt_stride + min(kj / a.page_size, s.last_blk)];
  off = kj % a.page_size;
}

// partial row r of (bh, split): acc at part[row * D], (m, l) at
// ml[row * 2], after the B * Hkv * splits * rows rows of acc
__device__ __forceinline__ long long part_row(const Window& a, int bh, int split, int r) {
  return (static_cast<long long>(bh) * a.splits + split) * a.rows + r;
}

template <int D>
__device__ __forceinline__ float* part_ml(const Window& a) {
  return a.part + static_cast<long long>(gridDim.y) * a.splits * a.rows * D;
}

// a block whose split starts past its own last row's limit, but inside the
// window's keys (so the combine reads it): (m, l, acc) = (-inf, 0, 0)
template <int D>
__device__ void empty_partial(const Window& a, int bh, int split, int q0, int n) {
  const int mine = min(n, a.rows - q0);
  const long long row0 = part_row(a, bh, split, q0);
  float4* acc = reinterpret_cast<float4*>(a.part + row0 * D);
  for (int i = threadIdx.x; i < mine * D / 4; i += blockDim.x)
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* ml = part_ml<D>(a);
  for (int i = threadIdx.x; i < mine; i += blockDim.x) {
    ml[(row0 + i) * 2] = -INFINITY;
    ml[(row0 + i) * 2 + 1] = 0.f;
  }
}

constexpr int kLwThreads = 128;  // 4 warps
constexpr int kLwBlockQ = 64;    // tensor cores: 16 query rows a warp
constexpr int kLwBlockK = 64;    // keys a staged K/V tile
static_assert(kLwThreads == 2 * kLwBlockK, "a thread a K or V row scale");

// the tensor-core kernel's shared memory: the q tile, a 2-stage ring of K/V
// tiles in the pages' type (bf16 rows padded for ldmatrix; int8 rows whole,
// plus their K and V row scales), and for int8 pages the current K/V tile
// widened to bf16
template <typename TC, int D>
struct LwSmem {
  static constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  static constexpr int P = tc::pitch<D>();
  static constexpr int ROW = kQuant ? D : P;  // a staged row's elements
  static constexpr size_t Q = sizeof(bf16) * kLwBlockQ * P;
  static constexpr size_t TILE = sizeof(TC) * kLwBlockK * ROW;
  static constexpr size_t SCALES = kQuant ? 2 * kLwBlockK * sizeof(float) : 0;
  static constexpr size_t STAGE = 2 * TILE + SCALES;
  static constexpr size_t WIDE = kQuant ? 2 * sizeof(bf16) * kLwBlockK * P : 0;
  static constexpr size_t BYTES = Q + 2 * STAGE + WIDE;
};

// one 64-key tile of K and V rows from key kv0 into stage `st`, gathered
// through the block table in 16-byte pieces (int8 pages: and each row's
// two scales); rows at or past kv_end are zero-filled (src-size 0)
template <typename TC, int D>
__device__ __forceinline__ void stage_kv(unsigned char* st, const Window& a, const Span& s,
                                         int b, int h, int kv0) {
  using S = LwSmem<TC, D>;
  constexpr int VEC = 16 / sizeof(TC);             // elements a piece
  constexpr int kChunks = D / VEC;                 // pieces a row
  constexpr int kRowsPass = kLwThreads / kChunks;  // rows a pass copies
  static_assert(kLwBlockK % kRowsPass == 0, "whole rows a pass");
  TC* k_s = reinterpret_cast<TC*>(st);
  TC* v_s = reinterpret_cast<TC*>(st + S::TILE);
  const int c = threadIdx.x % kChunks;
  const TC* k = static_cast<const TC*>(a.k);
  const TC* v = static_cast<const TC*>(a.v);
#pragma unroll
  for (int j = 0; j < kLwBlockK / kRowsPass; ++j) {
    const int r = threadIdx.x / kChunks + j * kRowsPass;
    const int kj = kv0 + r;
    const bool in = kj < s.kv_end;
    long long ko = 0, vo = 0;
    if (in) {
      long long page;
      int off;
      key_row(a, s, b, kj, page, off);
      ko = page * a.k_sp + off * a.k_so + h * a.k_sh;
      vo = page * a.v_sp + off * a.v_so + h * a.v_sh;
    }
    tc::cp_async16(k_s + r * S::ROW + c * VEC, k + ko + c * VEC, in);
    tc::cp_async16(v_s + r * S::ROW + c * VEC, v + vo + c * VEC, in);
  }
  if constexpr (S::kQuant) {  // threads 0..63 the K scales, 64..127 the V scales
    float* scl = reinterpret_cast<float*>(st + 2 * S::TILE);
    const int r = threadIdx.x % kLwBlockK;
    const bool is_v = threadIdx.x >= kLwBlockK;
    const int kj = kv0 + r;
    const bool in = kj < s.kv_end;
    const float* src = a.ks;
    if (in) {
      long long page;
      int off;
      key_row(a, s, b, kj, page, off);
      src = is_v ? a.vs + page * a.vs_p + off * a.vs_o : a.ks + page * a.ks_p + off * a.ks_o;
    }
    tc::cp_async4(scl + is_v * kLwBlockK + r, src, in);
  }
}

// four int8 values (one word) as two bf16 pairs, exactly (|q8| <= 128):
// byte x becomes the float 2^23 + (x ^ 0x80) less 2^23 + 128
__device__ __forceinline__ void widen4_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(0x4B000000u | ((u >> (8 * i)) & 0xFFu)) - 8388736.f;
  lo = tc::bits(__floats2bfloat162_rn(f[0], f[1]));
  hi = tc::bits(__floats2bfloat162_rn(f[2], f[3]));
}

// a staged int8 K/V tile widened to bf16 into the padded tiles that
// ldmatrix reads; every thread takes part
template <int D>
__device__ __forceinline__ void widen_kv(bf16* k_w, bf16* v_w, const unsigned char* st) {
  constexpr int P = tc::pitch<D>();
  constexpr int kPieces = D / 16;  // 16 int8 a piece
  constexpr int N = 2 * kLwBlockK * kPieces;
  static_assert(N % kLwThreads == 0, "pieces split evenly");
#pragma unroll
  for (int j = 0; j < N / kLwThreads; ++j) {
    const int i = threadIdx.x + j * kLwThreads;
    const int is_v = i / (kLwBlockK * kPieces);
    const int r = i / kPieces % kLwBlockK, c = i % kPieces;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(st + (is_v * kLwBlockK + r) * D + c * 16);
    uint4 w0, w1;
    widen4_bf16(raw.x, w0.x, w0.y);
    widen4_bf16(raw.y, w0.z, w0.w);
    widen4_bf16(raw.z, w1.x, w1.y);
    widen4_bf16(raw.w, w1.z, w1.w);
    uint4* dst = reinterpret_cast<uint4*>((is_v ? v_w : k_w) + r * P + c * 16);
    dst[0] = w0;
    dst[1] = w1;
  }
}

// bf16 q over bf16 pages (TC = bf16) or int8 pages (TC = int8_t): the
// flash forward's tensor-core tile with the window's mask, over one split
// of the keys.  q (B, Hkv, rows, D), o likewise, both contiguous.
template <typename TC, int D>
__global__ void __launch_bounds__(kLwThreads)
verify_long_tc_kernel(const bf16* __restrict__ q, bf16* __restrict__ o, Window a) {
  using S = LwSmem<TC, D>;
  constexpr bool kQuant = S::kQuant;
  constexpr int P = S::P;
  constexpr int KD = D / 16;         // k16 steps over the head dim
  constexpr int ND = D / 8;          // n8 tiles of the output row
  constexpr int NK = kLwBlockK / 8;  // n8 tiles of a score tile
  extern __shared__ __align__(16) unsigned char lw_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(lw_smem);  // [kLwBlockQ][P]
  unsigned char* ring = lw_smem + S::Q;          // [2][STAGE]
  bf16* k_w = reinterpret_cast<bf16*>(ring + 2 * S::STAGE);  // int8: [kLwBlockK][P]
  bf16* v_w = k_w + kLwBlockK * P;

  // t-major rows: the last row blocks see the most keys, and go first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kLwBlockQ;
  const int bh = blockIdx.y, b = bh / a.hkv, h = bh % a.hkv, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row, column pair
  const int r0 = warp * 16;                // the warp's rows in the tile
  const long long qrow0 = static_cast<long long>(bh) * a.rows;

  tc::load_tile<kLwBlockQ, D, kLwThreads>(q_s, q + qrow0 * D, D, q0, a.rows);
  // the combine pass may launch now; it waits for this grid's partials
  asm volatile("griddepcontrol.launch_dependents;");
  const Span s = window_keys(a, b, q0, kLwBlockQ, split);
  if (a.part != nullptr && s.kv_end <= s.k0) {
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    // past the window's keys the combine reads nothing of this split
    if (s.k0 < s.n_keys) empty_partial<D>(a, bh, split, q0, kLwBlockQ);
    return;
  }
  const int n_tiles = (s.kv_end - s.k0 + kLwBlockK - 1) / kLwBlockK;
  if (n_tiles > 0) stage_kv<TC, D>(ring, a, s, b, h, s.k0);
  tc::cp_async_commit();

  // the limits of this lane's two fragment rows, and of the warp's first
  // row (the least of its 16): a tile wholly at or below it, and inside
  // the split, needs no mask for this warp
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lim[i] = s.p + (q0 + r0 + g + 8 * i) / a.group;
  const int warp_lim = s.p + (q0 + r0) / a.group;

  const float scale2 = a.scale * tc::kLog2e;  // scores in log2 units
  float m[2] = {-INFINITY, -INFINITY};        // rows g and g + 8 of the warp
  float l[2] = {0.f, 0.f};                    // this lane's part of the row sums
  float acc[ND][4] = {};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles)  // the next tile streams in while this one computes
      stage_kv<TC, D>(ring + ((t + 1) & 1) * S::STAGE, a, s, b, h,
                      s.k0 + (t + 1) * kLwBlockK);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const unsigned char* st = ring + (t & 1) * S::STAGE;
    const bf16* ks = reinterpret_cast<const bf16*>(st);
    const bf16* vs = ks + kLwBlockK * P;
    const float* scl = reinterpret_cast<const float*>(st + 2 * S::TILE);  // int8: [K|V][key]
    if constexpr (kQuant) {
      widen_kv<D>(k_w, v_w, st);
      __syncthreads();
      ks = k_w;
      vs = v_w;
    }

    float sc[NK][4] = {};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      tc::ldmatrix_x4(qa, tc::a_row<P>(q_s, r0, kk * 16, lane));
#pragma unroll
      for (int nn = 0; nn < NK; nn += 2) {
        uint32_t bk[4];
        tc::ldmatrix_x4(bk, tc::b_row<P>(ks, nn * 8, kk * 16, lane));
        tc::mma(sc[nn], qa, bk[0], bk[1]);
        tc::mma(sc[nn + 1], qa, bk[2], bk[3]);
      }
    }

    const int kv0 = s.k0 + t * kLwBlockK;
    const bool edge = kv0 + kLwBlockK - 1 > warp_lim || kv0 + kLwBlockK > s.k_end;
    auto live = [&](int nt, int e) {
      const int kj = kv0 + nt * 8 + 2 * t4 + (e & 1);
      return kj < s.k_end && kj <= lim[e >> 1];
    };
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      float2 ksc = make_float2(1.f, 1.f);  // int8: the K rows' scales, after the product
      if constexpr (kQuant) ksc = *reinterpret_cast<const float2*>(scl + nt * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nt][e];
        if constexpr (kQuant) x *= e & 1 ? ksc.y : ksc.x;
        x *= scale2;
        if (edge && !live(nt, e)) x = repro::kMaskValue;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = repro::quad_max(mx[i]);
      alpha[i] = tc::exp2_fast(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      float2 vsc = make_float2(1.f, 1.f);  // int8: the V rows' scales, into P
      if constexpr (kQuant)
        vsc = *reinterpret_cast<const float2*>(scl + kLwBlockK + nt * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = tc::exp2_fast(sc[nt][e] - mx[e >> 1]);
        if (edge && !live(nt, e)) p = 0.f;  // set by the mask, not left to underflow
        l[e >> 1] += p;                     // the row sum takes p unscaled
        if constexpr (kQuant) p *= e & 1 ? vsc.y : vsc.x;
        sc[nt][e] = p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V with P = hi + lo; V's rows run along k
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      uint32_t ph[4], pl[4];
      tc::split_a(sc[2 * kk], sc[2 * kk + 1], ph, pl);
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t bv[4];
        tc::ldmatrix_x4_trans(bv, tc::b_col<P>(vs, kk * 16, dn * 8, lane));
        tc::mma(acc[dn], ph, bv[0], bv[1]);
        tc::mma(acc[dn + 1], ph, bv[2], bv[3]);
        tc::mma(acc[dn], pl, bv[0], bv[1]);
        tc::mma(acc[dn + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next copy refills it
  }
  tc::cp_async_wait<0>();

  float* ml = a.part != nullptr ? part_ml<D>(a) : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = repro::quad_sum(l[i]);
    const int qi = q0 + r0 + g + 8 * i;
    if (qi >= a.rows) continue;
    if (ml != nullptr) {  // the split's partial, unnormalized; m in natural units
      const long long row = part_row(a, bh, split, qi);
      float* prow = a.part + row * D;
#pragma unroll
      for (int dt = 0; dt < ND; ++dt)
        *reinterpret_cast<float2*>(prow + dt * 8 + 2 * t4) =
            make_float2(acc[dt][2 * i], acc[dt][2 * i + 1]);
      if (t4 == 0) {
        ml[row * 2] = m[i] * tc::kLn2;
        ml[row * 2 + 1] = li;
      }
      continue;
    }
    const float safe = li == 0.f ? 1.f : li;
    bf16* orow = o + (qrow0 + qi) * D;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[dt][2 * i] / safe, acc[dt][2 * i + 1] / safe);
    }
  }
}

constexpr int kLcRowsWarp = 4;                 // CUDA cores: query rows a warp
constexpr int kLcBlockQ = kLcRowsWarp * 4;     // 16 rows a block
constexpr int kLcBlockK = 32;                  // one key a lane

// f32 pages (T = TC = float) and int8 pages under f32 q (TC = int8_t):
// CUDA cores, every product in f32 as the plain version computes it, over
// one split of the keys
template <typename T, typename TC, int D>
__global__ void __launch_bounds__(kLwThreads)
verify_long_core_kernel(const T* __restrict__ q, T* __restrict__ o, Window a) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  constexpr int C = D / 32;  // output columns a lane
  __shared__ float q_s[kLcBlockQ][D];
  __shared__ float k_s[kLcBlockK][D + 1];  // +1: lane j reads row j conflict-free
  __shared__ float v_s[kLcBlockK][D];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kLcBlockQ;
  const int bh = blockIdx.y, b = bh / a.hkv, h = bh % a.hkv, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long qrow0 = static_cast<long long>(bh) * a.rows;
  const TC* k = static_cast<const TC*>(a.k);
  const TC* v = static_cast<const TC*>(a.v);

  for (int i = threadIdx.x; i < kLcBlockQ * D; i += kLwThreads) {
    const int r = i / D, c = i % D;
    q_s[r][c] = q0 + r < a.rows ? repro::to_f32(q[(qrow0 + q0 + r) * D + c]) : 0.f;
  }
  asm volatile("griddepcontrol.launch_dependents;");
  const Span s = window_keys(a, b, q0, kLcBlockQ, split);
  if (a.part != nullptr && s.kv_end <= s.k0) {
    if (s.k0 < s.n_keys) empty_partial<D>(a, bh, split, q0, kLcBlockQ);
    return;
  }
  int lim[kLcRowsWarp];
  float m[kLcRowsWarp], l[kLcRowsWarp], acc[kLcRowsWarp][C];
#pragma unroll
  for (int i = 0; i < kLcRowsWarp; ++i) {
    lim[i] = s.p + (q0 + warp * kLcRowsWarp + i) / a.group;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (s.kv_end - s.k0 + kLcBlockK - 1) / kLcBlockK;
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = s.k0 + t * kLcBlockK;
    __syncthreads();  // the previous tile is consumed (and q_s is in)
    for (int jr = warp; jr < kLcBlockK; jr += 4) {  // a warp a key row
      const int kj = kv0 + jr;
      const bool in = kj < s.kv_end;
      long long ko = 0, vo = 0;
      float ksc = 1.f, vsc = 1.f;
      if (in) {
        long long page;
        int off;
        key_row(a, s, b, kj, page, off);
        ko = page * a.k_sp + off * a.k_so + h * a.k_sh;
        vo = page * a.v_sp + off * a.v_so + h * a.v_sh;
        if constexpr (kQuant) {
          ksc = a.ks[page * a.ks_p + off * a.ks_o];
          vsc = a.vs[page * a.vs_p + off * a.vs_o];
        }
      }
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        const int c = lane + 32 * cc;
        float kx = in ? repro::to_f32(k[ko + c]) : 0.f;
        float vx = in ? repro::to_f32(v[vo + c]) : 0.f;
        if constexpr (kQuant) kx *= ksc, vx *= vsc;
        k_s[jr][c] = kx;
        v_s[jr][c] = vx;
      }
    }
    __syncthreads();

    const int kid = kv0 + lane;
#pragma unroll
    for (int i = 0; i < kLcRowsWarp; ++i) {
      const int r = warp * kLcRowsWarp + i;
      float sc = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) sc = fmaf(q_s[r][c], k_s[lane][c], sc);
      const bool valid = kid < s.k_end && kid <= lim[i];
      sc = valid ? sc * a.scale : repro::kMaskValue;
      const float m_new = fmaxf(m[i], repro::warp_max(sc));
      const float alpha = expf(m[i] - m_new);
      const float p = valid ? expf(sc - m_new) : 0.f;
      l[i] = alpha * l[i] + repro::warp_sum(p);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
#pragma unroll 8
      for (int j = 0; j < kLcBlockK; ++j) {
        const float pj = __shfl_sync(repro::kFullMask, p, j);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pj, v_s[j][lane + 32 * c], acc[i][c]);
      }
      m[i] = m_new;
    }
  }

  float* ml = a.part != nullptr ? part_ml<D>(a) : nullptr;
#pragma unroll
  for (int i = 0; i < kLcRowsWarp; ++i) {
    const int qi = q0 + warp * kLcRowsWarp + i;
    if (qi >= a.rows) continue;
    if (ml != nullptr) {  // the split's partial, unnormalized
      const long long row = part_row(a, bh, split, qi);
#pragma unroll
      for (int c = 0; c < C; ++c) a.part[row * D + lane + 32 * c] = acc[i][c];
      if (lane == 0) {
        ml[row * 2] = m[i];
        ml[row * 2 + 1] = l[i];
      }
      continue;
    }
    const float safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < C; ++c)
      o[(qrow0 + qi) * D + lane + 32 * c] = repro::from_f32<T>(acc[i][c] / safe);
  }
}

// split.cuh's combine pass over the partials into o (q's type T), with the
// window's rows; nothing at one split, where the kernel finalized them
template <typename T, int D>
cudaError_t combine(void* o, const Window& a, int b, cudaStream_t st) {
  if (a.part == nullptr) return cudaSuccess;
  split::Args c = {};
  c.pos = a.pos;
  c.o = o;
  c.part = a.part;
  c.splits = a.splits;
  c.n_keys_max = a.nb * a.page_size;
  c.b = b;
  c.hkv = a.hkv;
  c.rows = a.rows;
  c.group = a.group;
  return split::launch_combine<T, D, true>(c, st);
}

template <typename TC, int D>
cudaError_t launch_long_tc(const void* q, void* o, const Window& a, int b, cudaStream_t st) {
  constexpr size_t bytes = LwSmem<TC, D>::BYTES;  // above 48 KB: opt in
  cudaError_t e = cudaFuncSetAttribute(verify_long_tc_kernel<TC, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.rows + kLwBlockQ - 1) / kLwBlockQ, b * a.hkv, a.splits);
  verify_long_tc_kernel<TC, D><<<grid, kLwThreads, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<bf16*>(o), a);
  e = cudaGetLastError();
  return e != cudaSuccess ? e : combine<bf16, D>(o, a, b, st);
}

template <typename T, typename TC, int D>
cudaError_t launch_long_core(const void* q, void* o, const Window& a, int b, cudaStream_t st) {
  const dim3 grid((a.rows + kLcBlockQ - 1) / kLcBlockQ, b * a.hkv, a.splits);
  verify_long_core_kernel<T, TC, D><<<grid, kLwThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<T*>(o), a);
  const cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? e : combine<T, D>(o, a, b, st);
}

// q's type from dtype; int8 pages when a.ks is set, else pages of q's
// type.  bf16 q runs the tensor-core kernel (bf16 or int8 pages), f32 q
// the CUDA-core kernel.
int long_dispatch(const void* q, void* o, Window a, int b, int d, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || a.hkv <= 0 || a.rows <= 0) return 0;
  if (a.t_window <= 0 || a.rows % a.t_window != 0 || (d != 64 && d != 128) ||
      b * a.hkv > 65535 || a.page_size <= 0 || a.nb <= 0 || a.splits <= 0 ||
      a.splits > split::kMaxSplits || (a.splits > 1 && a.part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.group = a.rows / a.t_window;
  if (a.splits == 1) a.part = nullptr;  // one split finalizes in place
  const bool bf = dtype == repro::kBF16;
  cudaError_t e;
  if (a.ks != nullptr) {
    if (bf)
      e = d == 128 ? launch_long_tc<int8_t, 128>(q, o, a, b, st)
                   : launch_long_tc<int8_t, 64>(q, o, a, b, st);
    else
      e = d == 128 ? launch_long_core<float, int8_t, 128>(q, o, a, b, st)
                   : launch_long_core<float, int8_t, 64>(q, o, a, b, st);
  } else if (bf) {
    e = d == 128 ? launch_long_tc<bf16, 128>(q, o, a, b, st)
                 : launch_long_tc<bf16, 64>(q, o, a, b, st);
  } else {
    e = d == 128 ? launch_long_core<float, float, 128>(q, o, a, b, st)
                 : launch_long_core<float, float, 64>(q, o, a, b, st);
  }
  return static_cast<int>(e);
}

}  // namespace

// The long-window branch, float pages of q's type: q (B, Hkv, rows, D) and
// o contiguous, rows = T*G of any size; pages, strides, block_tables and
// pos as repro_paged_flash_verify takes them (bf16: page and q bases and
// row strides 16-byte aligned).  splits: the key axis's splits (the
// wrapper's verify_long_splits); work: B * Hkv * splits * rows * (D + 2)
// f32 of scratch for the partials, unused (may be null) at one split.
extern "C" int repro_paged_flash_verify_long(
    const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
    const void* pos, void* o, long long k_sp, long long k_so, long long k_sh, long long v_sp,
    long long v_so, long long v_sh, long long bt_stride, int b, int nb, int page_size,
    int hkv, int rows, int t_window, int d, float scale, int dtype, void* work, int splits,
    void* stream) {
  const Window a{k_pages, v_pages, nullptr, nullptr, static_cast<const int*>(block_tables),
                 static_cast<const int*>(pos), static_cast<float*>(work), k_sp, k_so, k_sh,
                 v_sp, v_so, v_sh, 0, 0, 0, 0, bt_stride, page_size, nb, hkv, rows, 0,
                 t_window, splits, scale};
  return long_dispatch(q, o, a, b, d, dtype, stream);
}

// ... and int8 pages with their row scales (P, page_size) f32: under bf16
// q on the tensor cores, the scales folded into the scores and into P;
// under f32 q dequantized while staged
extern "C" int repro_paged_flash_verify_long_int8(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* block_tables, const void* pos, void* o, long long k_sp,
    long long k_so, long long k_sh, long long v_sp, long long v_so, long long v_sh,
    long long ks_p, long long ks_o, long long vs_p, long long vs_o, long long bt_stride, int b,
    int nb, int page_size, int hkv, int rows, int t_window, int d, float scale, int dtype,
    void* work, int splits, void* stream) {
  if (k_scales == nullptr || v_scales == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Window a{k_pages, v_pages, static_cast<const float*>(k_scales),
                 static_cast<const float*>(v_scales), static_cast<const int*>(block_tables),
                 static_cast<const int*>(pos), static_cast<float*>(work), k_sp, k_so, k_sh,
                 v_sp, v_so, v_sh, ks_p, ks_o, vs_p, vs_o, bt_stride, page_size, nb, hkv,
                 rows, 0, t_window, splits, scale};
  return long_dispatch(q, o, a, b, d, dtype, stream);
}
