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
