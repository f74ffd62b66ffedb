// One-token GQA decode attention for Hopper over a dense or a paged KV
// cache: the KV axis split across blocks, then a combine pass.
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py::
// flash_decode (Pallas _decode_kernel) and ::paged_flash_decode (Pallas
// _paged_decode_kernel over bf16/f32 pages, and over int8 pages with f32
// row scales: the ks_ref/vs_ref multiplies of _decode_kernel).
//
// Bound on the H100: bytes.  Every cached K/V row up to pos is read once
// against 4 * G flops per element (G = 6 for qwen2-1.5b, 1 for
// OLMoE-1B-7B), ~50x below the card's flop/byte balance; int8 pages read
// 1 B per element plus one 4 B scale per row for K and for V.  The live
// K/V of a decode step is 1-11 MB, a few microseconds of the card's
// bandwidth, so what matters is how many bytes are in flight: the Pallas
// grid walks the KV axis in order on one core, and one block per (batch
// row, KV head) would leave most of the 132 SMs idle (8 blocks at
// qwen2's batch 4).
//
// Design: split.cuh's split kernel and combine pass, shared with the
// verify kernel, at a window of T = 1 (rows = G).  A row with n = min(pos +
// 1, n_keys_max) live keys cuts them into splits of split_keys(n, splits)
// keys, from the split count alone (ops.decode_splits), so dense and paged
// decode add the same products in the same order and agree bit for bit
// in f32.
#include "decode_attention/split.cuh"

namespace split = repro::split;

namespace {

template <typename TC> int smem_bytes(int d, int gr) {
  if (d == 128)
    return static_cast<int>(gr == 1 ? split::Smem<TC, 128, 1>::BYTES
                            : gr == 4 ? split::Smem<TC, 128, 4>::BYTES
                                      : split::Smem<TC, 128, 6>::BYTES);
  return static_cast<int>(gr == 1 ? split::Smem<TC, 64, 1>::BYTES
                          : gr == 4 ? split::Smem<TC, 64, 4>::BYTES
                                    : split::Smem<TC, 64, 6>::BYTES);
}

}  // namespace

// dynamic shared memory of a split kernel: cache elements of cache_bytes
// (1 int8, 2 bf16, 4 f32), head dim d, row block gr (1, 4 or 6)
extern "C" int repro_decode_smem_bytes(int cache_bytes, int d, int gr) {
  return cache_bytes == 1   ? smem_bytes<int8_t>(d, gr)
         : cache_bytes == 2 ? smem_bytes<__nv_bfloat16>(d, gr)
                            : smem_bytes<float>(d, gr);
}

// q (B, Hkv, G, D) and o contiguous; k/v (B, S, Hkv, D) with element
// strides for B, S and Hkv (D contiguous; bases and strides 16-byte
// aligned); pos (B,) int32; work: B * Hkv * splits * G * (D + 2) f32 of
// scratch for the partials.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* pos, void* o, long long k_sb, long long k_ss,
                                  long long k_sh, long long v_sb, long long v_ss,
                                  long long v_sh, int b, int s, int hkv, int group, int d,
                                  float scale, int dtype, void* work, int splits,
                                  void* stream) {
  const split::Args a{q, k, v, static_cast<const int*>(pos), nullptr, o,
                      static_cast<float*>(work), splits, {k_sb, k_ss, k_sh},
                      {v_sb, v_ss, v_sh}, {}, 0, 1, s, b, hkv, group, group, scale};
  return split::dispatch<false, false, false>(a, d, dtype, stream);
}

// q (B, Hkv, G, D) and o contiguous; k/v pages (P, page_size, Hkv, D) with
// element strides for P, page_size and Hkv; block_tables (B, NB) int32
// with row stride bt_stride; pos (B,) int32; work as above.
extern "C" int repro_paged_flash_decode(const void* q, const void* k_pages,
                                        const void* v_pages, const void* block_tables,
                                        const void* pos, void* o, long long k_sp,
                                        long long k_so, long long k_sh, long long v_sp,
                                        long long v_so, long long v_sh, long long bt_stride,
                                        int b, int nb, int page_size, int hkv, int group,
                                        int d, float scale, int dtype, void* work, int splits,
                                        void* stream) {
  const split::Args a{q, k_pages, v_pages, static_cast<const int*>(pos),
                      static_cast<const int*>(block_tables), o, static_cast<float*>(work),
                      splits, {k_sp, k_so, k_sh}, {v_sp, v_so, v_sh}, {}, bt_stride,
                      page_size, nb * page_size, b, hkv, group, group, scale};
  return split::dispatch<true, false, false>(a, d, dtype, stream);
}

// The int8 branch: k/v pages (P, page_size, Hkv, D) int8 as above; row
// scales k_scales / v_scales (P, page_size) f32 with element strides for
// P and page_size; q and o f32 or bf16 (dtype).
extern "C" int repro_paged_flash_decode_int8(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* block_tables, const void* pos, void* o, long long k_sp,
    long long k_so, long long k_sh, long long v_sp, long long v_so, long long v_sh,
    long long ks_p, long long ks_o, long long vs_p, long long vs_o, long long bt_stride, int b,
    int nb, int page_size, int hkv, int group, int d, float scale, int dtype, void* work,
    int splits, void* stream) {
  const split::Args a{q, k_pages, v_pages, static_cast<const int*>(pos),
                      static_cast<const int*>(block_tables), o, static_cast<float*>(work),
                      splits, {k_sp, k_so, k_sh}, {v_sp, v_so, v_sh},
                      {static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
                       ks_p, ks_o, vs_p, vs_o},
                      bt_stride, page_size, nb * page_size, b, hkv, group, group, scale};
  return split::dispatch<true, true, false>(a, d, dtype, stream);
}
