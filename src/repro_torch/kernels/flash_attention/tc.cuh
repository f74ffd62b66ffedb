// Tensor-core building blocks of the bf16 flash kernels (sm_80 and on;
// built for sm_90a): 16-byte cp.async staging with zero fill, ldmatrix
// fragment loads, the m16n8k16 bf16 mma with fp32 sums, and the hi/lo
// split of an fp32 fragment into two bf16 fragments.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t, g = 0..7,
// t = 0..3), each register two bf16 with the lower column in the low half:
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                     a3 (g+8, 2t+8..)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16 x 8, f32):  c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// So the accumulators of two neighbouring n8 tiles are, packed in pairs,
// the A fragment of one k16 step (FlashAttention-2's register reuse: P and
// dS go from one product into the next without leaving registers).
#pragma once

#include "common.cuh"

namespace repro::tc {

// Shared-memory tiles are rows of D bf16 padded by 8 (16 bytes): the 8
// rows that one ldmatrix phase reads then start 4 banks apart and cover
// all 32 banks, free of conflicts.
template <int D> __host__ __device__ constexpr int pitch() { return D + 8; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously.  With pred false nothing is
// read (src-size 0) and the 16 bytes are zero-filled: rows that must not
// be read (past kv_len, past the sequence) become zeros, never NaN.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes, the same way (per-row f32 statistics)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of a (rows, D) bf16 slab with the given row
// stride (elements) into a padded shared tile; rows at or past limit are
// zero-filled.  Every thread of the block takes part.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int limit) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  static_assert((ROWS * kChunks) % THREADS == 0, "tile chunks split evenly");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < limit;
    const __nv_bfloat16* from = in ? src + (row0 + r) * row_stride + c * 8 : src;
    cp_async16(dst + r * pitch<D>() + c * 8, from, in);
  }
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// Lane addresses into a padded tile (P = pitch) whose rows run along M or
// N of the product:
//   a_row: the A fragment of rows r0..r0+15, columns c0..c0+15
//          (matrices: rows +0/+8 x columns +0/+8 -> a0..a3)
//   b_row: B fragments of two n8 tiles, rows n0..n0+15 of the tile being
//          the n index and columns c0..c0+15 the k index (K for Q.K^T):
//          r0, r1 = b0, b1 of n tile n0; r2, r3 = those of n0 + 8
//   b_col: B fragments (with .trans) of two n8 tiles when the tile's rows
//          run along k (V for P.V): rows k0..k0+15, columns n0..n0+15
template <int P>
__device__ __forceinline__ const __nv_bfloat16* a_row(const __nv_bfloat16* t, int r0, int c0,
                                                      int lane) {
  return t + (r0 + (lane & 15)) * P + c0 + (lane >> 4) * 8;
}

template <int P>
__device__ __forceinline__ const __nv_bfloat16* b_row(const __nv_bfloat16* t, int n0, int c0,
                                                      int lane) {
  return t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * P + c0 + ((lane >> 3) & 1) * 8;
}

template <int P>
__device__ __forceinline__ const __nv_bfloat16* b_col(const __nv_bfloat16* t, int k0, int n0,
                                                      int lane) {
  return t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + n0 + (lane >> 4) * 8;
}

// d += a * b: m16n8k16, bf16 inputs, fp32 sums (exact bf16 products)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as hi + lo with hi = bf16(x), lo = bf16(x - hi), both packed as
// a bf16 pair.  x - float(hi) is exact in fp32, and hi + lo gives back x to
// 2^-17 relative, where hi alone is off by up to 2^-9: the second product
// through lo is what keeps P.V, dS.K, P^T.dO and dS^T.Q at fp32 accuracy.
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The A fragments (hi, lo) of k16 step kk from accumulator tiles c[2kk],
// c[2kk + 1] (each 16 x 8, the layout above).
__device__ __forceinline__ void split_a(const float (&c0)[4], const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

// 2^x on the special function unit alone (ex2.approx.ftz: ~2 ulp, results
// below 2^-126 flushed to 0, 2^-inf = 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

}  // namespace repro::tc
