// Flash-attention backward for Hopper, GQA-grouped, with per-row valid
// length: dq, dk, dv in fp32 from q, k, v, dO and the forward's lse plus
// delta = rowsum(dO * O).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_bwd, both of its Pallas kernels (_dq_kernel and
// _dkv_kernel), and the K/V head expansion of ops.py::flash_mha, whose
// jnp.repeat exists so that the group sum of dk/dv falls out of the
// repeat's transpose.  Here query head h reads KV head h / G directly.
//
// Two kernels behind one entry point, as in the Pallas function; the
// Pallas grids carry dq (or dk/dv) in VMEM scratch across a sequential
// axis, and on Hopper that axis is a loop inside the block with the sums
// in fp32 registers.  No atomics: two calls give the same bits.
//
// Bound on the H100: operations.  The function needs five products per
// live (query, key) pair: s, dq and dk of 2 * D flops, dp and dv of 2 * DV,
// so 2 * (3 * D + 2 * DV) * S^2/2 flops per head against ~8 * S * D bytes.
//
// All four kernels are templated on <D, DV>, the q/k head dim and the v
// head dim, and built for (64, 64), (128, 128), (96, 64) and (80, 80):
// MLA's training (MiniCPM3: q/k heads of 64 nope + 32 rope dims, v heads of
// 64) runs (96, 64), the Pallas backward's dv = v.shape[-1]; Zamba2's
// shared attention block (2560 / 32 heads) runs (80, 80).  S and dq, dk
// reduce or run over D; dP = dO.V^T reduces over DV and dv has DV columns.
// The scale is the caller's, D^-1/2 as the reference's.  At D = 80 the
// tensor-core kernels take five k16 steps a product and ten n8 tiles a
// gradient row at a pitch of 88 elements (as the forward), and the dk/dv
// kernel's 32-row query tiles (320 16-byte chunks over 128 threads) load
// in two whole passes and a guarded third; the f32 kernels' lanes own
// ceil(80 / 32) = 3 columns, lanes 16-31 two (the third guarded).
//
// bf16 (the main path: training): tensor cores, m16n8k16 bf16 mma.sync
// with fp32 sums, fragments through ldmatrix from shared tiles padded by
// 16 bytes a row (conflict-free), tiles streamed through a 2-stage
// cp.async ring.  p and ds enter their second products as hi + lo pairs of
// bf16 fragments built in registers (hi = bf16(x), lo = bf16(x - hi)):
// rounded once to bf16 they move dq, dk and dv by ~5e-3, 50x the card
// tests' tolerance, and split they stay at fp32 noise.  4 * (3 * D + 2 *
// DV) flops a pair in all (s and dp, then dq, dk and dv twice), against
// the function's 2 * (3 * D + 2 * DV).
//   dq:    a block of 4 warps per (b, query head, 64-row query tile), 16
//          rows a warp, loops over 64-key tiles up to the causal diagonal
//          and kv_len: S = Q.K^T, dP = dO.V^T, p = exp(S * scale - lse),
//          ds = p * (dP - delta) * scale, dq += ds.K.  Heaviest tiles first.
//   dk/dv: a block of 4 warps per (b, query head, 64-key tile), 16 keys a
//          warp, loops over 32-row query tiles from the diagonal on and
//          computes S^T = K.Q^T directly, so that the sums are key-major
//          (lse and delta indexed by the fragment's column): dv += p^T.dO,
//          dk += ds^T.Q.  It writes per-query-head partials (B, Skv, Hq,
//          D) and (B, Skv, Hq, DV); the wrapper sums each KV head's G
//          partials in a fixed order, the group sum the reference takes
//          outside its kernels (jnp.repeat's transpose).  For G = 1 they
//          are dk and dv.  Key tile 0, which sees every query under the
//          causal mask, launches first.
//
// f32 (the fp32 controls and tests): the first port's CUDA-core kernels.
//   dq:    a block per (b, query head, 16-row query tile) loops over the
//          32-key tiles up to the causal diagonal and kv_len.
//   dk/dv: a block per (b, KV head, 16-key tile) loops over the G query
//          heads of its group and, for each, the 32-row query tiles from
//          the diagonal on, summing the group itself.
// Each warp owns 4 rows of its block's output (query rows for dq, key
// rows for dk/dv); lane j scores the j-th row of the streamed 32-row tile,
// and lane c owns output columns c, c+32, ... of the sums, the scores
// broadcast by __shfl_sync.  It does seven products (s and dp in both
// kernels).
//
// Both keep p out of device memory (rebuilt from lse in registers), and
// neither loads nor computes tiles past the causal diagonal or past
// kv_len.  Masking follows the Pallas kernels exactly: p := 0 wherever the
// score is masked (the key is past kv_len or after the query, or the query
// row is past the end), set by the mask and never left to exp's
// underflow, so rows of fully masked queries (lse = FULLY_MASKED_LSE) give
// p = 0.  K/V rows past kv_len and Q/dO rows past the end are never
// loaded; their shared-memory rows stay zero, since 0 * NaN would poison
// the sums.
#include "common.cuh"
#include "tc.cuh"

namespace {

constexpr int kRowsPerWarp = 4;
constexpr int kWarps = 4;
constexpr int kBlockRows = kRowsPerWarp * kWarps;  // 16 output rows per block
constexpr int kTile = 32;                          // streamed rows, one per lane

struct Strides {
  long long b, s, h;  // elements; the last (head-dim) stride is 1
};

// Output rows (kBlockRows x D and x DV, read as broadcasts) and the
// streamed tiles (kTile x (D + 1) and x (DV + 1): +1 so lane j reads row j
// conflict-free), with the tile's lse and delta.
constexpr size_t smem_bytes(int d, int dv) {
  return sizeof(float) * (kBlockRows * (d + dv) + kTile * (d + 1 + dv + 1) + 2 * kTile);
}

template <int W>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const float* src,
                                          long long row_stride, int row0, int n_rows,
                                          int limit) {
  // rows [row0, row0 + n_rows) of W columns of src into dst; rows at or
  // past limit are zero
  for (int i = threadIdx.x; i < n_rows * W; i += kWarps * 32) {
    const int r = i / W, c = i % W;
    dst[r * pitch + c] =
        row0 + r < limit ? src[(row0 + r) * row_stride + c] : 0.f;
  }
}

// lane + 32 * c is one of a row's W columns: lanes own columns lane, lane
// + 32, ..., ceil(W / 32) of them, the last partial where 32 does not
// divide W (at W = 80 lanes 0-15 own three, the others two); folds to true
// where it does
template <int W>
__device__ __forceinline__ bool col_ok(int lane, int c) {
  return W % 32 == 0 || lane + 32 * c < W;
}

template <int W>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < W; ++c) s += a[c] * b[c];
  return s;
}

template <int D, int DV>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ kv_len, float* __restrict__ dq,
                    Strides qs_, Strides ks_, Strides vs_, Strides dos_, int sq, int skv,
                    int hq, int hkv, int causal, float scale) {
  constexpr int C = (D + 31) / 32;  // dq columns per lane, the last partial at D 80
  extern __shared__ float smem[];
  float* q_s = smem;                        // [kBlockRows][D]
  float* do_s = q_s + kBlockRows * D;       // [kBlockRows][DV]
  float* k_s = do_s + kBlockRows * DV;      // [kTile][D + 1]
  float* v_s = k_s + kTile * (D + 1);       // [kTile][DV + 1]

  const int q0 = blockIdx.x * kBlockRows;
  const int b = blockIdx.y / hq;
  const int h = blockIdx.y % hq;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(kv_len[b], skv);

  load_rows<D>(q_s, D, q + b * qs_.b + h * qs_.h, qs_.s, q0, kBlockRows, sq);
  load_rows<DV>(do_s, DV, dout + b * dos_.b + h * dos_.h, dos_.s, q0, kBlockRows, sq);
  const float* kb = k + b * ks_.b + hk * ks_.h;
  const float* vb = v + b * vs_.b + hk * vs_.h;
  const long long stat = (static_cast<long long>(b) * hq + h) * sq;

  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp], acc[kRowsPerWarp][C];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    lse_r[i] = qi < sq ? lse[stat + qi] : 0.f;
    delta_r[i] = qi < sq ? delta[stat + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  // key tiles past the causal diagonal of this query tile, or past the
  // valid length, are neither loaded nor computed
  int kv_end = len;
  if (causal) kv_end = min(kv_end, min(q0 + kBlockRows, sq));
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kTile;
    __syncthreads();  // the previous tile is consumed (and q_s, do_s are in)
    load_rows<D>(k_s, D + 1, kb, ks_.s, kv0, kTile, len);
    load_rows<DV>(v_s, DV + 1, vb, vs_.s, kv0, kTile, len);
    __syncthreads();

    const int kid = kv0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int qi = q0 + r;
      const float s = dot<D>(q_s + r * D, k_s + lane * (D + 1)) * scale;
      const float dp = dot<DV>(do_s + r * DV, v_s + lane * (DV + 1));
      const bool valid = qi < sq && kid < len && (!causal || kid <= qi);
      const float p = valid ? expf(s - lse_r[i]) : 0.f;
      const float ds = p * (dp - delta_r[i]) * scale;
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) {
        const float dsj = __shfl_sync(repro::kFullMask, ds, j);
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (col_ok<D>(lane, c)) acc[i][c] += dsj * k_s[j * (D + 1) + lane + 32 * c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    if (qi >= sq) continue;
    float* row = dq + ((static_cast<long long>(b) * sq + qi) * hq + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (col_ok<D>(lane, c)) row[lane + 32 * c] = acc[i][c];
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ kv_len, float* __restrict__ dk,
                     float* __restrict__ dv, Strides qs_, Strides ks_, Strides vs_,
                     Strides dos_, int sq, int skv, int hq, int hkv, int causal,
                     float scale) {
  constexpr int C = (D + 31) / 32, CV = (DV + 31) / 32;  // the last partial at D 80
  extern __shared__ float smem[];
  float* k_s = smem;                        // [kBlockRows][D]
  float* v_s = k_s + kBlockRows * D;        // [kBlockRows][DV]
  float* q_s = v_s + kBlockRows * DV;       // [kTile][D + 1]
  float* do_s = q_s + kTile * (D + 1);      // [kTile][DV + 1]
  float* lse_s = do_s + kTile * (DV + 1);   // [kTile]
  float* delta_s = lse_s + kTile;           // [kTile]

  const int j0 = blockIdx.x * kBlockRows;
  const int b = blockIdx.y / hkv;
  const int hk = blockIdx.y % hkv;
  const int group = hq / hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(kv_len[b], skv);

  load_rows<D>(k_s, D, k + b * ks_.b + hk * ks_.h, ks_.s, j0, kBlockRows, len);
  load_rows<DV>(v_s, DV, v + b * vs_.b + hk * vs_.h, vs_.s, j0, kBlockRows, len);

  float acc_k[kRowsPerWarp][C], acc_v[kRowsPerWarp][CV];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc_k[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < CV; ++c) acc_v[i][c] = 0.f;
  }

  // a key tile wholly past kv_len gets no gradient; under the causal mask
  // only query tiles from the one holding key j0 on can see these keys
  const int q_begin = j0 >= len ? sq : (causal ? (j0 / kTile) * kTile : 0);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const float* qb = q + b * qs_.b + h * qs_.h;
    const float* dob = dout + b * dos_.b + h * dos_.h;
    const long long stat = (static_cast<long long>(b) * hq + h) * sq;
    for (int qt = q_begin; qt < sq; qt += kTile) {
      __syncthreads();  // the previous tile is consumed (and k_s, v_s are in)
      load_rows<D>(q_s, D + 1, qb, qs_.s, qt, kTile, sq);
      load_rows<DV>(do_s, DV + 1, dob, dos_.s, qt, kTile, sq);
      if (threadIdx.x < kTile) {
        const int qi = qt + threadIdx.x;
        lse_s[threadIdx.x] = qi < sq ? lse[stat + qi] : 0.f;
        delta_s[threadIdx.x] = qi < sq ? delta[stat + qi] : 0.f;
      }
      __syncthreads();

      const int qi = qt + lane;
      const float* q_row = q_s + lane * (D + 1);
      const float* do_row = do_s + lane * (DV + 1);
      const float lse_q = lse_s[lane], delta_q = delta_s[lane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp * kRowsPerWarp + i;
        const int kj = j0 + r;
        const float s = dot<D>(q_row, k_s + r * D) * scale;
        const float dp = dot<DV>(do_row, v_s + r * DV);
        const bool valid = qi < sq && kj < len && (!causal || kj <= qi);
        const float p = valid ? expf(s - lse_q) : 0.f;
        const float ds = p * (dp - delta_q) * scale;
#pragma unroll 4
        for (int l = 0; l < kTile; ++l) {
          const float pl = __shfl_sync(repro::kFullMask, p, l);
          const float dsl = __shfl_sync(repro::kFullMask, ds, l);
#pragma unroll
          for (int c = 0; c < (C > CV ? C : CV); ++c) {
            if (c < CV && col_ok<DV>(lane, c))
              acc_v[i][c] += pl * do_s[l * (DV + 1) + lane + 32 * c];
            if (c < C && col_ok<D>(lane, c))
              acc_k[i][c] += dsl * q_s[l * (D + 1) + lane + 32 * c];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int kj = j0 + warp * kRowsPerWarp + i;
    if (kj >= skv) continue;
    const long long row = (static_cast<long long>(b) * skv + kj) * hkv + hk;
#pragma unroll
    for (int c = 0; c < (C > CV ? C : CV); ++c) {
      if (c < C && col_ok<D>(lane, c)) dk[row * D + lane + 32 * c] = acc_k[i][c];
      if (c < CV && col_ok<DV>(lane, c)) dv[row * DV + lane + 32 * c] = acc_v[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

namespace tc = repro::tc;
using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = 16 * kTcWarps;  // 64 output rows a block, 16 a warp
constexpr int kTcKeys = 64;             // keys a streamed tile (dq)
constexpr int kTcQueries = 32;          // query rows a streamed tile (dk/dv)

// dq: Q and dO tiles, then a 2-stage ring of K and V tiles (Q and K rows
// of D, dO and V rows of DV)
template <int D, int DV>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (tc::pitch<D>() + tc::pitch<DV>()) * (kTcRows + 2 * kTcKeys);
}

// dk/dv: K and V tiles, then a 2-stage ring of Q and dO tiles with their
// rows' lse and delta
template <int D, int DV>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * (tc::pitch<D>() + tc::pitch<DV>()) * (kTcRows + 2 * kTcQueries) +
         sizeof(float) * 4 * kTcQueries;
}

template <int D, int DV>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ kv_len, float* __restrict__ dq, Strides qs_,
                       Strides ks_, Strides vs_, Strides dos_, int sq, int skv, int hq,
                       int hkv, int causal, float scale) {
  constexpr int P = tc::pitch<D>();
  constexpr int PV = tc::pitch<DV>();
  constexpr int KD = D / 16;        // k16 steps over the q/k head dim
  constexpr int KV = DV / 16;       // k16 steps over the v head dim
  constexpr int ND = D / 8;         // n8 tiles of a dq row
  constexpr int NK = kTcKeys / 8;   // n8 tiles of a score tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);  // [kTcRows][P]
  bf16* do_s = q_s + kTcRows * P;             // [kTcRows][PV]
  bf16* k_s = do_s + kTcRows * PV;            // [2][kTcKeys][P]
  bf16* v_s = k_s + 2 * kTcKeys * P;          // [2][kTcKeys][PV]

  // under the causal mask the last query tiles see the most keys
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kTcRows;
  const int b = blockIdx.y / hq;
  const int h = blockIdx.y % hq;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int len = max(0, min(kv_len[b], skv));
  const bf16* kb = k + b * ks_.b + hk * ks_.h;
  const bf16* vb = v + b * vs_.b + hk * vs_.h;

  // key tiles past the causal diagonal of this query tile, or past the
  // valid length, are neither loaded nor computed
  int kv_end = len;
  if (causal) kv_end = min(kv_end, min(q0 + kTcRows, sq));
  const int n_tiles = (kv_end + kTcKeys - 1) / kTcKeys;

  tc::load_tile<kTcRows, D, kTcThreads>(q_s, q + b * qs_.b + h * qs_.h, qs_.s, q0, sq);
  tc::load_tile<kTcRows, DV, kTcThreads>(do_s, dout + b * dos_.b + h * dos_.h, dos_.s, q0, sq);
  if (n_tiles > 0) {
    tc::load_tile<kTcKeys, D, kTcThreads>(k_s, kb, ks_.s, 0, len);
    tc::load_tile<kTcKeys, DV, kTcThreads>(v_s, vb, vs_.s, 0, len);
  }
  tc::cp_async_commit();

  const float scale2 = scale * tc::kLog2e;  // exp(x) = exp2(x * log2(e))
  const long long stat = (static_cast<long long>(b) * hq + h) * sq;
  float lse2[2], dl[2];                     // rows g and g + 8 of the warp
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + g + 8 * i;
    lse2[i] = qi < sq ? lse[stat + qi] * tc::kLog2e : 0.f;
    dl[i] = qi < sq ? delta[stat + qi] : 0.f;
  }
  float acc[ND][4] = {};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int st = (t + 1) & 1, kv1 = (t + 1) * kTcKeys;
      tc::load_tile<kTcKeys, D, kTcThreads>(k_s + st * kTcKeys * P, kb, ks_.s, kv1, len);
      tc::load_tile<kTcKeys, DV, kTcThreads>(v_s + st * kTcKeys * PV, vb, vs_.s, kv1, len);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = k_s + (t & 1) * kTcKeys * P;
    const bf16* vs = v_s + (t & 1) * kTcKeys * PV;

    // S = Q K^T over D's KD k16 steps and dP = dO V^T over DV's KV, in one
    // fully unrolled loop: the bounds are compile-time, so the guards fold
    // away, and at D = DV the instruction stream is the fused loop's
    float s[NK][4] = {}, dp[NK][4] = {};
#pragma unroll
    for (int kk = 0; kk < (KD > KV ? KD : KV); ++kk) {
      uint32_t qa[4], da[4];
      if (kk < KD) tc::ldmatrix_x4(qa, tc::a_row<P>(q_s, r0, kk * 16, lane));
      if (kk < KV) tc::ldmatrix_x4(da, tc::a_row<PV>(do_s, r0, kk * 16, lane));
#pragma unroll
      for (int nn = 0; nn < NK; nn += 2) {
        uint32_t bk[4], bv[4];
        if (kk < KD) {
          tc::ldmatrix_x4(bk, tc::b_row<P>(ks, nn * 8, kk * 16, lane));
          tc::mma(s[nn], qa, bk[0], bk[1]);
          tc::mma(s[nn + 1], qa, bk[2], bk[3]);
        }
        if (kk < KV) {
          tc::ldmatrix_x4(bv, tc::b_row<PV>(vs, nn * 8, kk * 16, lane));
          tc::mma(dp[nn], da, bv[0], bv[1]);
          tc::mma(dp[nn + 1], da, bv[2], bv[3]);
        }
      }
    }

    // p and ds in place of s; the mask only where the tile reaches past
    // kv_len or over this warp's diagonal
    const int kv0 = t * kTcKeys;
    const bool edge = kv0 + kTcKeys > len || (causal && kv0 + kTcKeys - 1 > q0 + r0);
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[nt][e], scale2, -lse2[e >> 1]));
        if (edge) {
          const int qi = q0 + r0 + g + (e >> 1) * 8;
          const int kj = kv0 + nt * 8 + 2 * t4 + (e & 1);
          if (!(kj < len && (!causal || kj <= qi))) p = 0.f;
        }
        s[nt][e] = p * (dp[nt][e] - dl[e >> 1]) * scale;
      }
    }

    // dq += dS K with dS = hi + lo; K's rows run along k
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      uint32_t hi[4], lo[4];
      tc::split_a(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t bk[4];
        tc::ldmatrix_x4_trans(bk, tc::b_col<P>(ks, kk * 16, dn * 8, lane));
        tc::mma(acc[dn], hi, bk[0], bk[1]);
        tc::mma(acc[dn], lo, bk[0], bk[1]);
        tc::mma(acc[dn + 1], hi, bk[2], bk[3]);
        tc::mma(acc[dn + 1], lo, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next copy refills it
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + g + 8 * i;
    if (qi >= sq) continue;
    float* row = dq + ((static_cast<long long>(b) * sq + qi) * hq + h) * D;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt)
      *reinterpret_cast<float2*>(row + dt * 8 + 2 * t4) = make_float2(acc[dt][2 * i], acc[dt][2 * i + 1]);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ kv_len, float* __restrict__ dk,
                        float* __restrict__ dv, Strides qs_, Strides ks_, Strides vs_,
                        Strides dos_, int sq, int skv, int hq, int hkv, int causal,
                        float scale) {
  constexpr int P = tc::pitch<D>();
  constexpr int PV = tc::pitch<DV>();
  constexpr int KD = D / 16;          // k16 steps over the q/k head dim
  constexpr int KV = DV / 16;         // k16 steps over the v head dim
  constexpr int ND = D / 8;           // n8 tiles of a dk row
  constexpr int NV = DV / 8;          // n8 tiles of a dv row
  constexpr int NQ = kTcQueries / 8;  // n8 tiles of a transposed score tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(tc_smem);  // [kTcRows][P]
  bf16* v_s = k_s + kTcRows * P;              // [kTcRows][PV]
  bf16* q_s = v_s + kTcRows * PV;             // [2][kTcQueries][P]
  bf16* do_s = q_s + 2 * kTcQueries * P;      // [2][kTcQueries][PV]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTcQueries * PV);  // [2][kTcQueries]
  float* dl_s = lse_s + 2 * kTcQueries;                                // [2][kTcQueries]

  const int b = blockIdx.x / hq;
  const int h = blockIdx.x % hq;
  const int hk = h / (hq / hkv);
  const int j0 = blockIdx.y * kTcRows;  // key tile 0, the heaviest, launches first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int len = max(0, min(kv_len[b], skv));
  const bf16* qb = q + b * qs_.b + h * qs_.h;
  const bf16* dob = dout + b * dos_.b + h * dos_.h;
  const long long stat = (static_cast<long long>(b) * hq + h) * sq;

  // a key tile wholly past kv_len gets no gradient; under the causal mask
  // only query rows from j0 on can see these keys
  const int q_begin = j0 >= len ? sq : (causal ? j0 : 0);
  const int n_tiles = (sq - q_begin + kTcQueries - 1) / kTcQueries;

  auto load_queries = [&](int st, int qt) {
    tc::load_tile<kTcQueries, D, kTcThreads>(q_s + st * kTcQueries * P, qb, qs_.s, qt, sq);
    tc::load_tile<kTcQueries, DV, kTcThreads>(do_s + st * kTcQueries * PV, dob, dos_.s, qt, sq);
    const int i = threadIdx.x % kTcQueries;
    const bool in = qt + i < sq;
    const long long at = in ? stat + qt + i : stat;
    if (threadIdx.x < kTcQueries)
      tc::cp_async4(lse_s + st * kTcQueries + i, lse + at, in);
    else if (threadIdx.x < 2 * kTcQueries)
      tc::cp_async4(dl_s + st * kTcQueries + i, delta + at, in);
  };
  tc::load_tile<kTcRows, D, kTcThreads>(k_s, k + b * ks_.b + hk * ks_.h, ks_.s, j0, len);
  tc::load_tile<kTcRows, DV, kTcThreads>(v_s, v + b * vs_.b + hk * vs_.h, vs_.s, j0, len);
  if (n_tiles > 0) load_queries(0, q_begin);
  tc::cp_async_commit();

  const float scale2 = scale * tc::kLog2e;
  float dka[ND][4] = {}, dva[NV][4] = {};

  for (int t = 0; t < n_tiles; ++t) {
    const int qt = q_begin + t * kTcQueries;
    if (t + 1 < n_tiles) load_queries((t + 1) & 1, qt + kTcQueries);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* q_t = q_s + (t & 1) * kTcQueries * P;
    const bf16* do_t = do_s + (t & 1) * kTcQueries * PV;
    const float* ls = lse_s + (t & 1) * kTcQueries;
    const float* dls = dl_s + (t & 1) * kTcQueries;

    // S^T = K Q^T over D's KD k16 steps and dP^T = V dO^T over DV's KV
    // (one unrolled loop, as in the dq kernel): rows are this warp's keys,
    // columns the tile's queries
    float st[NQ][4] = {}, dpt[NQ][4] = {};
#pragma unroll
    for (int kk = 0; kk < (KD > KV ? KD : KV); ++kk) {
      uint32_t ka[4], va[4];
      if (kk < KD) tc::ldmatrix_x4(ka, tc::a_row<P>(k_s, r0, kk * 16, lane));
      if (kk < KV) tc::ldmatrix_x4(va, tc::a_row<PV>(v_s, r0, kk * 16, lane));
#pragma unroll
      for (int nn = 0; nn < NQ; nn += 2) {
        uint32_t bq[4], bd[4];
        if (kk < KD) {
          tc::ldmatrix_x4(bq, tc::b_row<P>(q_t, nn * 8, kk * 16, lane));
          tc::mma(st[nn], ka, bq[0], bq[1]);
          tc::mma(st[nn + 1], ka, bq[2], bq[3]);
        }
        if (kk < KV) {
          tc::ldmatrix_x4(bd, tc::b_row<PV>(do_t, nn * 8, kk * 16, lane));
          tc::mma(dpt[nn], va, bd[0], bd[1]);
          tc::mma(dpt[nn + 1], va, bd[2], bd[3]);
        }
      }
    }

    // p^T in st, ds^T in dpt; lse and delta by column (query).  The mask
    // only where the tile reaches past the sequence, the warp's keys past
    // kv_len, or the diagonal crosses the warp's keys
    const int kj_last = j0 + r0 + 15;
    const bool edge = qt + kTcQueries > sq || kj_last >= len || (causal && qt < kj_last);
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      const int c = nt * 8 + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dls + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? l2.y : l2.x;
        const float dlt = (e & 1) ? d2.y : d2.x;
        float p = exp2f(fmaf(st[nt][e], scale2, -lq * tc::kLog2e));
        if (edge) {
          const int qi = qt + c + (e & 1);
          const int kj = j0 + r0 + g + (e >> 1) * 8;
          if (!(qi < sq && kj < len && (!causal || kj <= qi))) p = 0.f;
        }
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - dlt) * scale;
      }
    }

    // dv += P^T dO and dk += dS^T Q, P^T and dS^T as hi + lo; the staged
    // tiles' rows (queries) run along k
#pragma unroll
    for (int kq = 0; kq < NQ / 2; ++kq) {
      uint32_t hi[4], lo[4];
      tc::split_a(st[2 * kq], st[2 * kq + 1], hi, lo);
#pragma unroll
      for (int dn = 0; dn < NV; dn += 2) {
        uint32_t bd[4];
        tc::ldmatrix_x4_trans(bd, tc::b_col<PV>(do_t, kq * 16, dn * 8, lane));
        tc::mma(dva[dn], hi, bd[0], bd[1]);
        tc::mma(dva[dn], lo, bd[0], bd[1]);
        tc::mma(dva[dn + 1], hi, bd[2], bd[3]);
        tc::mma(dva[dn + 1], lo, bd[2], bd[3]);
      }
      tc::split_a(dpt[2 * kq], dpt[2 * kq + 1], hi, lo);
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t bq[4];
        tc::ldmatrix_x4_trans(bq, tc::b_col<P>(q_t, kq * 16, dn * 8, lane));
        tc::mma(dka[dn], hi, bq[0], bq[1]);
        tc::mma(dka[dn], lo, bq[0], bq[1]);
        tc::mma(dka[dn + 1], hi, bq[2], bq[3]);
        tc::mma(dka[dn + 1], lo, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next copy refills it
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = j0 + r0 + g + 8 * i;
    if (kj >= skv) continue;
    const long long row = (static_cast<long long>(b) * skv + kj) * hq + h;
#pragma unroll
    for (int dt = 0; dt < (ND > NV ? ND : NV); ++dt) {
      const int c = dt * 8 + 2 * t4;
      if (dt < ND)
        *reinterpret_cast<float2*>(dk + row * D + c) = make_float2(dka[dt][2 * i], dka[dt][2 * i + 1]);
      if (dt < NV)
        *reinterpret_cast<float2*>(dv + row * DV + c) = make_float2(dva[dt][2 * i], dva[dt][2 * i + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  // above 48 KB a block gets dynamic shared memory only after opting in
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const int* kv_len, float* dq,
                   float* dk, float* dv, Strides qs, Strides ks, Strides vs, Strides dos,
                   int b, int sq, int skv, int hq, int hkv, int causal, float scale,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(D, DV);
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  cudaError_t e = opt_in(flash_bwd_dq_kernel<D, DV>, bytes);
  if (e != cudaSuccess) return e;
  e = opt_in(flash_bwd_dkv_kernel<D, DV>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 dq_grid((sq + kBlockRows - 1) / kBlockRows, b * hq);
  flash_bwd_dq_kernel<D, DV><<<dq_grid, kWarps * 32, bytes, stream>>>(
      q_, k_, v_, do_, lse, delta, kv_len, dq, qs, ks, vs, dos, sq, skv, hq, hkv, causal,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 dkv_grid((skv + kBlockRows - 1) / kBlockRows, b * hkv);
  flash_bwd_dkv_kernel<D, DV><<<dkv_grid, kWarps * 32, bytes, stream>>>(
      q_, k_, v_, do_, lse, delta, kv_len, dk, dv, qs, ks, vs, dos, sq, skv, hq, hkv,
      causal, scale);
  return cudaGetLastError();
}

// dk/dv are (B, Skv, Hq, D) and (B, Skv, Hq, DV) per-query-head partials here
template <int D, int DV>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const int* kv_len, float* dq,
                      float* dk, float* dv, Strides qs, Strides ks, Strides vs, Strides dos,
                      int b, int sq, int skv, int hq, int hkv, int causal, float scale,
                      cudaStream_t stream) {
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  constexpr size_t dq_bytes = dq_smem_bytes<D, DV>(), dkv_bytes = dkv_smem_bytes<D, DV>();
  cudaError_t e = opt_in(flash_bwd_dq_tc_kernel<D, DV>, dq_bytes);
  if (e != cudaSuccess) return e;
  e = opt_in(flash_bwd_dkv_tc_kernel<D, DV>, dkv_bytes);
  if (e != cudaSuccess) return e;
  const dim3 dq_grid((sq + kTcRows - 1) / kTcRows, b * hq);
  flash_bwd_dq_tc_kernel<D, DV><<<dq_grid, kTcThreads, dq_bytes, stream>>>(
      q_, k_, v_, do_, lse, delta, kv_len, dq, qs, ks, vs, dos, sq, skv, hq, hkv, causal,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 dkv_grid(b * hq, (skv + kTcRows - 1) / kTcRows);
  flash_bwd_dkv_tc_kernel<D, DV><<<dkv_grid, kTcThreads, dkv_bytes, stream>>>(
      q_, k_, v_, do_, lse, delta, kv_len, dk, dv, qs, ks, vs, dos, sq, skv, hq, hkv,
      causal, scale);
  return cudaGetLastError();
}

// One (D, DV) instance: the bf16 tensor-core kernels or the f32 CUDA-core
// ones, by dtype.
template <int D, int DV>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, const int* kv_len, float* dq,
                     float* dk, float* dv, Strides qs, Strides ks, Strides vs, Strides dos,
                     int b, int sq, int skv, int hq, int hkv, int causal, float scale,
                     int dtype, cudaStream_t stream) {
  if (dtype == repro::kBF16)
    return launch_tc<D, DV>(q, k, v, dout, lse, delta, kv_len, dq, dk, dv, qs, ks, vs, dos, b,
                            sq, skv, hq, hkv, causal, scale, stream);
  return launch<D, DV>(q, k, v, dout, lse, delta, kv_len, dq, dk, dv, qs, ks, vs, dos, b, sq,
                       skv, hq, hkv, causal, scale, stream);
}

}  // namespace

// q (B, Sq, Hq, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, DV) and dout (B,
// Sq, Hq, DV) with the given element strides for the B, S and H axes (the
// head dim contiguous), one dtype; lse and delta (B, Hq, Sq) float32
// contiguous; kv_len (B,) int32.  dq (B, Sq, Hq, D) float32 contiguous.
// (D, DV) = (d, d_v) is (64, 64), (128, 128), (96, 64) or (80, 80); any other pair
// returns cudaErrorInvalidValue and launches nothing.  Causal calls are
// square.
// bf16 takes the tensor-core kernels: q, k, v, dout base pointers 16-byte
// aligned, B, S and H strides multiples of 8 (the wrapper checks), and
// dk/dv are (B, Skv, Hq, D) / (B, Skv, Hq, DV) float32 per-query-head
// partials for the wrapper's group sum.  f32 takes the CUDA-core kernels,
// dk/dv (B, Skv, Hkv, D) / (B, Skv, Hkv, DV) float32 contiguous.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* kv_len, void* dq, void* dk, void* dv, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, int b, int sq, int skv, int hq, int hkv, int d, int d_v, int causal,
    float scale, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0) return static_cast<int>(cudaGetLastError());
  if (hkv <= 0 || hq % hkv != 0 || (causal && sq != skv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      dos{do_sb, do_ss, do_sh};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* len = static_cast<const int*>(kv_len);
  float* dq_ = static_cast<float*>(dq);
  float* dk_ = static_cast<float*>(dk);
  float* dv_ = static_cast<float*>(dv);
  cudaError_t e = cudaErrorInvalidValue;
  if (d == 64 && d_v == 64)
    e = dispatch<64, 64>(q, k, v, dout, l, dl, len, dq_, dk_, dv_, qs, ks, vs, dos, b, sq, skv,
                         hq, hkv, causal, scale, dtype, s);
  else if (d == 128 && d_v == 128)
    e = dispatch<128, 128>(q, k, v, dout, l, dl, len, dq_, dk_, dv_, qs, ks, vs, dos, b, sq,
                           skv, hq, hkv, causal, scale, dtype, s);
  else if (d == 96 && d_v == 64)
    e = dispatch<96, 64>(q, k, v, dout, l, dl, len, dq_, dk_, dv_, qs, ks, vs, dos, b, sq, skv,
                         hq, hkv, causal, scale, dtype, s);
  else if (d == 80 && d_v == 80)
    e = dispatch<80, 80>(q, k, v, dout, l, dl, len, dq_, dk_, dv_, qs, ks, vs, dos, b, sq, skv,
                         hq, hkv, causal, scale, dtype, s);
  return static_cast<int>(e);
}
