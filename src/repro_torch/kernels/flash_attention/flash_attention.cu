// Causal flash-attention forward for Hopper, GQA-grouped, with per-row
// valid length: O and lse = m + log(l).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_fwd (Pallas _fwd_kernel) and the K/V head expansion of
// ops.py::flash_mha (the jnp.repeat there exists for the backward pass
// only; here query head h reads KV head h / G directly).
//
// Bound on the H100: operations at prefill and training lengths (4 * D
// flops per live (query, key) pair against 2 * S * D K/V bytes a head).
// Two branches behind one entry point, chosen by dtype:
//
// bf16 (the main path: serving prefill, training): tensor cores.  A block
// of 4 warps owns 64 query rows of one (b, query head), 16 rows a warp,
// and streams 64-key K/V tiles through a 2-stage cp.async ring in shared
// memory (rows padded by 16 bytes, so ldmatrix is conflict-free), so the
// next tile loads while this one computes.  S = Q.K^T is m16n8k16 bf16
// mma.sync with fp32 sums; the online softmax runs on the accumulator
// fragment in log2 units (exp2 on the SFU), its row max and sum reduced
// over the 4 lanes of a quad by __shfl_xor_sync; and P enters P.V as the
// sum of two bf16 fragments, hi = bf16(p) and lo = bf16(p - hi), built in
// registers from the accumulator (whose layout is the A operand's),
// because P rounded once to bf16 moves O by ~2^-9 relative where the
// reference keeps p in fp32.  That costs 6 * D flops a pair, not 4 * D.
// Under the causal mask the heaviest query tiles launch first.
// wgmma/TMA tiles are later work.
//
// f32 (the fp32 controls and tests): the first port's CUDA-core kernel.
// Each warp owns 4 query rows of a 16-row tile; lane j scores key j of a
// 32-key tile, the row max and sum are __shfl_xor_sync butterflies, and
// for P @ V lane c owns output columns c, c+32, ... below DV (at DV = 80
// lanes 0-15 own three columns, the others two).
//
// Both are templated on <D, DV>, the q/k head dim and the v head dim, and
// built for (64, 64), (128, 128), (96, 64) and (80, 80): MLA's prefill
// (MiniCPM3: q/k heads of 64 nope + 32 rope dims, v heads of 64) runs
// (96, 64), the Pallas kernel's dv = v.shape[-1]; Zamba2's shared
// attention block (2560 / 32 heads) runs (80, 80).  At D = 80 the
// tensor-core kernel takes five k16 steps a score tile and ten n8 tiles an
// output row, and stages rows of ten 16-byte chunks (640 a 64-row tile,
// five a thread) at a pitch of 88 elements (176 bytes: the 8 rows of an
// ldmatrix phase start 12 banks apart and cover all 32 banks).  Scores reduce over D, the output row
// and P.V over DV; the scale is the caller's, D^-1/2 as the reference's.
//
// Both keep: kv tiles past the causal diagonal or past kv_len are neither
// loaded nor computed, K/V rows past kv_len are never read (zero-filled in
// shared memory), and the running max / sum / accumulator stay in
// registers.  Masking follows the Pallas kernel exactly: masked scores are
// -0.7 * f32max, masked probabilities are zeroed by the mask, fully masked
// rows get l := 1 (O = 0) and lse = FULLY_MASKED_LSE.
#include "common.cuh"
#include "tc.cuh"

namespace {

constexpr int kRowsPerWarp = 4;
constexpr int kWarps = 4;
constexpr int kBlockQ = kRowsPerWarp * kWarps;  // 16 query rows per block
constexpr int kBlockK = 32;                     // one key per lane

struct Strides {
  long long b, s, h;  // elements; the last (head-dim) stride is 1
};

template <int D, int DV>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ kv_len,
                 float* __restrict__ o, float* __restrict__ lse, Strides qs_, Strides ks_,
                 Strides vs_, int sq, int skv, int hq, int hkv, int causal,
                 float scale) {
  static_assert(DV <= D, "V rows load in the K rows' loop");
  constexpr int C = (DV + 31) / 32;  // output columns per lane, the last partial
  // lane + 32 * c is a column of the row (folds to true where 32 | DV)
  auto col_ok = [](int lane, int c) { return DV % 32 == 0 || lane + 32 * c < DV; };
  __shared__ float q_s[kBlockQ][D];
  __shared__ float k_s[kBlockK][D + 1];  // +1: lane j reads row j conflict-free
  __shared__ float v_s[kBlockK][DV];

  const int q0 = blockIdx.x * kBlockQ;
  const int b = blockIdx.y / hq;
  const int h = blockIdx.y % hq;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(kv_len[b], skv);

  const float* qb = q + b * qs_.b + h * qs_.h;
  const float* kb = k + b * ks_.b + hk * ks_.h;
  const float* vb = v + b * vs_.b + hk * vs_.h;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kWarps * 32) {
    const int r = i / D, c = i % D;
    q_s[r][c] = q0 + r < sq ? qb[(q0 + r) * qs_.s + c] : 0.f;
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
      k_s[j][c] = in ? kb[(kv0 + j) * ks_.s + c] : 0.f;
      if (c < DV) v_s[j][c] = in ? vb[(kv0 + j) * vs_.s + c] : 0.f;
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
        for (int c = 0; c < C; ++c)
          if (col_ok(lane, c)) acc[i][c] += pj * v_s[j][lane + 32 * c];
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    if (qi >= sq) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + ((static_cast<long long>(b) * sq + qi) * hq + h) * DV;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (col_ok(lane, c)) orow[lane + 32 * c] = acc[i][c] / safe;
    if (lane == 0) {
      lse[(static_cast<long long>(b) * hq + h) * sq + qi] =
          l[i] == 0.f ? repro::kFullyMaskedLse : m[i] + logf(safe);
    }
  }
}

template <int D, int DV>
void launch(const void* q, const void* k, const void* v, const int* kv_len, void* o,
            float* lse, Strides qs, Strides ks, Strides vs, int b, int sq, int skv,
            int hq, int hkv, int causal, float scale, cudaStream_t stream) {
  dim3 grid((sq + kBlockQ - 1) / kBlockQ, b * hq);
  flash_fwd_kernel<D, DV><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_len, static_cast<float*>(o), lse, qs, ks, vs, sq,
      skv, hq, hkv, causal, scale);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

namespace tc = repro::tc;
using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcBlockQ = 16 * kTcWarps;  // 64 query rows, 16 a warp
constexpr int kTcBlockK = 64;             // keys a staged K/V tile

// Q tile, then a 2-stage ring of K tiles (rows of D) and one of V tiles
// (rows of DV)
template <int D, int DV>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) *
         (tc::pitch<D>() * (kTcBlockQ + 2 * kTcBlockK) + tc::pitch<DV>() * 2 * kTcBlockK);
}

template <int D, int DV>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ kv_len,
                    bf16* __restrict__ o, float* __restrict__ lse, Strides qs_, Strides ks_,
                    Strides vs_, int sq, int skv, int hq, int hkv, int causal, float scale) {
  constexpr int P = tc::pitch<D>();
  constexpr int PV = tc::pitch<DV>();
  constexpr int KD = D / 16;         // k16 steps over the q/k head dim
  constexpr int ND = DV / 8;         // n8 tiles of the output row
  constexpr int NK = kTcBlockK / 8;  // n8 tiles of a score tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);  // [kTcBlockQ][P]
  bf16* k_s = q_s + kTcBlockQ * P;               // [2][kTcBlockK][P]
  bf16* v_s = k_s + 2 * kTcBlockK * P;           // [2][kTcBlockK][PV]

  // under the causal mask the last query tiles see the most keys: they
  // launch first, so that the last wave is not the longest
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kTcBlockQ;
  const int b = blockIdx.y / hq;
  const int h = blockIdx.y % hq;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row, column pair
  const int r0 = warp * 16;                // the warp's rows in the tile
  const int len = max(0, min(kv_len[b], skv));
  const bf16* kb = k + b * ks_.b + hk * ks_.h;
  const bf16* vb = v + b * vs_.b + hk * vs_.h;

  // kv tiles past the causal diagonal of this query tile, or past the
  // valid length, are neither loaded nor computed
  int kv_end = len;
  if (causal) kv_end = min(kv_end, min(q0 + kTcBlockQ, sq));
  const int n_tiles = (kv_end + kTcBlockK - 1) / kTcBlockK;

  tc::load_tile<kTcBlockQ, D, kTcThreads>(q_s, q + b * qs_.b + h * qs_.h, qs_.s, q0, sq);
  if (n_tiles > 0) {
    tc::load_tile<kTcBlockK, D, kTcThreads>(k_s, kb, ks_.s, 0, len);
    tc::load_tile<kTcBlockK, DV, kTcThreads>(v_s, vb, vs_.s, 0, len);
  }
  tc::cp_async_commit();

  const float scale2 = scale * tc::kLog2e;  // scores in log2 units
  float m[2] = {-INFINITY, -INFINITY};      // rows g and g + 8 of the warp
  float l[2] = {0.f, 0.f};                  // this lane's part of the row sums
  float acc[ND][4] = {};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {  // the next tile streams in while this one computes
      const int st = (t + 1) & 1, kv1 = (t + 1) * kTcBlockK;
      tc::load_tile<kTcBlockK, D, kTcThreads>(k_s + st * kTcBlockK * P, kb, ks_.s, kv1, len);
      tc::load_tile<kTcBlockK, DV, kTcThreads>(v_s + st * kTcBlockK * PV, vb, vs_.s, kv1, len);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = k_s + (t & 1) * kTcBlockK * P;
    const bf16* vs = v_s + (t & 1) * kTcBlockK * PV;

    // S = Q K^T (Q's fragments re-read from shared memory: held in
    // registers beside O they would spill at D = 128)
    float s[NK][4] = {};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      tc::ldmatrix_x4(qa, tc::a_row<P>(q_s, r0, kk * 16, lane));
#pragma unroll
      for (int nn = 0; nn < NK; nn += 2) {
        uint32_t bk[4];
        tc::ldmatrix_x4(bk, tc::b_row<P>(ks, nn * 8, kk * 16, lane));
        tc::mma(s[nn], qa, bk[0], bk[1]);
        tc::mma(s[nn + 1], qa, bk[2], bk[3]);
      }
    }

    // the online softmax; the mask only where this warp's tile reaches
    // past kv_len or over its diagonal.  exp2 on the SFU alone: the
    // softmax's instructions, not the products, pace this loop
    const int kv0 = t * kTcBlockK;
    const bool edge = kv0 + kTcBlockK > len || (causal && kv0 + kTcBlockK - 1 > q0 + r0);
    auto live = [&](int nt, int e) {
      const int qi = q0 + r0 + g + (e >> 1) * 8;
      const int kj = kv0 + nt * 8 + 2 * t4 + (e & 1);
      return kj < len && (!causal || kj <= qi);
    };
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale2;
        if (edge && !live(nt, e)) x = repro::kMaskValue;
        s[nt][e] = x;
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
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = tc::exp2_fast(s[nt][e] - mx[e >> 1]);
        if (edge && !live(nt, e)) p = 0.f;  // set by the mask, not left to underflow
        s[nt][e] = p;
        l[e >> 1] += p;
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
      tc::split_a(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t bv[4];
        tc::ldmatrix_x4_trans(bv, tc::b_col<PV>(vs, kk * 16, dn * 8, lane));
        tc::mma(acc[dn], ph, bv[0], bv[1]);
        tc::mma(acc[dn + 1], ph, bv[2], bv[3]);
        tc::mma(acc[dn], pl, bv[0], bv[1]);
        tc::mma(acc[dn + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next copy refills it
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = repro::quad_sum(l[i]);
    const int qi = q0 + r0 + g + 8 * i;
    if (qi >= sq) continue;
    const float safe = li == 0.f ? 1.f : li;
    bf16* orow = o + ((static_cast<long long>(b) * sq + qi) * hq + h) * DV;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[dt][2 * i] / safe, acc[dt][2 * i + 1] / safe);
    }
    if (t4 == 0) {
      lse[(static_cast<long long>(b) * hq + h) * sq + qi] =
          li == 0.f ? repro::kFullyMaskedLse : m[i] * tc::kLn2 + logf(safe);
    }
  }
}

template <int D, int DV>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const int* kv_len,
                      void* o, float* lse, Strides qs, Strides ks, Strides vs, int b, int sq,
                      int skv, int hq, int hkv, int causal, float scale,
                      cudaStream_t stream) {
  constexpr size_t bytes = tc_smem_bytes<D, DV>();  // above 48 KB: opt in
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_tc_kernel<D, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + kTcBlockQ - 1) / kTcBlockQ, b * hq);
  flash_fwd_tc_kernel<D, DV><<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      kv_len, static_cast<bf16*>(o), lse, qs, ks, vs, sq, skv, hq, hkv, causal, scale);
  return cudaGetLastError();
}

// One (D, DV) instance: the bf16 tensor-core kernel or the f32 CUDA-core
// one, by dtype.
template <int D, int DV>
cudaError_t dispatch(const void* q, const void* k, const void* v, const int* kv_len, void* o,
                     float* lse, Strides qs, Strides ks, Strides vs, int b, int sq, int skv,
                     int hq, int hkv, int causal, float scale, int dtype,
                     cudaStream_t stream) {
  if (dtype == repro::kBF16)
    return launch_tc<D, DV>(q, k, v, kv_len, o, lse, qs, ks, vs, b, sq, skv, hq, hkv, causal,
                            scale, stream);
  launch<D, DV>(q, k, v, kv_len, o, lse, qs, ks, vs, b, sq, skv, hq, hkv, causal, scale,
                stream);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, Hq, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, DV) with the given
// element strides for the B, S and H axes (the head dim contiguous);
// kv_len (B,) int32; o (B, Sq, Hq, DV) and lse (B, Hq, Sq) float32, both
// contiguous.  (D, DV) is (64, 64), (128, 128), (96, 64) or (80, 80); any
// other pair returns cudaErrorInvalidValue and launches nothing.  bf16
// takes the tensor-core kernel: its q, k, v base pointers are 16-byte
// aligned and the B, S and H strides multiples of 8 (the wrapper checks);
// f32 takes the CUDA-core kernel.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_len, void* o, void* lse,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, int b, int sq,
    int skv, int hq, int hkv, int d, int dv, int causal, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const int* len = static_cast<const int*>(kv_len);
  float* l = static_cast<float*>(lse);
  if (b <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t e = cudaErrorInvalidValue;
  if (d == 64 && dv == 64)
    e = dispatch<64, 64>(q, k, v, len, o, l, qs, ks, vs, b, sq, skv, hq, hkv, causal, scale,
                         dtype, s);
  else if (d == 128 && dv == 128)
    e = dispatch<128, 128>(q, k, v, len, o, l, qs, ks, vs, b, sq, skv, hq, hkv, causal,
                           scale, dtype, s);
  else if (d == 96 && dv == 64)
    e = dispatch<96, 64>(q, k, v, len, o, l, qs, ks, vs, b, sq, skv, hq, hkv, causal, scale,
                         dtype, s);
  else if (d == 80 && dv == 80)
    e = dispatch<80, 80>(q, k, v, len, o, l, qs, ks, vs, b, sq, skv, hq, hkv, causal, scale,
                         dtype, s);
  return static_cast<int>(e);
}
