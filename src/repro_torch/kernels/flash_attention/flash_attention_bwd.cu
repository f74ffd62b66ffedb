// Flash-attention backward for Hopper, GQA-grouped, with per-row valid
// length: dq, dk, dv in fp32 from q, k, v, dO and the forward's lse plus
// delta = rowsum(dO * O).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_bwd, both of its Pallas kernels (_dq_kernel and
// _dkv_kernel), and the K/V head expansion of ops.py::flash_mha, whose
// jnp.repeat exists so that the group sum of dk/dv falls out of the
// repeat's transpose.  Here query head h reads KV head h / G, and the
// dk/dv block sums the G heads of its group itself: no repeat, no atomics,
// the same result on every run.
//
// Two kernels behind one entry point.  The Pallas grids carry dq (or
// dk/dv) in VMEM scratch across a sequential axis; on Hopper that axis is
// a loop inside the block and the sums stay in fp32 registers.
//   dq:    a block per (b, query head, 16-row query tile) loops over the
//          32-key tiles up to the causal diagonal and kv_len:
//          p = exp(s - lse), ds = p * (dO.v - delta) * scale, dq += ds @ k.
//   dk/dv: a block per (b, KV head, 16-key tile) loops over the G query
//          heads of its group and, for each, the 32-row query tiles from
//          the diagonal on: dv += p^T @ dO, dk += ds^T @ q.
// Each warp owns 4 rows of its block's output (query rows for dq, key
// rows for dk/dv); lane j scores the j-th row of the streamed 32-row tile,
// and lane c owns output columns c, c+32, ... of the sums, the scores
// broadcast by __shfl_sync.
//
// Bound on the H100: operations.  The function needs five products of
// 2 * S^2 * D flops each per head (s, dp, dq, dk, dv), halved by the
// causal mask: 10 * D * S^2/2 flops per head against ~8 * S * D bytes.
// This design does seven (s and dp in both kernels), 1.4x that work.
// This first version computes in fp32 on the CUDA cores, as the forward
// does, not on the tensor cores, so it sits far from the bf16 bound;
// wgmma/TMA tiles are later work.  What the design does keep: p never
// round-trips to device memory (it is rebuilt from lse in registers),
// tiles past the causal diagonal or past kv_len are neither loaded nor
// computed, and each block reads its own K/V tile (dk/dv) or its Q/dO
// tile (dq) from device memory once.
//
// Masking follows the Pallas kernels exactly: p := 0 wherever the score
// is masked (the key is past kv_len or after the query, or the query row
// is past the end), set by the mask and never left to exp's underflow, so
// rows of fully masked queries (lse = FULLY_MASKED_LSE) give p = 0.  K/V
// rows past kv_len and Q/dO rows past the end are never loaded; their
// shared-memory rows stay zero, since 0 * NaN would poison the sums.
#include "common.cuh"

namespace {

constexpr int kRowsPerWarp = 4;
constexpr int kWarps = 4;
constexpr int kBlockRows = kRowsPerWarp * kWarps;  // 16 output rows per block
constexpr int kTile = 32;                          // streamed rows, one per lane

struct Strides {
  long long b, s, h;  // elements; the last (head-dim) stride is 1
};

// Output rows (kBlockRows x D, read as broadcasts) and the streamed tile
// (kTile x (D + 1): +1 so lane j reads row j conflict-free), two of each.
constexpr size_t smem_bytes(int d) {
  return sizeof(float) * (2 * kBlockRows * d + 2 * kTile * (d + 1) + 2 * kTile);
}

template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const T* src,
                                          long long row_stride, int row0, int n_rows,
                                          int limit) {
  // rows [row0, row0 + n_rows) of src into dst; rows at or past limit are zero
  for (int i = threadIdx.x; i < n_rows * D; i += kWarps * 32) {
    const int r = i / D, c = i % D;
    dst[r * pitch + c] =
        row0 + r < limit ? repro::to_f32(src[(row0 + r) * row_stride + c]) : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) s += a[c] * b[c];
  return s;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ kv_len, float* __restrict__ dq,
                    Strides qs_, Strides ks_, Strides vs_, Strides dos_, int sq, int skv,
                    int hq, int hkv, int causal, float scale) {
  constexpr int C = D / 32;
  extern __shared__ float smem[];
  float* q_s = smem;                        // [kBlockRows][D]
  float* do_s = q_s + kBlockRows * D;       // [kBlockRows][D]
  float* k_s = do_s + kBlockRows * D;       // [kTile][D + 1]
  float* v_s = k_s + kTile * (D + 1);       // [kTile][D + 1]

  const int q0 = blockIdx.x * kBlockRows;
  const int b = blockIdx.y / hq;
  const int h = blockIdx.y % hq;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(kv_len[b], skv);

  load_rows<T, D>(q_s, D, q + b * qs_.b + h * qs_.h, qs_.s, q0, kBlockRows, sq);
  load_rows<T, D>(do_s, D, dout + b * dos_.b + h * dos_.h, dos_.s, q0, kBlockRows, sq);
  const T* kb = k + b * ks_.b + hk * ks_.h;
  const T* vb = v + b * vs_.b + hk * vs_.h;
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
    load_rows<T, D>(k_s, D + 1, kb, ks_.s, kv0, kTile, len);
    load_rows<T, D>(v_s, D + 1, vb, vs_.s, kv0, kTile, len);
    __syncthreads();

    const int kid = kv0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int qi = q0 + r;
      const float s = dot<D>(q_s + r * D, k_s + lane * (D + 1)) * scale;
      const float dp = dot<D>(do_s + r * D, v_s + lane * (D + 1));
      const bool valid = qi < sq && kid < len && (!causal || kid <= qi);
      const float p = valid ? expf(s - lse_r[i]) : 0.f;
      const float ds = p * (dp - delta_r[i]) * scale;
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) {
        const float dsj = __shfl_sync(repro::kFullMask, ds, j);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] += dsj * k_s[j * (D + 1) + lane + 32 * c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    if (qi >= sq) continue;
    float* row = dq + ((static_cast<long long>(b) * sq + qi) * hq + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) row[lane + 32 * c] = acc[i][c];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ kv_len, float* __restrict__ dk,
                     float* __restrict__ dv, Strides qs_, Strides ks_, Strides vs_,
                     Strides dos_, int sq, int skv, int hq, int hkv, int causal,
                     float scale) {
  constexpr int C = D / 32;
  extern __shared__ float smem[];
  float* k_s = smem;                        // [kBlockRows][D]
  float* v_s = k_s + kBlockRows * D;        // [kBlockRows][D]
  float* q_s = v_s + kBlockRows * D;        // [kTile][D + 1]
  float* do_s = q_s + kTile * (D + 1);      // [kTile][D + 1]
  float* lse_s = do_s + kTile * (D + 1);    // [kTile]
  float* delta_s = lse_s + kTile;           // [kTile]

  const int j0 = blockIdx.x * kBlockRows;
  const int b = blockIdx.y / hkv;
  const int hk = blockIdx.y % hkv;
  const int group = hq / hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(kv_len[b], skv);

  load_rows<T, D>(k_s, D, k + b * ks_.b + hk * ks_.h, ks_.s, j0, kBlockRows, len);
  load_rows<T, D>(v_s, D, v + b * vs_.b + hk * vs_.h, vs_.s, j0, kBlockRows, len);

  float acc_k[kRowsPerWarp][C], acc_v[kRowsPerWarp][C];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
  }

  // a key tile wholly past kv_len gets no gradient; under the causal mask
  // only query tiles from the one holding key j0 on can see these keys
  const int q_begin = j0 >= len ? sq : (causal ? (j0 / kTile) * kTile : 0);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * qs_.b + h * qs_.h;
    const T* dob = dout + b * dos_.b + h * dos_.h;
    const long long stat = (static_cast<long long>(b) * hq + h) * sq;
    for (int qt = q_begin; qt < sq; qt += kTile) {
      __syncthreads();  // the previous tile is consumed (and k_s, v_s are in)
      load_rows<T, D>(q_s, D + 1, qb, qs_.s, qt, kTile, sq);
      load_rows<T, D>(do_s, D + 1, dob, dos_.s, qt, kTile, sq);
      if (threadIdx.x < kTile) {
        const int qi = qt + threadIdx.x;
        lse_s[threadIdx.x] = qi < sq ? lse[stat + qi] : 0.f;
        delta_s[threadIdx.x] = qi < sq ? delta[stat + qi] : 0.f;
      }
      __syncthreads();

      const int qi = qt + lane;
      const float* q_row = q_s + lane * (D + 1);
      const float* do_row = do_s + lane * (D + 1);
      const float lse_q = lse_s[lane], delta_q = delta_s[lane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp * kRowsPerWarp + i;
        const int kj = j0 + r;
        const float s = dot<D>(q_row, k_s + r * D) * scale;
        const float dp = dot<D>(do_row, v_s + r * D);
        const bool valid = qi < sq && kj < len && (!causal || kj <= qi);
        const float p = valid ? expf(s - lse_q) : 0.f;
        const float ds = p * (dp - delta_q) * scale;
#pragma unroll 4
        for (int l = 0; l < kTile; ++l) {
          const float pl = __shfl_sync(repro::kFullMask, p, l);
          const float dsl = __shfl_sync(repro::kFullMask, ds, l);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            acc_v[i][c] += pl * do_s[l * (D + 1) + lane + 32 * c];
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
    const long long off = ((static_cast<long long>(b) * skv + kj) * hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[off + lane + 32 * c] = acc_k[i][c];
      dv[off + lane + 32 * c] = acc_v[i][c];
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const int* kv_len, float* dq,
                   float* dk, float* dv, Strides qs, Strides ks, Strides vs, Strides dos,
                   int b, int sq, int skv, int hq, int hkv, int causal, float scale,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(D);
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  cudaError_t e = opt_in(flash_bwd_dq_kernel<T, D>, bytes);
  if (e != cudaSuccess) return e;
  e = opt_in(flash_bwd_dkv_kernel<T, D>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 dq_grid((sq + kBlockRows - 1) / kBlockRows, b * hq);
  flash_bwd_dq_kernel<T, D><<<dq_grid, kWarps * 32, bytes, stream>>>(
      q_, k_, v_, do_, lse, delta, kv_len, dq, qs, ks, vs, dos, sq, skv, hq, hkv, causal,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 dkv_grid((skv + kBlockRows - 1) / kBlockRows, b * hkv);
  flash_bwd_dkv_kernel<T, D><<<dkv_grid, kWarps * 32, bytes, stream>>>(
      q_, k_, v_, do_, lse, delta, kv_len, dk, dv, qs, ks, vs, dos, sq, skv, hq, hkv,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, dout (B, Sq, Hq, D) and k/v (B, Skv, Hkv, D) with the given element
// strides for the B, S and H axes (D contiguous), one dtype; lse and
// delta (B, Hq, Sq) float32 contiguous; kv_len (B,) int32.  dq (B, Sq,
// Hq, D), dk/dv (B, Skv, Hkv, D) float32 contiguous.  D is 64 or 128;
// causal calls are square.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* kv_len, void* dq, void* dk, void* dv, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, int b, int sq, int skv, int hq, int hkv, int d, int causal,
    float scale, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0) return static_cast<int>(cudaGetLastError());
  if ((d != 64 && d != 128) || hkv <= 0 || hq % hkv != 0 || (causal && sq != skv))
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
  cudaError_t e;
  if (dtype == repro::kBF16) {
    e = d == 128 ? launch<__nv_bfloat16, 128>(q, k, v, dout, l, dl, len, dq_, dk_, dv_, qs, ks, vs, dos, b, sq, skv, hq, hkv, causal, scale, s)
                 : launch<__nv_bfloat16, 64>(q, k, v, dout, l, dl, len, dq_, dk_, dv_, qs, ks, vs, dos, b, sq, skv, hq, hkv, causal, scale, s);
  } else {
    e = d == 128 ? launch<float, 128>(q, k, v, dout, l, dl, len, dq_, dk_, dv_, qs, ks, vs, dos, b, sq, skv, hq, hkv, causal, scale, s)
                 : launch<float, 64>(q, k, v, dout, l, dl, len, dq_, dk_, dv_, qs, ks, vs, dos, b, sq, skv, hq, hkv, causal, scale, s);
  }
  return static_cast<int>(e);
}
