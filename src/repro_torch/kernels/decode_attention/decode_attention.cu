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
// Design.  The grid is (B * Hkv * ceil(G / GR), splits): `splits` comes
// from the shapes alone (ops.decode_splits: two blocks an SM where the
// keys allow it), and a row with n = min(pos + 1, n_keys_max) live keys
// cuts them into splits of split_keys(n, splits) keys, a multiple of 32
// that depends on n and the split count only.  So a row's sums never
// depend on the layout, on the table's width or on the other rows of the
// batch: dense and paged decode add the same products in the same order
// and agree bit for bit in f32.  Each block walks its split in 32-key
// tiles through a 3-stage ring in shared memory, filled by 16-byte
// cp.async copies of whole rows in the cache's own type (bf16, f32 or
// int8, plus one 4-byte copy of each int8 row's scale); rows past n are
// zero-filled (src-size 0) and never read, since pages and dense tails
// hold garbage and 0 * NaN would poison a sum.  A row is resolved once a
// tile, by the lane of its index in each warp (the page lookup
// block_tables[b, min(t / page_size, pos / page_size)], the Pallas index
// map's clamp), and the copying lanes take its offset by __shfl_sync.
// Values widen to f32 as they are read.  Four warps share each tile, 8
// keys each; a key's row is spread over D / 8 lanes (8 columns a lane:
// 4 at 4 * sub and 4 at D / 2 + 4 * sub), whose dot products with the G
// query rows (held in registers) are summed by __shfl_xor_sync, the
// paper's HW reduce.  Each lane group keeps its own running (m, l, acc)
// for its GR query rows; the groups of a warp merge by shuffles, the
// warps in shared memory in a fixed order, and the block writes its
// partial (m, l, unnormalized acc) to f32 scratch that the wrapper
// allocates.  A block whose split starts past n writes m = -inf, l = 0
// and stops.  decode_combine_kernel (D threads, a column each) then
// reduces each output row's used splits in split order, M = max m_s,
// o = sum exp(m_s - M) acc_s / sum exp(m_s - M) l_s, a zero sum
// finalizing as 1; no atomics, so repeated launches give the same bits.
// A decode call is a few microseconds of dependent loads (pos, the page
// table, the tile, the partials), so the latency chain is cut where it
// can be: the query rows are loaded before pos is known, and the combine
// is a programmatic dependent launch (Hopper): it is launched while the
// split grid drains and waits for it with griddepcontrol.wait.  int8
// elements are dequantized as float(q8) * scale when read, as the Pallas
// kernel dequantizes before its dot.  Query rows come in register blocks
// of GR = 1, 4 or 6 (qwen2's G; G <= 16, and G > 6 takes two or three
// row blocks, each reading the tile: no path runs such a group).
#include "common.cuh"
#include "flash_attention/tc.cuh"

#include <cstdint>
#include <type_traits>

namespace {

namespace tc = repro::tc;

constexpr int kTileK = 32;   // keys a tile; the keys per split are a multiple
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;   // tiles in the cp.async ring
constexpr int kEpl = 8;      // columns a lane holds
constexpr int kMaxGroup = 16;
constexpr int kMaxSplits = 264;  // ops.SPLIT_BLOCKS: the most decode_splits gives

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

// keys per split of a row with n live keys: the least multiple of 32 that
// covers n in `splits` pieces (ops.split_keys)
__host__ __device__ __forceinline__ int split_keys(int n, int splits) {
  const int per = (n + splits - 1) / splits;
  const int keys = (per + kTileK - 1) / kTileK * kTileK;
  return keys > kTileK ? keys : kTileK;
}

// column of a lane's element e: 4 at 4 * sub, 4 at D / 2 + 4 * sub, so the
// lanes of a row read neighbouring words in both halves
template <int D> __device__ __forceinline__ int col(int sub, int e) {
  return (e < 4 ? 0 : D / 2) + 4 * sub + (e & 3);
}

__device__ __forceinline__ void widen4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}

__device__ __forceinline__ void widen4(const __nv_bfloat16* p, float* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}

__device__ __forceinline__ void widen4(const int8_t* p, float* x) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  x[0] = c.x, x[1] = c.y, x[2] = c.z, x[3] = c.w;
}

// a lane's 8 columns of a shared row, widened to f32
template <typename TC, int D>
__device__ __forceinline__ void read_row(const TC* row, int sub, float (&x)[kEpl]) {
  widen4(row + 4 * sub, x);
  widen4(row + D / 2 + 4 * sub, x + 4);
}

template <typename TC, int D, int GR>
struct Smem {
  static constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  static constexpr int TILE = kTileK * D;  // elements of a K or V tile
  static constexpr size_t RING = kStages * 2 * TILE * sizeof(TC);
  static constexpr size_t SCALES = kQuant ? kStages * 2 * kTileK * sizeof(float) : 0;
  // the warps' merge reuses the ring: acc (kWarps, GR, D), (m, l), factors
  static constexpr size_t MERGE = kWarps * GR * (D + 3) * sizeof(float);
  static constexpr size_t BYTES = RING + SCALES > MERGE ? RING + SCALES : MERGE;
};

template <typename T, typename TC, int D, int GR, bool kPaged>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const TC* __restrict__ k, const TC* __restrict__ v,
                    const int* __restrict__ pos, const int* __restrict__ block_tables,
                    float* __restrict__ part, Strides ks_, Strides vs_, Scales sc,
                    long long bt_stride, int page_size, int n_keys_max, int hkv, int group,
                    float scale) {
  using S = Smem<TC, D, GR>;
  constexpr bool kQuant = S::kQuant;
  static_assert(!kQuant || kPaged, "int8 caches are paged");
  constexpr int LPR = D / kEpl;                 // lanes a key row
  constexpr int KPW = 32 / LPR;                 // keys a warp reads at once
  constexpr int NK = kTileK / kWarps / KPW;     // keys a lane group takes a tile
  constexpr int VEC = 16 / sizeof(TC);          // elements a 16-byte copy
  constexpr int CPR = D / VEC;                  // copies a row
  constexpr int COPIES = 2 * kTileK * CPR / kThreads;
  static_assert(2 * kTileK * CPR % kThreads == 0 && kTileK * CPR >= kThreads,
                "each warp copies whole K or V rows");
  extern __shared__ __align__(16) unsigned char smem[];
  TC* ring = reinterpret_cast<TC*>(smem);                          // [stage][K|V][key][D]
  float* scl = reinterpret_cast<float*>(smem + S::RING);           // [stage][K|V][key]

  const int n_gc = (group + GR - 1) / GR;
  const int bh = blockIdx.x / n_gc, g0 = (blockIdx.x % n_gc) * GR;
  const int b = bh / hkv, h = bh % hkv;
  const int split = blockIdx.y, splits = gridDim.y;
  const int p = pos[b];
  const int n_keys = max(0, min(p + 1, n_keys_max));
  const int chunk = split_keys(n_keys, splits);
  const int k0 = split * chunk;
  const int rows = min(GR, group - g0);
  // partial row (bh, split, g): acc at part[row * D], (m, l) after all acc
  const long long row0 = (static_cast<long long>(bh) * splits + split) * group + g0;
  float* ml = part + static_cast<long long>(gridDim.x / n_gc) * splits * group * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPR, sub = lane % LPR;
  // the query rows' loads first, in q's type: they do not wait for pos
  T qt[GR][kEpl];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    const long long qrow = static_cast<long long>(bh) * group + g0 + g;
#pragma unroll
    for (int e = 0; e < kEpl; ++e)
      qt[g][e] = g < rows ? q[qrow * D + col<D>(sub, e)] : repro::from_f32<T>(0.f);
  }
  // the combine pass may launch now; it waits for this grid's partials
  asm volatile("griddepcontrol.launch_dependents;");

  if (k0 >= n_keys) {  // nothing of this row's keys: an empty partial
    if (threadIdx.x < rows) {
      ml[(row0 + threadIdx.x) * 2] = -INFINITY;
      ml[(row0 + threadIdx.x) * 2 + 1] = 0.f;
    }
    return;
  }
  const int lim = min(k0 + chunk, n_keys);
  const int n_tiles = (lim - k0 + kTileK - 1) / kTileK;

  // tile t of the split into ring stage t % kStages; lane r of each warp
  // resolves row r, the copying lanes fetch its offset by shuffle
  auto stage = [&](int t) {
    const int kid = k0 + t * kTileK + lane;
    const bool live = kid < lim;
    long long page = b;
    int off = kid;
    if constexpr (kPaged) {
      page = 0, off = 0;
      if (live) {
        const int blk = min(kid / page_size, p / page_size);
        page = block_tables[b * bt_stride + blk];
        off = kid % page_size;
      }
    }
    // the row's element offset in K and in V, -1 past the split's keys
    const long long ko = live ? page * ks_.b + off * ks_.s + h * ks_.h : -1;
    const long long vo = live ? page * vs_.b + off * vs_.s + h * vs_.h : -1;
    TC* kd = ring + (t % kStages) * 2 * S::TILE;
#pragma unroll
    for (int i = 0; i < COPIES; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const bool is_v = idx >= kTileK * CPR;   // the same for a whole warp
      const int rem = is_v ? idx - kTileK * CPR : idx;
      const int r = rem / CPR, c = rem % CPR;
      const long long ro = __shfl_sync(repro::kFullMask, is_v ? vo : ko, r);
      const TC* base = is_v ? v : k;
      tc::cp_async16(kd + (is_v ? S::TILE : 0) + r * D + c * VEC,
                     ro >= 0 ? base + ro + c * VEC : base, ro >= 0);
    }
    if constexpr (kQuant) {
      if (threadIdx.x < 2 * kTileK) {  // warp 0: K scales, warp 1: V scales
        const bool is_v = threadIdx.x >= kTileK;
        const float* src =
            !live ? sc.k : is_v ? sc.v + page * sc.vp + off * sc.vo : sc.k + page * sc.kp + off * sc.ko;
        tc::cp_async4(scl + ((t % kStages) * 2 + is_v) * kTileK + lane, src, live);
      }
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {  // the ring's first tiles, then q
    if (t < n_tiles) stage(t);
    tc::cp_async_commit();
  }

  float qr[GR][kEpl], m[GR], l[GR], acc[GR][kEpl];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
#pragma unroll
    for (int e = 0; e < kEpl; ++e) qr[g][e] = repro::to_f32(qt[g][e]);
    m[g] = -INFINITY, l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kEpl; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + kStages - 1 < n_tiles) stage(t + kStages - 1);
    tc::cp_async_commit();
    tc::cp_async_wait<kStages - 1>();  // tile t has landed (this thread's copies)
    __syncthreads();                   // ... and every thread's
    const TC* kt = ring + (t % kStages) * 2 * S::TILE;
    const TC* vt = kt + S::TILE;
    const float* kst = scl + (t % kStages) * 2 * kTileK;
    const int kv0 = k0 + t * kTileK;

    // scores of this lane group's NK keys (key j = warp * 8 + i * KPW + grp)
    float s[NK][GR];
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int j = warp * (kTileK / kWarps) + i * KPW + grp;
      float kx[kEpl];
      read_row<TC, D>(kt + j * D, sub, kx);
      if constexpr (kQuant) {
#pragma unroll
        for (int e = 0; e < kEpl; ++e) kx[e] *= kst[j];
      }
      const bool valid = kv0 + j < lim;
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < kEpl; ++e) d = fmaf(qr[g][e], kx[e], d);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) d += __shfl_xor_sync(repro::kFullMask, d, o);
        s[i][g] = valid ? d * scale : repro::kMaskValue;
      }
    }
    // online softmax over them; s becomes p
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      float mt = s[0][g];
#pragma unroll
      for (int i = 1; i < NK; ++i) mt = fmaxf(mt, s[i][g]);
      const float mn = fmaxf(m[g], mt);
      const float alpha = expf(m[g] - mn);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const bool valid = kv0 + warp * (kTileK / kWarps) + i * KPW + grp < lim;
        s[i][g] = valid ? expf(s[i][g] - mn) : 0.f;
        sum += s[i][g];
      }
      l[g] = alpha * l[g] + sum;
#pragma unroll
      for (int e = 0; e < kEpl; ++e) acc[g][e] *= alpha;
      m[g] = mn;
    }
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int j = warp * (kTileK / kWarps) + i * KPW + grp;
      float vx[kEpl];
      read_row<TC, D>(vt + j * D, sub, vx);
      if constexpr (kQuant) {
#pragma unroll
        for (int e = 0; e < kEpl; ++e) vx[e] *= kst[kTileK + j];
      }
#pragma unroll
      for (int g = 0; g < GR; ++g)
#pragma unroll
        for (int e = 0; e < kEpl; ++e) acc[g][e] = fmaf(s[i][g], vx[e], acc[g][e]);
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  tc::cp_async_wait<0>();

  // the lane groups of a warp merge (butterfly over the group index)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      const float mo = __shfl_xor_sync(repro::kFullMask, m[g], o);
      const float lo = __shfl_xor_sync(repro::kFullMask, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float fa = expf(m[g] - mn), fb = expf(mo - mn);
      l[g] = l[g] * fa + lo * fb;
#pragma unroll
      for (int e = 0; e < kEpl; ++e) {
        const float ao = __shfl_xor_sync(repro::kFullMask, acc[g][e], o);
        acc[g][e] = acc[g][e] * fa + ao * fb;
      }
      m[g] = mn;
    }
  }
  // then the warps, in shared memory, in warp order
  __syncthreads();  // every warp is done with the ring
  float* red = reinterpret_cast<float*>(smem);  // acc [warp][g][D]
  float* red_ml = red + kWarps * GR * D;        // [warp][g][m, l]
  float* fac = red_ml + kWarps * GR * 2;        // [g][warp]: exp(m_w - max_w m_w)
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GR; ++g)
#pragma unroll
      for (int e = 0; e < kEpl; ++e) red[(warp * GR + g) * D + col<D>(sub, e)] = acc[g][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      red_ml[(warp * GR + g) * 2] = m[g];
      red_ml[(warp * GR + g) * 2 + 1] = l[g];
    }
  }
  __syncthreads();
  if (threadIdx.x < rows * kWarps) {
    const int g = threadIdx.x / kWarps, w = threadIdx.x % kWarps;
    float mx = red_ml[g * 2];
#pragma unroll
    for (int u = 1; u < kWarps; ++u) mx = fmaxf(mx, red_ml[(u * GR + g) * 2]);
    fac[g * kWarps + w] = expf(red_ml[(w * GR + g) * 2] - mx);
    if (w == 0) ml[(row0 + g) * 2] = mx;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int g = i / D, c = i % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += fac[g * kWarps + w] * red[(w * GR + g) * D + c];
    part[(row0 + g) * D + c] = a;
    if (c == 0) {
      float ll = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) ll += fac[g * kWarps + w] * red_ml[(w * GR + g) * 2 + 1];
      ml[(row0 + g) * 2 + 1] = ll;
    }
  }
}

// one block of D threads per output row (b, h, g), a column a thread: the
// row's used splits' factors exp(m_s - M) in shared memory, then the sums
// over the splits in split order
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part, const int* __restrict__ pos,
                      T* __restrict__ o, int n_keys_max, int hkv, int group, int splits,
                      long long n_rows) {
  __shared__ float f_s[kMaxSplits], l_s[kMaxSplits];
  const int row = blockIdx.x, c = threadIdx.x;
  const int bh = row / group, g = row % group, b = bh / hkv;
  const int n_keys = max(0, min(pos[b] + 1, n_keys_max));
  const int chunk = split_keys(n_keys, splits);
  const int used = (n_keys + chunk - 1) / chunk;
  const float* ml = part + n_rows * D;
  // partial row of split s: first + s * group
  const long long first = static_cast<long long>(bh) * splits * group + g;

  // launched early (programmatic dependent launch): wait until the split
  // grid has finished and its partials are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int s = c; s < used; s += D) {
    f_s[s] = ml[(first + s * group) * 2];
    l_s[s] = ml[(first + s * group) * 2 + 1];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int s = 0; s < used; ++s) mx = fmaxf(mx, f_s[s]);
  __syncthreads();  // every thread has its max before the factors replace m
  for (int s = c; s < used; s += D) f_s[s] = expf(f_s[s] - mx);
  __syncthreads();
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < used; ++s) l += f_s[s] * l_s[s];
#pragma unroll 8
  for (int s = 0; s < used; ++s) acc += f_s[s] * part[(first + s * group) * D + c];
  o[static_cast<long long>(row) * D + c] = repro::from_f32<T>(acc / (l == 0.f ? 1.f : l));
}

template <typename T, typename TC, int D, int GR, bool kPaged>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos, const int* bt,
                   void* o, float* part, int splits, Strides ks, Strides vs, Scales sc,
                   long long bt_stride, int page_size, int n_keys_max, int b, int hkv,
                   int group, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Smem<TC, D, GR>::BYTES;
  auto kernel = decode_split_kernel<T, TC, D, GR, kPaged>;
  if constexpr (bytes > 48 * 1024) {  // above 48 KB: opt in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  const int n_gc = (group + GR - 1) / GR;
  kernel<<<dim3(b * hkv * n_gc, splits), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v), pos, bt,
      part, ks, vs, sc, bt_stride, page_size, n_keys_max, hkv, group, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the combine pass as a programmatic dependent launch: it starts while
  // the split grid drains and waits for it (griddepcontrol.wait)
  const long long n_rows = static_cast<long long>(b) * hkv * splits * group;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * hkv * group);
  cfg.blockDim = dim3(D);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_combine_kernel<T, D>, static_cast<const float*>(part),
                            pos, static_cast<T*>(o), n_keys_max, hkv, group, splits, n_rows);
}

template <typename T, typename TC, int D, bool kPaged>
cudaError_t by_group(const void* q, const void* k, const void* v, const int* pos,
                     const int* bt, void* o, float* part, int splits, Strides ks, Strides vs,
                     Scales sc, long long bt_stride, int page_size, int n_keys_max, int b,
                     int hkv, int group, float scale, cudaStream_t s) {
  if (group == 1)
    return launch<T, TC, D, 1, kPaged>(q, k, v, pos, bt, o, part, splits, ks, vs, sc, bt_stride,
                                       page_size, n_keys_max, b, hkv, group, scale, s);
  if (group <= 4)
    return launch<T, TC, D, 4, kPaged>(q, k, v, pos, bt, o, part, splits, ks, vs, sc, bt_stride,
                                       page_size, n_keys_max, b, hkv, group, scale, s);
  return launch<T, TC, D, 6, kPaged>(q, k, v, pos, bt, o, part, splits, ks, vs, sc, bt_stride,
                                     page_size, n_keys_max, b, hkv, group, scale, s);
}

// q's type T from dtype; the cache's type is T, or int8_t when kInt8
template <bool kPaged, bool kInt8>
int dispatch(const void* q, const void* k, const void* v, const void* pos, const void* bt,
             void* o, void* work, int splits, Strides ks, Strides vs, Scales sc,
             long long bt_stride, int page_size, int n_keys_max, int b, int hkv, int group,
             int d, float scale, int dtype, void* stream) {
  using BF = __nv_bfloat16;
  using CB = typename std::conditional<kInt8, int8_t, BF>::type;
  using CF = typename std::conditional<kInt8, int8_t, float>::type;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(bt);
  float* w = static_cast<float*>(work);
  if (b <= 0 || hkv <= 0 || group <= 0) return 0;
  if (group > kMaxGroup || splits <= 0 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == repro::kBF16) {
    e = d == 128 ? by_group<BF, CB, 128, kPaged>(q, k, v, p, t, o, w, splits, ks, vs, sc, bt_stride,
                                                 page_size, n_keys_max, b, hkv, group, scale, s)
                 : by_group<BF, CB, 64, kPaged>(q, k, v, p, t, o, w, splits, ks, vs, sc, bt_stride,
                                                page_size, n_keys_max, b, hkv, group, scale, s);
  } else {
    e = d == 128 ? by_group<float, CF, 128, kPaged>(q, k, v, p, t, o, w, splits, ks, vs, sc,
                                                    bt_stride, page_size, n_keys_max, b, hkv,
                                                    group, scale, s)
                 : by_group<float, CF, 64, kPaged>(q, k, v, p, t, o, w, splits, ks, vs, sc,
                                                   bt_stride, page_size, n_keys_max, b, hkv,
                                                   group, scale, s);
  }
  return static_cast<int>(e);
}

template <typename TC> int smem_bytes(int d, int gr) {
  if (d == 128)
    return static_cast<int>(gr == 1 ? Smem<TC, 128, 1>::BYTES
                            : gr == 4 ? Smem<TC, 128, 4>::BYTES
                                      : Smem<TC, 128, 6>::BYTES);
  return static_cast<int>(gr == 1 ? Smem<TC, 64, 1>::BYTES
                          : gr == 4 ? Smem<TC, 64, 4>::BYTES
                                    : Smem<TC, 64, 6>::BYTES);
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
  return dispatch<false, false>(q, k, v, pos, nullptr, o, work, splits,
                                Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh}, Scales{},
                                0, 1, s, b, hkv, group, d, scale, dtype, stream);
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
  return dispatch<true, false>(q, k_pages, v_pages, pos, block_tables, o, work, splits,
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
    int nb, int page_size, int hkv, int group, int d, float scale, int dtype, void* work,
    int splits, void* stream) {
  const Scales sc{static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
                  ks_p, ks_o, vs_p, vs_o};
  return dispatch<true, true>(q, k_pages, v_pages, pos, block_tables, o, work, splits,
                              Strides{k_sp, k_so, k_sh}, Strides{v_sp, v_so, v_sh}, sc,
                              bt_stride, page_size, nb * page_size, b, hkv, group, d, scale,
                              dtype, stream);
}
