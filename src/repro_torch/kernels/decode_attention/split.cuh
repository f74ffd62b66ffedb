// The split kernel and the combine pass shared by the decode and verify
// attention kernels (decode_attention.cu, verify_attention.cu): a block of
// query rows per (batch row, KV head) attends the live keys of a dense or
// a paged KV cache, the KV axis split across blocks.
//
// Query rows.  q (B, Hkv, rows, D) holds, for each KV head, a window of T
// positions x G grouped queries, t-major: row r = t * G + g is the query at
// position pos + r / G, and attends keys <= pos + r / G (every window row's
// K/V was written before the launch).  One-token decode is T = 1 (rows =
// G), built without the rows' own limits (kWindow false); a verify window
// keeps them at every T, and at T = 1 they mask nothing more, so a T = 1
// verify adds decode's products in decode's order.  The window's
// live keys are n = min(pos + T, n_keys_max), the window's last position
// + 1; rows at or past n are zero-filled (src-size 0) and never scored,
// since pages and dense tails hold garbage (fresh growth pages too) and
// 0 * NaN would poison a sum.  A key inside the window but past row r's
// own limit scores kMaskValue (-0.7 * f32max) with p = 0, as the Pallas
// kernels mask.
//
// Design.  The grid is (B * Hkv * ceil(rows / GR), splits): `splits` comes
// from the shapes alone (the wrappers' decode_splits / verify_splits, two
// blocks an SM where the keys allow it), and the window's n live keys are
// cut into splits of split_keys(n, splits) keys, a multiple of 32 that
// depends on n and the split count only.  So a row's sums never depend on
// the layout, on the table's width or on the other rows of the batch:
// dense and paged decode add the same products in the same order and
// agree bit for bit in f32.  Each block walks its split in 32-key tiles
// through a 3-stage ring in shared memory, filled by 16-byte cp.async
// copies of whole rows in the cache's own type (bf16, f32 or int8, plus
// one 4-byte copy of each int8 row's scale).  A row is resolved once a
// tile, by the lane of its index in each warp (the page lookup
// block_tables[b, min(t / page_size, last / page_size)] with last = pos +
// T - 1, the Pallas index maps' clamp: a dead slot's runaway pos clamps to
// the table's last column, as t < n <= NB * page_size), and the copying
// lanes take its offset by __shfl_sync.  Values widen to f32 as they are
// read.  Four warps share each tile, 8 keys each; a key's row is spread
// over D / 8 lanes (8 columns a lane: 4 at 4 * sub and 4 at D / 2 + 4 *
// sub), whose dot products with the GR query rows of the block (held in
// registers) are summed by __shfl_xor_sync, the paper's HW reduce.  Each
// lane group keeps its own running (m, l, acc) for its GR query rows; the
// groups of a warp merge by shuffles, the warps in shared memory in a
// fixed order, and the block writes its partial (m, l, unnormalized acc)
// to f32 scratch that the wrapper allocates.  A block whose split starts
// past n writes m = -inf, l = 0 and stops.  decode_combine_kernel (D
// threads, a column each) then reduces each output row's used splits in
// split order, M = max m_s, o = sum exp(m_s - M) acc_s / sum exp(m_s - M)
// l_s, a zero sum finalizing as 1; no atomics, so repeated launches give
// the same bits.  The used splits come from the window's n, the same for
// every row of the window.
//
// The one case decode never meets: in a window, a split can lie wholly
// past an early row's limit (keys pos + 1 .. of row t = 0, say, in the
// split that holds only the window's later positions).  That row's
// partial is then (m = kMaskValue, l = 0, acc = 0): every score is the
// mask, every p is 0.  Its combine factor exp(kMaskValue - M) is exactly
// 0, since M is a real score (the first split always holds key 0, which
// every row attends), so it adds nothing.
//
// A call is a few microseconds of dependent loads (pos, the page table,
// the tile, the partials), so the latency chain is cut where it can be:
// the query rows are loaded before pos is known, and the combine is a
// programmatic dependent launch (Hopper): it is launched while the split
// grid drains and waits for it with griddepcontrol.wait.  int8 elements
// are dequantized as float(q8) * scale when read, as the Pallas kernels
// dequantize before their dot.  Query rows come in register blocks of GR
// = 1, 4 or 6 (qwen2's G; rows <= 32, and more than 6 rows take up to 6
// row blocks, each reading the split's tiles from L2): a verify window of
// T = 4 at G = 6 is 4 row blocks, one window position each.  GR 8 spills
// in f32.
#pragma once

#include "common.cuh"
#include "flash_attention/tc.cuh"

#include <cstdint>
#include <type_traits>

// internal linkage: each including source builds its own instantiations
namespace repro::split {
namespace {

namespace tc = repro::tc;

constexpr int kTileK = 32;   // keys a tile; the keys per split are a multiple
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;   // tiles in the cp.async ring
constexpr int kEpl = 8;      // columns a lane holds
constexpr int kMaxRows = 32; // query rows a KV head (T * G)
constexpr int kMaxSplits = 264;  // SPLIT_BLOCKS: the most decode_splits gives

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

// keys per split of a window with n live keys: the least multiple of 32
// that covers n in `splits` pieces (ops.split_keys)
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

// rows: query rows a KV head (T * G); group: G, so the window is T = rows
// / group positions and row r attends keys <= pos + r / group.  kWindow
// false is decode (T = 1: rows = group), whose rows need no limit of
// their own: every key below n = min(pos + 1, n_keys_max) is at or before
// pos.  The decode entry points take it, the verify ones kWindow true,
// at every T: the masks then read the same keys and the sums are decode's.
template <typename T, typename TC, int D, int GR, bool kPaged, bool kWindow>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const TC* __restrict__ k, const TC* __restrict__ v,
                    const int* __restrict__ pos, const int* __restrict__ block_tables,
                    float* __restrict__ part, Strides ks_, Strides vs_, Scales sc,
                    long long bt_stride, int page_size, int n_keys_max, int hkv, int rows,
                    int group, float scale) {
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

  const int n_gc = (rows + GR - 1) / GR;
  const int bh = blockIdx.x / n_gc, g0 = (blockIdx.x % n_gc) * GR;
  const int b = bh / hkv, h = bh % hkv;
  const int split = blockIdx.y, splits = gridDim.y;
  // each row's window position, from the shapes (before pos is known)
  const int window = kWindow ? rows / group : 1;
  int row_t[GR];
#pragma unroll
  for (int g = 0; g < GR; ++g) row_t[g] = kWindow ? (g0 + g) / group : 0;
  const int p = pos[b];
  const int n_keys = max(0, min(p + window, n_keys_max));
  const int chunk = split_keys(n_keys, splits);
  const int k0 = split * chunk;
  const int mine = min(GR, rows - g0);          // rows of this block
  // partial row (bh, split, r): acc at part[row * D], (m, l) after all acc
  const long long row0 = (static_cast<long long>(bh) * splits + split) * rows + g0;
  float* ml = part + static_cast<long long>(gridDim.x / n_gc) * splits * rows * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPR, sub = lane % LPR;
  // the query rows' loads first, in q's type: they do not wait for pos
  T qt[GR][kEpl];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    const long long qrow = static_cast<long long>(bh) * rows + g0 + g;
#pragma unroll
    for (int e = 0; e < kEpl; ++e)
      qt[g][e] = g < mine ? q[qrow * D + col<D>(sub, e)] : repro::from_f32<T>(0.f);
  }
  // the combine pass may launch now; it waits for this grid's partials
  asm volatile("griddepcontrol.launch_dependents;");

  if (k0 >= n_keys) {  // nothing of the window's keys: an empty partial
    if (threadIdx.x < mine) {
      ml[(row0 + threadIdx.x) * 2] = -INFINITY;
      ml[(row0 + threadIdx.x) * 2 + 1] = 0.f;
    }
    return;
  }
  const int lim = min(k0 + chunk, n_keys);
  const int n_tiles = (lim - k0 + kTileK - 1) / kTileK;
  // each row's last live key (a window's row r: pos + r / group)
  int row_last[GR];
#pragma unroll
  for (int g = 0; g < GR; ++g) row_last[g] = p + row_t[g];

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
        // the index maps' clamp at the window's last block
        const int blk = min(kid / page_size, (p + window - 1) / page_size);
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
      const bool live = kv0 + j < lim;
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < kEpl; ++e) d = fmaf(qr[g][e], kx[e], d);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) d += __shfl_xor_sync(repro::kFullMask, d, o);
        s[i][g] = live && (!kWindow || kv0 + j <= row_last[g]) ? d * scale : repro::kMaskValue;
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
        const int kid = kv0 + warp * (kTileK / kWarps) + i * KPW + grp;
        s[i][g] = kid < lim && (!kWindow || kid <= row_last[g]) ? expf(s[i][g] - mn) : 0.f;
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
  if (threadIdx.x < mine * kWarps) {
    const int g = threadIdx.x / kWarps, w = threadIdx.x % kWarps;
    float mx = red_ml[g * 2];
#pragma unroll
    for (int u = 1; u < kWarps; ++u) mx = fmaxf(mx, red_ml[(u * GR + g) * 2]);
    fac[g * kWarps + w] = expf(red_ml[(w * GR + g) * 2] - mx);
    if (w == 0) ml[(row0 + g) * 2] = mx;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < mine * D; i += kThreads) {
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

// one block of D threads per output row (b, h, r), a column a thread: the
// window's used splits' factors exp(m_s - M) in shared memory, then the
// sums over the splits in split order
template <typename T, int D, bool kWindow>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part, const int* __restrict__ pos,
                      T* __restrict__ o, int n_keys_max, int hkv, int rows, int group,
                      int splits, long long n_rows) {
  __shared__ float f_s[kMaxSplits], l_s[kMaxSplits];
  const int row = blockIdx.x, c = threadIdx.x;
  const int bh = row / rows, r = row % rows, b = bh / hkv;
  const int n_keys = max(0, min(pos[b] + (kWindow ? rows / group : 1), n_keys_max));
  const int chunk = split_keys(n_keys, splits);
  const int used = (n_keys + chunk - 1) / chunk;
  const float* ml = part + n_rows * D;
  // partial row of split s: first + s * rows
  const long long first = static_cast<long long>(bh) * splits * rows + r;

  // launched early (programmatic dependent launch): wait until the split
  // grid has finished and its partials are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int s = c; s < used; s += D) {
    f_s[s] = ml[(first + s * rows) * 2];
    l_s[s] = ml[(first + s * rows) * 2 + 1];
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
  for (int s = 0; s < used; ++s) acc += f_s[s] * part[(first + s * rows) * D + c];
  o[static_cast<long long>(row) * D + c] = repro::from_f32<T>(acc / (l == 0.f ? 1.f : l));
}

// the arguments of one call, as the entry points take them
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  const int* bt;  // block tables (paged)
  void* o;
  float* part;    // the partials' scratch
  int splits;
  Strides ks, vs;
  Scales sc;
  long long bt_stride;
  int page_size, n_keys_max, b, hkv, rows, group;
  float scale;
};

template <typename T, typename TC, int D, int GR, bool kPaged, bool kWindow>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = Smem<TC, D, GR>::BYTES;
  auto kernel = decode_split_kernel<T, TC, D, GR, kPaged, kWindow>;
  if constexpr (bytes > 48 * 1024) {  // above 48 KB: opt in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  const int n_gc = (a.rows + GR - 1) / GR;
  kernel<<<dim3(a.b * a.hkv * n_gc, a.splits), kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const TC*>(a.k), static_cast<const TC*>(a.v),
      a.pos, a.bt, a.part, a.ks, a.vs, a.sc, a.bt_stride, a.page_size, a.n_keys_max, a.hkv,
      a.rows, a.group, a.scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the combine pass as a programmatic dependent launch: it starts while
  // the split grid drains and waits for it (griddepcontrol.wait)
  const long long n_rows = static_cast<long long>(a.b) * a.hkv * a.splits * a.rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.b * a.hkv * a.rows);
  cfg.blockDim = dim3(D);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_combine_kernel<T, D, kWindow>,
                            static_cast<const float*>(a.part), a.pos, static_cast<T*>(a.o),
                            a.n_keys_max, a.hkv, a.rows, a.group, a.splits, n_rows);
}

// the register block for a head's rows: 1, 4 or 6 (ops.row_blocks)
template <typename T, typename TC, int D, bool kPaged, bool kWindow>
cudaError_t by_rows(const Args& a, cudaStream_t s) {
  if (a.rows == 1) return launch<T, TC, D, 1, kPaged, kWindow>(a, s);
  if (a.rows <= 4) return launch<T, TC, D, 4, kPaged, kWindow>(a, s);
  return launch<T, TC, D, 6, kPaged, kWindow>(a, s);
}

// q's type from dtype; the cache's type is q's, or int8_t when kInt8;
// kWindow: a verify window (else decode, rows = group)
template <bool kPaged, bool kInt8, bool kWindow>
int dispatch(const Args& a, int d, int dtype, void* stream) {
  using BF = __nv_bfloat16;
  using CB = typename std::conditional<kInt8, int8_t, BF>::type;
  using CF = typename std::conditional<kInt8, int8_t, float>::type;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.b <= 0 || a.hkv <= 0 || a.rows <= 0) return 0;
  if (a.rows > kMaxRows || a.group <= 0 || a.rows % a.group != 0 ||
      (!kWindow && a.rows != a.group) || a.splits <= 0 || a.splits > kMaxSplits ||
      (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == repro::kBF16)
    e = d == 128 ? by_rows<BF, CB, 128, kPaged, kWindow>(a, s)
                 : by_rows<BF, CB, 64, kPaged, kWindow>(a, s);
  else
    e = d == 128 ? by_rows<float, CF, 128, kPaged, kWindow>(a, s)
                 : by_rows<float, CF, 64, kPaged, kWindow>(a, s);
  return static_cast<int>(e);
}

}  // namespace
}  // namespace repro::split
