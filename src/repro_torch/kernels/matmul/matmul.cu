// Tiled GEMM with f32 accumulation on Hopper's tensor cores: the paper's
// Fig. 5 control benchmark, which has no warp collectives.
//
// Replaces: src/repro/kernels/matmul/matmul.py::matmul (_matmul_kernel).
// The TPU kernel fed the MXU with 256x256x512 VMEM blocks and carried the
// f32 accumulator across a sequential K grid axis in scratch.  Here each
// block owns a 128x128 output tile and walks K itself; the accumulator
// stays in registers.  Output rounded once to a's dtype; any M, N, K.
//
// Bound on the H100: operations at large sizes, bytes at Fig. 5's 64^3.
// An f32-accurate product has two ways through the card: the CUDA cores
// (2MNK at 67 TFLOP/s) or three TF32 products on the tensor cores
// (3 x 2MNK at 495 TFLOP/s), the second ~2.5x faster in the limit.  This
// kernel takes the second.
//
// f32: 3xTF32.  Each operand element x is split in registers, as its
// fragment is loaded, into big = tf32(x) and small = tf32(x - big) (both
// rounded to nearest, ties away; x - big is exact in f32), and each k8 step
// adds small_a.big_b, big_a.small_b, then big_a.big_b through
// mma.sync.m16n8k8 tf32 with f32 sums.  big.big alone (1xTF32) is off by
// ~2^-11 a product, three decimal digits; the dropped small.small term is
// ~2^-22.  The tensor cores' f32 sums align their terms to the largest and
// truncate (the bf16 flash kernels lose up to 2^-23 of a running sum a
// step, always toward zero).  So the products of one 32-wide K slice are
// summed from 0, small terms first, into a slice sum that is then folded
// into the running accumulator by an f32 add, which rounds to nearest:
// the truncation is only ever taken against one slice's sum, and its
// sign follows that sum's, which changes from slice to slice.  The slice
// sums cost 64 registers a thread beside the 64 of the accumulator, so a
// block of 8 warps takes one SM (launch bounds 256, 1) where the
// accumulator alone would allow two; the variant without them
// (scripts/matmul_variants.py, running-sums-2blocks) ran 8 % slower at two
// blocks a SM and was 34x further from a float64 product.  An inf operand
// splits into inf + NaN, so it gives NaN where an f32 product gives inf.
//
// bf16: m16n8k16 bf16 mma.sync with f32 sums, ldmatrix fragment loads
// (flash_attention/tc.cuh); bf16 products are exact in f32, the output's
// bf16 rounding (2^-9) hides the order of the sums.  Two blocks a SM.
//
// Tiles: 128x128 a block, 8 warps of 64x32 (4 x 4 m16n8 tiles); K slices of
// 128 bytes (32 f32, 64 bf16) through a 3-stage ring of 16-byte cp.async
// copies, so two slices are in flight while one computes.  Shared rows are
// padded by 16 bytes: A row-major at a pitch of 36 f32 (72 bf16), B k-major
// at 136.  The f32 fragment reads (A: row g, k t and t+4; B: k t and t+4,
// column g, lane = 4g + t) and the bf16 ldmatrix phases then touch 32
// distinct banks.  3 x 35,840 B of dynamic shared memory, opted in above
// 48 KB before each launch.
//
// Edges: rows and columns past M, N, K are zero-filled by cp.async with a
// src-size of 0.  Where K (for A) or N (for B) is not a multiple of 16
// bytes, or a base is not 16-byte aligned, the 16-byte copies are not
// legal: the kernel's narrow branch (kWide false) copies element by
// element, f32 by 4-byte cp.async, bf16 by 2-byte loads and stores, and
// writes C element by element.
#include <type_traits>

#include "common.cuh"
#include "flash_attention/tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace tc = repro::tc;

constexpr int kBM = 128, kBN = 128;          // block tile
constexpr int kWM = 64, kWN = 32;            // warp tile: 2 warps along M x 4 along N
constexpr int kMT = kWM / 16, kNT = kWN / 8;  // m16 x n8 tiles a warp
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kSliceBytes = 128;             // K bytes a stage

template <typename T>
struct Tile {
  static constexpr int BK = kSliceBytes / sizeof(T);  // K a stage: 32 f32, 64 bf16
  static constexpr int VEC = 16 / sizeof(T);          // elements a 16-byte copy
  static constexpr int AP = BK + VEC;                 // A pitch: 36 f32, 72 bf16
  static constexpr int BP = kBN + 8;                  // B pitch: 136
  static constexpr int A_STAGE = kBM * AP;            // elements
  static constexpr int B_STAGE = BK * BP;
  static constexpr size_t SMEM = sizeof(T) * kStages * (A_STAGE + B_STAGE);
};

// one element global -> shared, zero where pred is false: f32 by a 4-byte
// cp.async, bf16 (2 bytes, below cp.async's smallest copy) synchronously
__device__ __forceinline__ void copy_elem(float* dst, const float* src, bool pred) {
  tc::cp_async4(dst, src, pred);
}

__device__ __forceinline__ void copy_elem(bf16* dst, const bf16* src, bool pred) {
  *dst = pred ? *src : __ushort_as_bfloat16(0);
}

// the K slice [k0, k0 + BK) of A's rows [row0, row0 + kBM) and B's columns
// [col0, col0 + kBN) into one stage; every thread takes part
template <typename T, bool kWide>
__device__ __forceinline__ void load_stage(T* as, T* bs, const T* __restrict__ a,
                                           const T* __restrict__ b, int m, int n, int k,
                                           int row0, int col0, int k0) {
  using S = Tile<T>;
  if constexpr (kWide) {
    constexpr int AC = S::BK / S::VEC;  // 16-byte chunks of an A row slice
    static_assert(kBM * AC % kThreads == 0, "A chunks split evenly");
#pragma unroll
    for (int j = 0; j < kBM * AC / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / AC, c = (i % AC) * S::VEC;
      const bool in = row0 + r < m && k0 + c < k;
      tc::cp_async16(as + r * S::AP + c,
                     in ? a + static_cast<long long>(row0 + r) * k + k0 + c : a, in);
    }
    constexpr int BC = kBN / S::VEC;  // 16-byte chunks of a B row
    static_assert(S::BK * BC % kThreads == 0, "B chunks split evenly");
#pragma unroll
    for (int j = 0; j < S::BK * BC / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / BC, c = (i % BC) * S::VEC;
      const bool in = k0 + r < k && col0 + c < n;
      tc::cp_async16(bs + r * S::BP + c,
                     in ? b + static_cast<long long>(k0 + r) * n + col0 + c : b, in);
    }
  } else {
    for (int i = threadIdx.x; i < kBM * S::BK; i += kThreads) {
      const int r = i / S::BK, c = i % S::BK;
      const bool in = row0 + r < m && k0 + c < k;
      copy_elem(as + r * S::AP + c,
                in ? a + static_cast<long long>(row0 + r) * k + k0 + c : a, in);
    }
    for (int i = threadIdx.x; i < S::BK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const bool in = k0 + r < k && col0 + c < n;
      copy_elem(bs + r * S::BP + c,
                in ? b + static_cast<long long>(k0 + r) * n + col0 + c : b, in);
    }
  }
}

// x rounded to TF32 to nearest, ties away from zero, as a bit pattern (f32
// with the low 13 mantissa bits clear): half a unit of the dropped bits is
// added to the magnitude bits, a carry rounding up into the exponent.  For
// finite x this is cvt.rna.tf32.f32, bit for bit; ptxas expands that
// instruction with a NaN test and a select, which made the kernel 12 %
// slower (scripts/matmul_variants.py, cvt-split).  The plain emulation
// (ref.py::tf32_rna) is the same arithmetic.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a * b: m16n8k8, tf32 inputs, f32 sums.  Fragments (lane = 4g + t):
// A a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B b0 (k t, n g),
// b1 (k t+4, n g); C as the bf16 shape's (tc.cuh)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += this stage's slice of A.B for the warp's 64x32 tile: f32 by
// 3xTF32 into a slice sum folded by f32 adds, bf16 straight into acc
template <typename T>
__device__ __forceinline__ void compute_stage(float (&acc)[kMT][kNT][4], const T* as,
                                              const T* bs, int wm0, int wn0, int lane) {
  using S = Tile<T>;
  if constexpr (std::is_same_v<T, float>) {
    const int g = lane >> 2, t = lane & 3;
    float part[kMT][kNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < S::BK; kk += 8) {
      uint32_t ab[kMT][4], asm_[kMT][4], bb[kNT][2], bsm[kNT][2];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const float* p = as + (wm0 + mi * 16 + g) * S::AP + kk + t;
        split_tf32(p[0], ab[mi][0], asm_[mi][0]);
        split_tf32(p[8 * S::AP], ab[mi][1], asm_[mi][1]);
        split_tf32(p[4], ab[mi][2], asm_[mi][2]);
        split_tf32(p[8 * S::AP + 4], ab[mi][3], asm_[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const float* p = bs + (kk + t) * S::BP + wn0 + ni * 8 + g;
        split_tf32(p[0], bb[ni][0], bsm[ni][0]);
        split_tf32(p[4 * S::BP], bb[ni][1], bsm[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
          mma_tf32(part[mi][ni], asm_[mi], bb[ni][0], bb[ni][1]);
          mma_tf32(part[mi][ni], ab[mi], bsm[ni][0], bsm[ni][1]);
          mma_tf32(part[mi][ni], ab[mi], bb[ni][0], bb[ni][1]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  } else {
#pragma unroll
    for (int kk = 0; kk < S::BK; kk += 16) {
      uint32_t af[kMT][4], bfr[kNT / 2][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
        tc::ldmatrix_x4(af[mi], tc::a_row<S::AP>(as, wm0 + mi * 16, kk, lane));
#pragma unroll
      for (int nj = 0; nj < kNT / 2; ++nj)
        tc::ldmatrix_x4_trans(bfr[nj], tc::b_col<S::BP>(bs, kk, wn0 + nj * 16, lane));
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
        for (int nj = 0; nj < kNT / 2; ++nj) {
          tc::mma(acc[mi][2 * nj], af[mi], bfr[nj][0], bfr[nj][1]);
          tc::mma(acc[mi][2 * nj + 1], af[mi], bfr[nj][2], bfr[nj][3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void store_pair(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}

__device__ __forceinline__ void store_pair(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

template <typename T, bool kWide, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
matmul_tc_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c, int m,
                 int n, int k) {
  using S = Tile<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);       // [kStages][kBM][AP]
  T* sb = sa + kStages * S::A_STAGE;         // [kStages][BK][BP]
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / (kBN / kWN)) * kWM, wn0 = (warp % (kBN / kWN)) * kWN;
  const int n_slices = (k + S::BK - 1) / S::BK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slices)
      load_stage<T, kWide>(sa + s * S::A_STAGE, sb + s * S::B_STAGE, a, b, m, n, k, row0,
                           col0, s * S::BK);
    tc::cp_async_commit();
  }

  float acc[kMT][kNT][4] = {};
  for (int kt = 0; kt < n_slices; ++kt) {
    tc::cp_async_wait<kStages - 2>();  // slice kt has landed (this thread's copies) ...
    __syncthreads();  // ... everyone's, and slice kt - 1's stage is consumed
    const int next = kt + kStages - 1;
    if (next < n_slices) {
      const int st = next % kStages;
      load_stage<T, kWide>(sa + st * S::A_STAGE, sb + st * S::B_STAGE, a, b, m, n, k, row0,
                           col0, next * S::BK);
    }
    tc::cp_async_commit();
    const int st = kt % kStages;
    compute_stage<T>(acc, sa + st * S::A_STAGE, sb + st * S::B_STAGE, wm0, wn0, lane);
  }
  tc::cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + wm0 + mi * 16 + g + 8 * h;
      if (gr >= m) continue;
      T* crow = c + static_cast<long long>(gr) * n;
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const int gc = col0 + wn0 + ni * 8 + 2 * t;
        const float x0 = acc[mi][ni][2 * h], x1 = acc[mi][ni][2 * h + 1];
        if constexpr (kWide) {  // n is a multiple of 4: both columns or neither
          if (gc < n) store_pair(crow + gc, x0, x1);
        } else {
          if (gc < n) crow[gc] = repro::from_f32<T>(x0);
          if (gc + 1 < n) crow[gc + 1] = repro::from_f32<T>(x1);
        }
      }
    }
  }
}

template <typename T, bool kWide>
cudaError_t launch(const void* a, const void* b, void* c, int m, int n, int k,
                   cudaStream_t s) {
  constexpr int kMinBlocks = std::is_same_v<T, float> ? 1 : 2;
  constexpr size_t bytes = Tile<T>::SMEM;  // above 48 KB: opt in
  auto kernel = matmul_tc_kernel<T, kWide, kMinBlocks>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  kernel<<<grid, kThreads, bytes, s>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                       static_cast<T*>(c), m, n, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* a, const void* b, void* c, int m, int n, int k,
                     cudaStream_t s) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool wide = aligned(a) && aligned(b) && aligned(c) && k % Tile<T>::VEC == 0 &&
                    n % Tile<T>::VEC == 0;
  return wide ? launch<T, true>(a, b, c, m, n, k, s) : launch<T, false>(a, b, c, m, n, k, s);
}

}  // namespace

// a (m, k), b (k, n), c (m, n), row-major and contiguous in dtype (f32 or
// bf16); any alignment of the bases (the narrow branch takes the rest)
extern "C" int repro_matmul(const void* a, const void* b, void* c, int m, int n, int k,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t e = dtype == repro::kBF16 ? dispatch<bf16>(a, b, c, m, n, k, s)
                                              : dispatch<float>(a, b, c, m, n, k, s);
  return static_cast<int>(e);
}

// bytes of dynamic shared memory a block of the kernel takes for dtype
extern "C" int repro_matmul_smem_bytes(int dtype) {
  return static_cast<int>(dtype == repro::kBF16 ? Tile<bf16>::SMEM : Tile<float>::SMEM);
}
