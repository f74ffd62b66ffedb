// The vx_shfl / vx_vote instruction family on Hopper: lane permutes and
// lane votes through the warp intrinsics themselves.
//
// Replaces: src/repro/kernels/warp_ops/warp_ops.py::shfl (shfl_kernel) and
// ::vote (vote_kernel), the Pallas kernels of the paper's HW path.  On the
// TPU a "warp" was a row of a VMEM block and a shuffle a cross-lane vector
// permute; on Hopper the HW path is literal: __shfl_{up,down,xor}_sync,
// __shfl_sync and __ballot_sync move register values between the 32 lanes
// of a warp with no memory round trip.
//
// Layout: the (n, width) operand is flat, one element a thread (a shuffle
// of width <= 32: kLaneElems elements a thread, a block's width apart), so
// a row of width <= 32 is a width-lane segment of one CUDA warp (the
// intrinsics' `width` argument, and ballot bits shifted to the segment).
// A row of width 64..1024 spans width/32 warps: a shuffle stages the row
// in shared memory, a vote combines the warps' ballots there.  Every lane
// of a warp takes part in each intrinsic: threads past the end of the
// tensor load a neutral value and store nothing.
//
// Bound on the H100: bytes.  One 4-byte read and one 4-byte write per
// element (votes: plus the optional member mask), against no arithmetic;
// each block is 256 threads (or one row, if wider) so loads coalesce.  At
// one 4-byte load a thread an SM has at most 8 KB in flight, about half
// what covers the card's memory latency at its full rate; the shuffle's
// lane path therefore gives each thread kLaneElems independent loads.
#include <cstdint>

#include "common.cuh"

namespace {

enum ShflMode : int { kUp = 0, kDown = 1, kBfly = 2, kIdx = 3 };
constexpr int kThreads = 256;   // a block (or one row, if wider)
// elements a thread of the lane path moves: 4 ran 1 % faster than 8 on an
// H100 at (2^20, 32) f32, and 1 (one element a thread) 32 % slower
constexpr int kLaneElems = 4;
enum VoteMode : int { kAll = 0, kAny = 1, kUni = 2, kBallot = 3 };

// width <= 32: a row is a width-lane segment of one warp.  Each thread
// moves kLaneElems elements, base + k * kThreads for k < kLaneElems, so a
// thread has that many independent loads in flight: all loads first, then
// one intrinsic per element, then the stores.  kThreads is a multiple of
// 32 and width divides 32, so an element's lane in its row is the thread's
// lane in its segment for every k.  I is the index type: 32-bit where the
// operand has fewer than 2^31 elements.
template <typename I>
__global__ void __launch_bounds__(kThreads)
shfl_lanes_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y, I total, int width,
                  int mode, int imm) {
  const I base = static_cast<I>(blockIdx.x) * (kThreads * kLaneElems) + threadIdx.x;
  uint32_t v[kLaneElems];
#pragma unroll
  for (int k = 0; k < kLaneElems; ++k) {
    const I i = base + static_cast<I>(k) * kThreads;
    v[k] = i < total ? x[i] : 0u;
  }
  // the intrinsics read only the low 5 bits of a delta: a delta of the
  // whole width or more keeps every lane's own value, as on the TPU
  switch (mode) {
    case kUp:
      if (imm < width) {
#pragma unroll
        for (int k = 0; k < kLaneElems; ++k)
          v[k] = __shfl_up_sync(repro::kFullMask, v[k], imm, width);
      }
      break;
    case kDown:
      if (imm < width) {
#pragma unroll
        for (int k = 0; k < kLaneElems; ++k)
          v[k] = __shfl_down_sync(repro::kFullMask, v[k], imm, width);
      }
      break;
    case kBfly:
#pragma unroll
      for (int k = 0; k < kLaneElems; ++k)
        v[k] = __shfl_xor_sync(repro::kFullMask, v[k], imm, width);
      break;
    default:  // imm < width
#pragma unroll
      for (int k = 0; k < kLaneElems; ++k)
        v[k] = __shfl_sync(repro::kFullMask, v[k], imm, width);
      break;
  }
#pragma unroll
  for (int k = 0; k < kLaneElems; ++k) {
    const I i = base + static_cast<I>(k) * kThreads;
    if (i < total) y[i] = v[k];
  }
}

// width 64..1024: a row spans width / 32 warps and is staged in shared
// memory, a block of max(kThreads, width) threads, one element each
__global__ void shfl_rows_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                                 long long total, int width, int mode, int imm) {
  extern __shared__ uint32_t row_buf[];  // the block's rows
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = i < total;
  const uint32_t v = live ? x[i] : 0u;
  const int lane = threadIdx.x & (width - 1);  // lane within the row
  row_buf[threadIdx.x] = v;
  __syncthreads();
  int src;
  switch (mode) {
    case kUp:   src = lane >= imm ? lane - imm : lane; break;
    case kDown: src = imm < width - lane ? lane + imm : lane; break;
    case kBfly: src = lane ^ imm; break;
    default:    src = imm; break;
  }
  const uint32_t r = row_buf[threadIdx.x - lane + src];
  if (live) y[i] = r;
}

__global__ void vote_kernel(const int* __restrict__ pred, const int* __restrict__ member,
                            int* __restrict__ out, long long total, int width, int mode) {
  __shared__ int row_first[32];     // each row's lane-0 value (width > 32)
  __shared__ int warp_hit[32];      // each warp's partial vote (width > 32)
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = i < total;
  const int p = live ? pred[i] : 0;
  const bool m = live && (member == nullptr || member[i] != 0);
  const int lane = threadIdx.x & (width - 1);
  if (width <= 32) {
    // this row's bits of a warp ballot
    const int shift = (threadIdx.x & 31) & ~(width - 1);
    const unsigned seg = width == 32 ? repro::kFullMask : (1u << width) - 1u;
    // every lane shuffles (outside any short-circuit): the row's lane 0
    const int first = __shfl_sync(repro::kFullMask, p, 0, width);
    bool cond;
    switch (mode) {
      case kAll: cond = m && p == 0; break;   // a member that vetoes
      case kUni: cond = m && p != first; break;
      default:   cond = m && p != 0; break;   // any, ballot
    }
    const unsigned bits = (__ballot_sync(repro::kFullMask, cond) >> shift) & seg;
    if (!live) return;
    if (mode == kBallot) {
      if (lane == 0) out[i / width] = static_cast<int>(bits);
    } else {
      out[i] = (mode == kAny) ? bits != 0 : bits == 0;
    }
    return;
  }
  // width > 32: the row spans width / 32 warps (ballot is refused here)
  const int row = threadIdx.x / width, warp = threadIdx.x / 32;
  if (mode == kUni && lane == 0) row_first[row] = p;
  __syncthreads();
  bool cond;
  switch (mode) {
    case kAll: cond = m && p == 0; break;
    case kUni: cond = m && p != row_first[row]; break;
    default:   cond = m && p != 0; break;
  }
  const unsigned bits = __ballot_sync(repro::kFullMask, cond);
  if ((threadIdx.x & 31) == 0) warp_hit[warp] = bits != 0;
  __syncthreads();
  const int warps_per_row = width / 32;
  bool hit = false;
  for (int w = row * warps_per_row; w < (row + 1) * warps_per_row; ++w) hit |= warp_hit[w];
  if (live) out[i] = (mode == kAny) ? hit : !hit;
}

int block_threads(int width) { return width > kThreads ? width : kThreads; }

}  // namespace

extern "C" int repro_shfl(const void* x, void* y, long long n, int width, int mode,
                          int imm, void* stream) {
  const long long total = n * width;
  const auto* src = static_cast<const uint32_t*>(x);
  auto* dst = static_cast<uint32_t*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0 && width <= 32) {
    const long long per = kThreads * kLaneElems;
    const unsigned blocks = static_cast<unsigned>((total + per - 1) / per);
    if (total + per < (1ll << 31))
      shfl_lanes_kernel<int><<<blocks, kThreads, 0, s>>>(src, dst, static_cast<int>(total), width,
                                                          mode, imm);
    else
      shfl_lanes_kernel<long long><<<blocks, kThreads, 0, s>>>(src, dst, total, width, mode, imm);
  } else if (total > 0) {
    const int threads = block_threads(width);
    const long long blocks = (total + threads - 1) / threads;
    shfl_rows_kernel<<<static_cast<unsigned>(blocks), threads, threads * sizeof(uint32_t), s>>>(
        src, dst, total, width, mode, imm);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_vote(const void* pred, const void* member, void* out, long long n,
                          int width, int mode, void* stream) {
  const long long total = n * width;
  if (total > 0) {
    const int threads = block_threads(width);
    const long long blocks = (total + threads - 1) / threads;
    vote_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(pred), static_cast<const int*>(member),
        static_cast<int*>(out), total, width, mode);
  }
  return static_cast<int>(cudaGetLastError());
}
