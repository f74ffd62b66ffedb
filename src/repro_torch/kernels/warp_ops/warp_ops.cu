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
// Layout: the (n, width) operand is flat, one thread per element, so a
// row of width <= 32 is a width-lane segment of one CUDA warp (the
// intrinsics' `width` argument, and ballot bits shifted to the segment).
// A row of width 64..1024 spans width/32 warps: a shuffle stages the row
// in shared memory, a vote combines the warps' ballots there.  Every lane
// of a warp takes part in each intrinsic: threads past the end of the
// tensor load a neutral value and store nothing.
//
// Bound on the H100: bytes.  One 4-byte read and one 4-byte write per
// element (votes: plus the optional member mask), against no arithmetic;
// each block is 256 threads (or one row, if wider) so loads coalesce.
#include <cstdint>

#include "common.cuh"

namespace {

enum ShflMode : int { kUp = 0, kDown = 1, kBfly = 2, kIdx = 3 };
enum VoteMode : int { kAll = 0, kAny = 1, kUni = 2, kBallot = 3 };

__global__ void shfl_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                            long long total, int width, int mode, int imm) {
  extern __shared__ uint32_t row_buf[];  // the block's rows, width > 32 only
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = i < total;
  const uint32_t v = live ? x[i] : 0u;
  const int lane = threadIdx.x & (width - 1);  // lane within the row
  uint32_t r;
  if (width <= 32) {
    switch (mode) {
      // the intrinsics read only the low 5 bits of a delta: a delta of the
      // whole width or more keeps every lane's own value, as on the TPU
      case kUp:   r = imm >= width ? v : __shfl_up_sync(repro::kFullMask, v, imm, width); break;
      case kDown: r = imm >= width ? v : __shfl_down_sync(repro::kFullMask, v, imm, width); break;
      case kBfly: r = __shfl_xor_sync(repro::kFullMask, v, imm, width); break;
      default:    r = __shfl_sync(repro::kFullMask, v, imm, width); break;  // imm < width
    }
  } else {
    row_buf[threadIdx.x] = v;
    __syncthreads();
    int src;
    switch (mode) {
      case kUp:   src = lane >= imm ? lane - imm : lane; break;
      case kDown: src = imm < width - lane ? lane + imm : lane; break;
      case kBfly: src = lane ^ imm; break;
      default:    src = imm; break;
    }
    r = row_buf[threadIdx.x - lane + src];
  }
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

int block_threads(int width) { return width > 256 ? width : 256; }

}  // namespace

extern "C" int repro_shfl(const void* x, void* y, long long n, int width, int mode,
                          int imm, void* stream) {
  const long long total = n * width;
  if (total > 0) {
    const int threads = block_threads(width);
    const long long blocks = (total + threads - 1) / threads;
    const size_t smem = width > 32 ? threads * sizeof(uint32_t) : 0;
    shfl_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y), total, width, mode, imm);
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
