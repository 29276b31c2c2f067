// Per-block selected-row compaction for Hopper (sm_90a).
//
// Counterpart of pallas_block_compact (frostdb_tpu/ops/pallas_agg.py, body
// _make_compact_kernel): the compiled_scan tier's selection-plane ->
// row-position step. For every 8192-row block b of a flat int32 0/1
// selection plane of n rows it writes
//   bc[b]               the number of selected rows in the block,
//   idx[b, 0:capb]      the block-local offsets of its first capb selected
//                       rows in ascending order, -1 past bc[b].
// The last block may be partial (n need not be a multiple of 8192): rows
// at and past n count as unselected.
//
// Bound on the card: memory. Each row is read once (4 B) and the output is
// n_blocks x (1 + capb) int32; the arithmetic is a ballot, a popcount and a
// scan step per 32 rows. The Pallas body computes its prefix sums with
// triangular matmuls and extracts row ids with a one-hot matmul, both
// shaped by the MXU; none of that carries over. Here one thread block of
// 256 threads owns one 8192-row block and each warp 1024 contiguous rows:
//   1. iteration `it` of a warp reads rows it*32 + lane (one coalesced
//      128-byte load per warp instruction, 32 loads in flight per thread)
//      and takes the ballot of `sel != 0`; lane `it` keeps that ballot, so
//      lane l holds the bitmask of the warp's rows 32*l .. 32*l + 31;
//   2. a warp inclusive scan of the per-lane popcounts (__shfl_up_sync) and
//      one pass over the 8 warp totals in shared memory give each lane the
//      rank of its first selected row within the block;
//   3. each lane writes the offsets of its set bits while their rank is
//      below capb, and the block fills the slots past its count with -1.
// Rows are owned in stream order, so ranks, and the offsets written, are
// ascending.
//
// The C entry returns cudaGetLastError() after its launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 8192;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = kBlockRows / kWarps;  // 1024
constexpr int kLaneRows = kWarpRows / 32;       // 32 rows per lane's bitmask

__global__ void __launch_bounds__(kThreads) block_compact_kernel(
    const int* __restrict__ sel, long long n, int capb, int* __restrict__ bc,
    int* __restrict__ idx) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long block_base = (long long)blockIdx.x * kBlockRows;
  const long long warp_base = block_base + (long long)warp * kWarpRows;
  const bool full = block_base + kBlockRows <= n;

  int vals[kLaneRows];
#pragma unroll
  for (int it = 0; it < kLaneRows; ++it) {
    const long long r = warp_base + it * 32 + lane;
    vals[it] = (full || r < n) ? __ldg(sel + r) : 0;
  }
  unsigned mask = 0u;
#pragma unroll
  for (int it = 0; it < kLaneRows; ++it) {
    const unsigned b = __ballot_sync(0xffffffffu, vals[it] != 0);
    if (lane == it) mask = b;
  }

  const int cnt = __popc(mask);
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int warp_prefix = 0;
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = s_warp[w];
    warp_prefix += (w < warp) ? t : 0;
    total += t;
  }
  if (threadIdx.x == 0) bc[blockIdx.x] = total;

  int* out = idx + (long long)blockIdx.x * capb;
  int rank = warp_prefix + incl - cnt;
  const int row0 = warp * kWarpRows + lane * kLaneRows;
  while (mask != 0u && rank < capb) {
    out[rank] = row0 + __ffs(mask) - 1;
    ++rank;
    mask &= mask - 1u;
  }
  for (int s = total + threadIdx.x; s < capb; s += kThreads) out[s] = -1;
}

}  // namespace

// bc: int32[ceil(n / 8192)], idx: int32[ceil(n / 8192), capb]; every slot of
// both is written by the launch.
extern "C" int fdb_block_compact(const void* sel, long long n, int capb,
                                 void* bc, void* idx, void* stream) {
  if (capb < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const long long n_blocks = (n + kBlockRows - 1) / kBlockRows;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  block_compact_kernel<<<(unsigned int)n_blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int*)sel, n, capb, (int*)bc, (int*)idx);
  return (int)cudaGetLastError();
}
