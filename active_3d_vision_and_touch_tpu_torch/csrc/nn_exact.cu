// Exact nearest neighbour: for every query x[b, q] the least squared
// distance to y[b, :] and the FIRST index that attains it.
//
// Replaces the TPU kernel active_3d_vision_and_touch_tpu/ops/chamfer.py
// _nn_kernel_for (pallas_call in _min_dists_pallas), which keeps a running
// (min, argmin) over (256-query x 512-ref) VMEM tiles.
//
// Bound on the H100: operations, and among them instruction issue.  Each
// (query, ref) pair needs 3 sub, 3 mul and 2 add in FP32 and one compare;
// the inputs are a few MB.  None of the eight fuses: the distance is
// ((dx*dx + dy*dy) + dz*dz) with dx = x - y, each step rounded on its own
// (__fsub_rn/__fmul_rn/__fadd_rn forbid FMA contraction), which is the
// plain PyTorch version's order and rounding, so kernel and plain version
// agree bit for bit and so do the indices: tolerance 0.  An SM sub-partition
// issues one warp instruction a clock, so every other instruction in the
// inner loop (a shared-memory load, a compare, a select, a branch) costs as
// much as one of the eight.  The design is about spending as few issue
// slots a pair as it can beyond those eight.
//
// Design:
// - kR = 8 queries a thread, their coordinates and running bests in
//   registers; a block of kThreads = 64 threads scans all refs for
//   kR * kThreads = 512 consecutive queries (query q0 + r * 64 + thread);
//   grid (ceil(N / 512), B).
// - The block streams y through shared memory in tiles of 1024 points held
//   as three planes x[], y[], z[].  Three broadcast 16-byte loads bring four
//   refs and serve 4 * kR = 32 pairs: 0.09 load slots a pair.
// - Grouped minimum, no branch: for each query the distances to a group of
//   kG = 8 consecutive refs are reduced with 7 fminf, and the group's minimum
//   is compared with the running best once (strict '<'); two selects keep
//   (best, first ref of the winning group).  Per pair that is 8 + 0.875
//   (fminf) + 0.375 (compare, two selects) + 0.09 (loads) = 9.34 slots and
//   the loop's own few (the built loop holds 9.42 instructions a pair, by
//   cuobjdump -sass), against 8 + 1 (load) + 3 (compare, two selects) with
//   one query a thread.  After the scan each query recomputes the at most 8
//   distances of its winning group from device memory, the same arithmetic
//   on the same inputs and so the same bits, and takes the first ref whose
//   distance equals the least one.
// - First index wins, everywhere: a later group or tile with an equal
//   minimum is not '<', inside the winning group the lowest equal ref is
//   taken, and the refs are never split across blocks.
// - A branching alternative (keep a group's distances in registers and, when
//   some group minimum of the thread is below its best, branch to a rescan of
//   the group in index order) issues fewer instructions where nothing
//   improves, but a warp takes the rescan whenever one of its 32 * kR queries
//   improves.  That is rare for refs in random order and frequent for refs in
//   face order (the sampled cloud as refs), where it measured slower than
//   these selects, which cost the same in any order; it was taken out.
// - Ragged edges: the last group of the last tile is padded in shared
//   memory with points at +infinity, whose distance +inf is never '<';
//   queries past N compute on zeros and store nothing.
// - Full waves, by tile size and not by a persistent grid: blocks are small
//   (2 warps, 8 resident an SM at <= 128 registers a thread) and many, and
//   the hardware hands a block to whichever SM frees a slot, so what counts
//   is work items per SM.  (48, 30000): 59 x 48 = 2832 blocks on 132 SMs,
//   21.45 an SM, the busiest SM takes 22: a tail of 2.5%; 0.7% of the lanes
//   idle, in each row's last block.  (192, 4000): 8 x 192 = 1536 blocks,
//   11.64 an SM, the busiest 12: 3.1%; 2.3% of the lanes idle whatever the
//   tile (4000 queries are 15.6 warps of 256).  An SM that holds fewer than
//   8 blocks near the end still issues from every sub-partition, since each
//   warp carries 32 independent chains.
// - Staging is the plain two-barrier load: with 8 blocks an SM the other
//   blocks' scans cover one block's load.  A double-buffered cp.async
//   version measured no faster and was taken out again.
//
// What of Hopper does not apply: wgmma and the tensor cores have nothing to
// multiply at depth 3 when the result must be exact float32; the
// |x|^2 + |y|^2 - 2 x.y form in TF32 or bf16 moves the indices (the TPU
// kernel's own note says the same of its matrix unit).  TMA would fetch a
// 12 KB tile that the other resident blocks already hide.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kR = 8;          // queries a thread
constexpr int kG = 8;          // refs a group: one compare of the running best a group
constexpr int kThreads = 64;
constexpr int kMinBlocks = 8;  // resident blocks an SM: at most 128 registers a thread
constexpr int kQueries = kR * kThreads;  // queries a block
constexpr int kTile = 1024;              // reference points per shared-memory tile
static_assert(kG % 4 == 0 && kTile % kG == 0, "a tile is whole groups, a group whole float4s");

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
nn_exact_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ dist, int* __restrict__ index,
                int n, int m) {
  __shared__ __align__(16) float tile[3][kTile];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQueries + threadIdx.x;
  const float* xb = x + (size_t)b * n * 3;
  const float* yb = y + (size_t)b * m * 3;

  // best_i: the first ref of the winning group, until the scan is over
  float qx[kR], qy[kR], qz[kR], best[kR];
  int best_i[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int q = q0 + r * kThreads;
    qx[r] = qy[r] = qz[r] = 0.f;
    if (q < n) {
      qx[r] = xb[3 * (size_t)q];
      qy[r] = xb[3 * (size_t)q + 1];
      qz[r] = xb[3 * (size_t)q + 2];
    }
    best[r] = INFINITY;
    best_i[r] = 0;
  }

  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    // the refs [base, base + count), the last group padded with +infinity
    for (int t = threadIdx.x; t < ((count + kG - 1) & ~(kG - 1)); t += kThreads) {
      if (t < count) {
        const float* p = yb + 3 * (size_t)(base + t);
        tile[0][t] = p[0];
        tile[1][t] = p[1];
        tile[2][t] = p[2];
      } else {
        tile[0][t] = tile[1][t] = tile[2][t] = INFINITY;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < count; j += kG) {
      float group_min[kR];
#pragma unroll
      for (int h = 0; h < kG; h += 4) {
        const float4 rx = *reinterpret_cast<const float4*>(&tile[0][j + h]);
        const float4 ry = *reinterpret_cast<const float4*>(&tile[1][j + h]);
        const float4 rz = *reinterpret_cast<const float4*>(&tile[2][j + h]);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float four = fminf(
              fminf(sq_dist(qx[r], qy[r], qz[r], rx.x, ry.x, rz.x),
                    sq_dist(qx[r], qy[r], qz[r], rx.y, ry.y, rz.y)),
              fminf(sq_dist(qx[r], qy[r], qz[r], rx.z, ry.z, rz.z),
                    sq_dist(qx[r], qy[r], qz[r], rx.w, ry.w, rz.w)));
          group_min[r] = h == 0 ? four : fminf(group_min[r], four);
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (group_min[r] < best[r]) {  // two selects, no branch
          best[r] = group_min[r];
          best_i[r] = base + j;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int q = q0 + r * kThreads;
    if (q >= n) continue;
    // the first ref of the winning group that attains the least distance:
    // the same arithmetic on the same inputs gives the same bits
    const int first = best_i[r];
    for (int g = min(kG, m - first) - 1; g >= 0; --g) {
      const float* p = yb + 3 * (size_t)(first + g);
      if (sq_dist(qx[r], qy[r], qz[r], p[0], p[1], p[2]) == best[r]) best_i[r] = first + g;
    }
    dist[(size_t)b * n + q] = best[r];
    index[(size_t)b * n + q] = best_i[r];
  }
}

}  // namespace

// x (B, N, 3) f32, y (B, M, 3) f32 -> dist (B, N) f32, index (B, N) int32.
// All contiguous on the device; 1 <= B <= 65535, M >= 1.
extern "C" int nn_exact_launch(const float* x, const float* y, float* dist,
                               int* index, int b, int n, int m,
                               cudaStream_t stream) {
  if (b == 0 || n == 0) return 0;
  const dim3 grid((n + kQueries - 1) / kQueries, b);
  nn_exact_kernel<<<grid, kThreads, 0, stream>>>(x, y, dist, index, n, m);
  return (int)cudaGetLastError();
}
