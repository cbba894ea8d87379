// Pruned nearest neighbour over Morton-sorted clouds: every tile of 256
// sorted queries scans only the T reference chunks (S sorted points each)
// that its row of a chunk-id table names, and keeps per query the least
// squared distance and the index, into the sorted reference cloud, that
// attains it.
//
// Replaces the TPU kernel
// active_3d_vision_and_touch_tpu/ops/chamfer_cluster.py _nn_kernel
// (pallas_call in _nn_clustered_sorted).  That kernel's transposed (8, S)
// chunk packing, its flat scalar-prefetch table and its 4-deep DMA ring
// answer the TPU compiler's constraints and are not carried over: this one
// reads the points from the plain sorted (yd, C*S, 3) tensor and the ids
// from a plain (B, n_tiles, T) int32 tensor.
//
// Bound on the H100: operations.  Each (query, ref) pair costs 3 sub, 3 mul,
// 2 add and 1 compare in FP32 on the CUDA cores; a tile's T*S refs are read
// once per block and mostly from L2, so the bytes are far below that.
//
// The function, which the plain PyTorch version beside the binding repeats
// exactly (tolerance 0 on distance and index):
// - The scan runs over the table entries j = 0..T-1 in TABLE order and over
//   each chunk's points in index order, with a strict '<'.  So inside a
//   chunk the first index wins a tie, and across chunks the one that stands
//   earlier in the table wins, whatever its chunk id.
// - The best starts at (1e30, index 0).
// - The distance is ((dx*dx + dy*dy) + dz*dz) with dx = x - y, each step
//   rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn forbid FMA
//   contraction), the plain version's order and rounding.
// - The reference row of batch row b is b % yd: the 3-repeat training loss
//   tiles the same yd ground-truth clouds, and only the distinct ones are
//   passed.
// - The index written is chunk_id * S + position.
//
// Design:
// - One block per (tile, batch row), 256 threads, one query per thread with
//   its (min, position in the scanned list) in registers.
// - The block stages the tile's chunks through shared memory in rounds of up
//   to 1024 points (1024 / S whole chunks), stored as float4 so each pair
//   costs one broadcast 16-byte shared load; a round is scanned as one flat
//   list, which is the table order.
// - A table id outside [0, C) names no chunk: its slots are filled with
//   +inf points, which never win, rather than read out of bounds.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQueries = 256;  // threads per block = queries per tile
constexpr int kRound = 1024;   // reference points staged per round

__global__ void __launch_bounds__(kQueries)
nn_cluster_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                  const int* __restrict__ ids, float* __restrict__ dist,
                  int* __restrict__ index, int np, int yd, int c, int t,
                  int s) {
  __shared__ float4 refs[kRound];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int n_tiles = np / kQueries;
  const int q = tile * kQueries + threadIdx.x;
  const float* xq = xs + ((size_t)b * np + q) * 3;
  const float* yrow = ys + (size_t)(b % yd) * c * s * 3;
  const int* tab = ids + ((size_t)b * n_tiles + tile) * t;

  const float qx = xq[0], qy = xq[1], qz = xq[2];
  float best = 1e30f;
  int best_pos = -1;  // position in the tile's scanned list, j * S + offset

  const int total = t * s;
  const int per_round = (kRound / s) * s;  // whole chunks only
  for (int base = 0; base < total; base += per_round) {
    const int count = min(per_round, total - base);
    __syncthreads();  // the previous round is no longer read
    for (int r = threadIdx.x; r < count; r += kQueries) {
      const int pos = base + r;
      const int cid = tab[pos / s];
      float4 p = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
      if (cid >= 0 && cid < c) {
        const float* src = yrow + ((size_t)cid * s + pos % s) * 3;
        p = make_float4(src[0], src[1], src[2], 0.f);
      }
      refs[r] = p;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < count; ++r) {
      const float4 p = refs[r];
      const float dx = __fsub_rn(qx, p.x);
      const float dy = __fsub_rn(qy, p.y);
      const float dz = __fsub_rn(qz, p.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < best) {
        best = d;
        best_pos = base + r;
      }
    }
  }
  int out = 0;
  if (best_pos >= 0) out = tab[best_pos / s] * s + best_pos % s;
  dist[(size_t)b * np + q] = best;
  index[(size_t)b * np + q] = out;
}

}  // namespace

// xs (B, Np, 3) f32 with Np a multiple of 256, ys (yd, C*S, 3) f32 with
// B a multiple of yd, ids (B, Np/256, T) int32 -> dist (B, Np) f32,
// index (B, Np) int32.  All contiguous on the device; 1 <= B <= 65535,
// 1 <= S <= 1024, T >= 1.
extern "C" int nn_cluster_launch(const float* xs, const float* ys,
                                 const int* ids, float* dist, int* index,
                                 int b, int np, int yd, int c, int t, int s,
                                 cudaStream_t stream) {
  if (b == 0 || np == 0) return 0;
  const dim3 grid(np / kQueries, b);
  nn_cluster_kernel<<<grid, kQueries, 0, stream>>>(xs, ys, ids, dist, index,
                                                   np, yd, c, t, s);
  return (int)cudaGetLastError();
}
