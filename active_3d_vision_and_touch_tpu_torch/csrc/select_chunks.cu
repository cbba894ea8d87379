// The chunk table of the pruned nearest-neighbour search: for every tile of
// 256 Morton-sorted queries the ids of the T reference chunks it scans.
//
// Replaces no TPU kernel.  The JAX package computes this selection with XLA
// ops under lax.map, one tile at a time, fused by the compiler
// (active_3d_vision_and_touch_tpu/ops/chamfer_cluster.py, tile_select in
// _nn_clustered_sorted); as separate PyTorch ops the same selection is some
// 430 small launches a train step and costs several times the scans it
// feeds.  This kernel does one (row, tile) per block in one launch.
//
// The function, which select_chunks_plain beside the binding computes with
// torch ops (index for index, tolerance 0).  The lower bound of the distance
// from a point p to any point of chunk k, with centre c_k and radius r_k, is
//   bound(p, k) = sqrt(((dx*dx + dy*dy) + dz*dz)) - r_k,   d = p - c_k,
// each step rounded on its own (no FMA contraction, IEEE square root and
// division), as one torch op after another rounds it.
// 1. If K = min(3 T, C) < C, the candidates: the bound of each of the C chunks
//    to the 8 anchor queries (0, 32, ..., 224 of the tile), the minimum over
//    the anchors (a NaN stays a NaN), and the K least in ascending order, a
//    NaN last, the lower chunk id first among equals.  Otherwise every chunk
//    is a candidate, in id order.
// 2. The votes: every query takes the bound to each candidate and votes for
//    min(3, K) of them, by passes of "first position of the least bound, then
//    set that bound to +inf"; a NaN counts as least.
// 3. score = votes + 1 / (1 + max(bound(tile centroid), 0)), and the T highest
//    in descending order, a NaN first, the lower candidate position first
//    among equals, mapped back through the candidate list to chunk ids.
// The chunk centres and radii and the tile centroids are inputs: they are
// reductions whose order is the library's, and both versions start from the
// same ones.
//
// Bound on the H100: operations (instruction issue).  A block evaluates
// 8 C + 257 K bounds of about 20 instructions each (eight of arithmetic, an
// IEEE square root, the ordering key) and two rankings by counting, C*C and
// K*K integer compares; the bytes are the tile's 3 KB of queries, the row's
// 16 C bytes of centres and radii (from L2 after the row's first tile) and
// 4 T bytes of output.
//
// Design:
// - One block of 256 threads per (tile, batch row): thread q is query q of
//   the tile in stage 2, and the stages 1 and 3 stride the chunks and the
//   candidates over the threads.
// - Order without a sort: every bound is turned into an unsigned key that
//   orders as the float does, with every NaN on one agreed side, and the
//   rank of an element is the count of (key, position) pairs before it.  The
//   keys lie in shared memory and every thread reads them all (broadcast
//   loads): 236 * 236 compares a block at the train step's shape, a fraction
//   of the votes' work, and the ranks are a permutation whatever the ties.
// - The three vote passes are one pass: a query keeps its three least (key,
//   position) pairs in registers, inserting with strict '<' while the
//   positions ascend, which is what three passes of first-index argmin and
//   mask find.  One case needs care: once the least bound left is +inf,
//   every bound, masked or not, is +inf, and a pass takes position 0,
//   possibly a second time.  The three pairs start at (+inf, position 0) and
//   a bound of +inf is never '<', so that is what they hold then.
// - Votes are counted with shared-memory integer atomics: exact and free of
//   any order.  The plain version's float32 votes hold the same integers.
// - A query with a non-finite coordinate has NaN or +inf bounds; keys order
//   them like any other value, so no loop depends on the data and no id
//   outside [0, C) can be written.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;    // queries per tile = threads per block
constexpr int kAnchors = 8;   // queries 0, 32, ..., 224 rank all chunks
constexpr uint32_t kNanKey = 0xffffffffu;
constexpr uint32_t kInfKey = 0xff800000u;  // key of +inf

__device__ __forceinline__ float bound(float px, float py, float pz, float4 chunk) {
  const float dx = __fsub_rn(px, chunk.x);
  const float dy = __fsub_rn(py, chunk.y);
  const float dz = __fsub_rn(pz, chunk.z);
  const float sq =
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  return __fsub_rn(__fsqrt_rn(sq), chunk.w);
}

// Unsigned key in the order of the floats, -inf lowest, +inf highest and
// every NaN above that.
__device__ __forceinline__ uint32_t key_nan_last(float v) {
  if (v != v) return kNanKey;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The same with every NaN below -inf (whose key is 0x007fffff).
__device__ __forceinline__ uint32_t key_nan_first(float v) {
  const uint32_t k = key_nan_last(v);
  return k == kNanKey ? 0u : k;
}

__device__ __forceinline__ float4 chunk_of(const float* centres, const float* radii, int k) {
  return make_float4(centres[3 * k], centres[3 * k + 1], centres[3 * k + 2], radii[k]);
}

__global__ void __launch_bounds__(kTile)
select_chunks_kernel(const float* __restrict__ xs, const float* __restrict__ centres,
                     const float* __restrict__ radii, const float* __restrict__ tile_c,
                     int* __restrict__ out, int np, int yd, int c, int t, int k) {
  // dynamic shared memory: K float4 | max(C, K) keys | K candidate ids | K votes
  extern __shared__ __align__(16) unsigned char smem[];
  float4* cand4 = reinterpret_cast<float4*>(smem);
  uint32_t* keys = reinterpret_cast<uint32_t*>(cand4 + k);
  int* cand = reinterpret_cast<int*>(keys + max(c, k));
  int* votes = cand + k;
  __shared__ float anchor[kAnchors][3];

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int n_tiles = np / kTile;
  const float* xq = xs + ((size_t)b * np + (size_t)tile * kTile + tid) * 3;
  const float qx = xq[0], qy = xq[1], qz = xq[2];
  const float* crow = centres + (size_t)(b % yd) * c * 3;
  const float* rrow = radii + (size_t)(b % yd) * c;

  // 1. the candidates
  if (k < c) {
    if (tid % (kTile / kAnchors) == 0) {
      anchor[tid / (kTile / kAnchors)][0] = qx;
      anchor[tid / (kTile / kAnchors)][1] = qy;
      anchor[tid / (kTile / kAnchors)][2] = qz;
    }
    __syncthreads();
    for (int j = tid; j < c; j += kTile) {
      const float4 chunk = chunk_of(crow, rrow, j);
      float least = bound(anchor[0][0], anchor[0][1], anchor[0][2], chunk);
#pragma unroll
      for (int a = 1; a < kAnchors; ++a) {
        const float v = bound(anchor[a][0], anchor[a][1], anchor[a][2], chunk);
        least = (v < least || v != v) ? v : least;  // a NaN stays
      }
      keys[j] = key_nan_last(least);
    }
    __syncthreads();
    for (int j = tid; j < c; j += kTile) {
      const uint32_t mine = keys[j];
      int rank = 0;
      for (int i = 0; i < c; ++i) {
        const uint32_t other = keys[i];
        rank += (other < mine) || (other == mine && i < j);
      }
      if (rank < k) cand[rank] = j;
    }
    __syncthreads();
  } else {
    for (int j = tid; j < k; j += kTile) cand[j] = j;
    __syncthreads();
  }
  for (int j = tid; j < k; j += kTile) {
    cand4[j] = chunk_of(crow, rrow, cand[j]);
    votes[j] = 0;
  }
  __syncthreads();

  // 2. the votes: the three least (key, position) of this query's bounds
  uint32_t k0 = kInfKey, k1 = kInfKey, k2 = kInfKey;
  int p0 = 0, p1 = 0, p2 = 0;
  for (int j = 0; j < k; ++j) {
    const uint32_t key = key_nan_first(bound(qx, qy, qz, cand4[j]));
    if (key < k2) {
      const bool lt1 = key < k1, lt0 = key < k0;
      k2 = lt1 ? k1 : key;
      p2 = lt1 ? p1 : j;
      k1 = lt0 ? k0 : (lt1 ? key : k1);
      p1 = lt0 ? p0 : (lt1 ? j : p1);
      k0 = lt0 ? key : k0;
      p0 = lt0 ? j : p0;
    }
  }
  // a pass whose least bound is +inf has found every bound +inf and takes
  // position 0: the pair it was started with
  atomicAdd(&votes[p0], 1);
  if (k > 1) atomicAdd(&votes[p1], 1);
  if (k > 2) atomicAdd(&votes[p2], 1);
  __syncthreads();

  // 3. the scores and the T highest
  const float* centroid = tile_c + ((size_t)b * n_tiles + tile) * 3;
  const float mx = centroid[0], my = centroid[1], mz = centroid[2];
  for (int j = tid; j < k; j += kTile) {
    float tb = bound(mx, my, mz, cand4[j]);
    tb = tb < 0.f ? 0.f : tb;  // a NaN stays
    const float score =
        __fadd_rn((float)votes[j], __fdiv_rn(1.f, __fadd_rn(1.f, tb)));
    keys[j] = key_nan_last(score);
  }
  __syncthreads();
  int* dst = out + ((size_t)b * n_tiles + tile) * t;
  for (int j = tid; j < k; j += kTile) {
    const uint32_t mine = keys[j];
    int rank = 0;
    for (int i = 0; i < k; ++i) {
      const uint32_t other = keys[i];
      rank += (other > mine) || (other == mine && i < j);
    }
    if (rank < t) dst[rank] = cand[j];
  }
}

}  // namespace

// xs (B, Np, 3) f32 with Np a multiple of 256, centres (yd, C, 3) f32, radii
// (yd, C) f32 with B a multiple of yd, tile_c (B, Np/256, 3) f32 -> out
// (B, Np/256, T) int32.  All contiguous on the device; 1 <= B <= 65535,
// 1 <= T <= K <= C, and 4 max(C, K) + 24 K bytes of shared memory must fit
// a block (the caller checks it).
extern "C" int select_chunks_launch(const float* xs, const float* centres,
                                    const float* radii, const float* tile_c,
                                    int* out, int b, int np, int yd, int c,
                                    int t, int k, cudaStream_t stream) {
  if (b == 0 || np == 0) return 0;
  const size_t bytes = (size_t)k * (sizeof(float4) + 2 * sizeof(int)) +
                       (size_t)(c > k ? c : k) * sizeof(uint32_t);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_chunks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(np / kTile, b);
  select_chunks_kernel<<<grid, kTile, bytes, stream>>>(xs, centres, radii, tile_c, out,
                                                       np, yd, c, t, k);
  return (int)cudaGetLastError();
}
