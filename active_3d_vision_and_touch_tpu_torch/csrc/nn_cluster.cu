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
// Bound on the H100: operations, and among them instruction issue.  Each
// (query, listed ref) pair costs 3 sub, 3 mul, 2 add and 1 compare in FP32
// on the CUDA cores, none of which fuses (see below); a tile's T*S refs are
// read once per block and mostly from L2, so the bytes are far below that.
// As in csrc/nn_exact.cu, an SM sub-partition issues one warp instruction a
// clock, so the design is about spending few issue slots a pair beyond the
// eight of the distance.
//
// The function, which the plain PyTorch version beside the binding repeats
// exactly (tolerance 0 on distance and index):
// - A tile's list is its T table entries in TABLE order, each chunk's S
//   points in index order: list position p names point p % S of chunk
//   table[p / S].  The first list position of the least distance wins.  So
//   inside a chunk the first index wins a tie, and across chunks the one
//   that stands earlier in the table wins, whatever its chunk id.
// - The best starts at (1e30, index 0): a ref must be nearer than 1e30.
// - The distance is ((dx*dx + dy*dy) + dz*dz) with dx = x - y, each step
//   rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn forbid FMA
//   contraction), the plain version's order and rounding.
// - The reference row of batch row b is b % yd: the 3-repeat training loss
//   tiles the same yd ground-truth clouds, and only the distinct ones are
//   passed.
// - The index written is chunk_id * S + position in the chunk.
//
// Design: the scan of csrc/nn_exact.cu, on a list that the table names.
// - One block of one warp per (tile, batch row); a thread carries kR = 8
//   queries (query lane + 32 r of the tile) with their coordinates and
//   running bests in registers.  The tile is fixed at 256 queries by the
//   table, so the block is small and many are resident (up to 16 an SM at
//   <= 128 registers a thread): another block's scan covers this one's
//   staging, and a one-warp block needs no block-wide barrier to be cheap.
// - The list is staged through shared memory in rounds of kRound = 1024
//   positions, as three planes x[], y[], z[].  Three broadcast 16-byte loads
//   bring four refs and serve 4 * kR = 32 pairs.
// - Grouped minimum, no data-dependent branch: the distances of one query to
//   a group of kG = 8 consecutive list positions are reduced with 7 fminf;
//   the group's minimum is compared with the running best once (strict '<')
//   and two selects keep (best, first position of the winning group).  After
//   the scan each query recomputes the at most 8 distances of its winning
//   group from device memory (through the table: the same arithmetic on the
//   same inputs, so the same bits) and takes the first position that
//   attains the least distance.  A later group with an equal minimum is not
//   '<', so the first position of the whole list wins.
// - Staging: when S is a multiple of 4 and the refs are 16-byte aligned, four
//   consecutive list positions are 48 contiguous aligned bytes of one chunk:
//   a thread fetches them with three 16-byte loads and writes one float4 to
//   each plane (the transposition), with one table lookup and one division
//   for the four.  Any other S takes the same kernel with one point a
//   thread and scalar loads.  The table row is read once into shared memory.
// - Ragged edges: a round is kRound positions whatever S is, so a group may
//   straddle two chunks; the last group of the list is padded in shared
//   memory with points at +infinity, whose distance +inf is never '<'; a
//   table id outside [0, C) names no chunk and its S slots are +infinity
//   points too, rather than a read out of bounds.
// - Measured against this shape on an H100 (80GB HBM3, 700 W) at (48, 30208)
//   queries, T 24, S 128, each variant bit-equal to this one, and taken out
//   again: a block of 2 or 4 warps that share every staged round, each warp
//   scanning its share of the round for all 256 queries, with the per-warp
//   (best, position) merged by (distance, position) at the end, was 1-2%
//   slower (5664 one-warp blocks already fill 132 SMs, and the shared rounds
//   cost block-wide barriers); kR = 4 with two warps a tile 8% slower; rounds
//   of 2048 positions 9% slower, of 512 the same within 1%; 8 or 12 resident
//   blocks an SM (more registers a thread) the same within 1%.
//
// What of Hopper does not apply: as for the exact kernel, the tensor cores
// have nothing to multiply at depth 3 in exact float32.  A cp.async.bulk per
// chunk would land the points interleaved (x, y, z) in shared memory and a
// second pass would still have to transpose them into the planes; the
// staging is under 1% of the block's instructions as it is.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;  // queries per tile: the table's granularity
constexpr int kR = 8;       // queries a thread
constexpr int kG = 8;       // list positions a group: one compare of the running best a group
constexpr int kThreads = kTile / kR;  // one warp
constexpr int kMinBlocks = 16;        // resident blocks an SM: at most 128 registers a thread
constexpr int kRound = 1024;          // list positions staged per round
static_assert(kG % 4 == 0 && kRound % kG == 0, "a round is whole groups, a group whole float4s");

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// kVec: S % 4 == 0 and ys 16-byte aligned, so four consecutive list
// positions are three aligned float4 of one chunk
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
nn_cluster_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                  const int* __restrict__ ids, float* __restrict__ dist,
                  int* __restrict__ index, int np, int yd, int c, int t,
                  int s) {
  __shared__ __align__(16) float plane[3][kRound];
  extern __shared__ int tab[];  // the tile's T chunk ids
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int n_tiles = np / kTile;
  const size_t q0 = (size_t)b * np + (size_t)tile * kTile + threadIdx.x;
  const float* yrow = ys + (size_t)(b % yd) * c * s * 3;
  const int* row = ids + ((size_t)b * n_tiles + tile) * t;
  for (int j = threadIdx.x; j < t; j += kThreads) tab[j] = row[j];

  // best_at: the first list position of the winning group, -1 for none yet
  float qx[kR], qy[kR], qz[kR], best[kR];
  int best_at[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float* p = xs + 3 * (q0 + r * kThreads);
    qx[r] = p[0];
    qy[r] = p[1];
    qz[r] = p[2];
    best[r] = 1e30f;
    best_at[r] = -1;
  }

  const int total = t * s;
  for (int base = 0; base < total; base += kRound) {
    const int count = min(kRound, total - base);
    const int padded = (count + kG - 1) & ~(kG - 1);
    __syncthreads();  // the table is written; the previous round is no longer read
    if constexpr (kVec) {
      for (int quad = threadIdx.x; quad < padded / 4; quad += kThreads) {
        const int pos = base + 4 * quad;
        float4 px = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
        float4 py = px, pz = px;
        if (pos < total) {
          const int j = pos / s;
          const int cid = tab[j];
          if ((unsigned)cid < (unsigned)c) {
            const float4* src = reinterpret_cast<const float4*>(
                yrow + ((size_t)cid * s + (pos - j * s)) * 3);
            const float4 u = src[0], v = src[1], w = src[2];  // x0 y0 z0 x1 | y1 z1 x2 y2 | z2 x3 y3 z3
            px = make_float4(u.x, u.w, v.z, w.y);
            py = make_float4(u.y, v.x, v.w, w.z);
            pz = make_float4(u.z, v.y, w.x, w.w);
          }
        }
        *reinterpret_cast<float4*>(&plane[0][4 * quad]) = px;
        *reinterpret_cast<float4*>(&plane[1][4 * quad]) = py;
        *reinterpret_cast<float4*>(&plane[2][4 * quad]) = pz;
      }
    } else {
      for (int e = threadIdx.x; e < padded; e += kThreads) {
        const int pos = base + e;
        float x = INFINITY, y = INFINITY, z = INFINITY;
        if (pos < total) {
          const int j = pos / s;
          const int cid = tab[j];
          if ((unsigned)cid < (unsigned)c) {
            const float* src = yrow + ((size_t)cid * s + (pos - j * s)) * 3;
            x = src[0];
            y = src[1];
            z = src[2];
          }
        }
        plane[0][e] = x;
        plane[1][e] = y;
        plane[2][e] = z;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < count; j += kG) {
      float group_min[kR];
#pragma unroll
      for (int h = 0; h < kG; h += 4) {
        const float4 rx = *reinterpret_cast<const float4*>(&plane[0][j + h]);
        const float4 ry = *reinterpret_cast<const float4*>(&plane[1][j + h]);
        const float4 rz = *reinterpret_cast<const float4*>(&plane[2][j + h]);
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
          best_at[r] = base + j;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    // the first position of the winning group that attains the least
    // distance: the same arithmetic on the same inputs gives the same bits
    int out = 0;
    if (best_at[r] >= 0) {
      for (int g = min(kG, total - best_at[r]) - 1; g >= 0; --g) {
        const int pos = best_at[r] + g;
        const int j = pos / s;
        const int cid = tab[j];
        if ((unsigned)cid >= (unsigned)c) continue;
        const int at = cid * s + (pos - j * s);
        const float* p = yrow + 3 * (size_t)at;
        if (sq_dist(qx[r], qy[r], qz[r], p[0], p[1], p[2]) == best[r]) out = at;
      }
    }
    dist[q0 + r * kThreads] = best[r];
    index[q0 + r * kThreads] = out;
  }
}

}  // namespace

// xs (B, Np, 3) f32 with Np a multiple of 256, ys (yd, C*S, 3) f32 with
// B a multiple of yd, ids (B, Np/256, T) int32 -> dist (B, Np) f32,
// index (B, Np) int32.  All contiguous on the device; 1 <= B <= 65535,
// S >= 1, 1 <= T <= 8192 (the table row lies in shared memory), T*S < 2^31.
extern "C" int nn_cluster_launch(const float* xs, const float* ys,
                                 const int* ids, float* dist, int* index,
                                 int b, int np, int yd, int c, int t, int s,
                                 cudaStream_t stream) {
  if (b == 0 || np == 0) return 0;
  const dim3 grid(np / kTile, b);
  const size_t table_bytes = (size_t)t * sizeof(int);
  if (s % 4 == 0 && (uintptr_t)ys % 16 == 0) {
    nn_cluster_kernel<true><<<grid, kThreads, table_bytes, stream>>>(
        xs, ys, ids, dist, index, np, yd, c, t, s);
  } else {
    nn_cluster_kernel<false><<<grid, kThreads, table_bytes, stream>>>(
        xs, ys, ids, dist, index, np, yd, c, t, s);
  }
  return (int)cudaGetLastError();
}
