// Sorted-stream segment sum: out[b, s, :] = sum of vals[b, i, :] over the
// entries i whose id idx[b, i] == s, for ids sorted ascending per row.  Ids
// outside [0, S), negative ones too, match no segment and are dropped; a
// segment with no entry reads 0.
//
// Replaces the TPU kernel active_3d_vision_and_touch_tpu/ops/segsum.py
// _kernel (pallas_call in segment_accumulate_sorted), which DMAs each
// output tile's window of the sorted stream and reduces it with one-hot
// compares, because the TPU has no atomics.
//
// Bound on the H100: bytes.  A launch must read the ids (4 B) and values
// (12 B) of every entry once and write 12 B per segment: about 40 MB at the
// train step's (48, 30000) -> (48, 30000, 3), some 12 us at 3.35 TB/s.
// There is one add per value, so the design is about moving each byte once,
// coalesced, with enough loads in flight.
//
// Design: parallel over entries, not over segments.
// - A block owns one slab of kSlab consecutive entries of one row; grid
//   (ceil(M / kSlab), B).  It loads the slab's ids and values into shared
//   memory with coalesced 16-byte loads (4 records are 3 float4).  A row's
//   base is 16-byte aligned only when M % 4 == 0; otherwise the same kernel
//   is instantiated with 4-byte loads, which coalesce as well.
// - Run starts come from head flags, idx[i] != idx[i-1], read from shared
//   memory; the first entry of a slab compares with the last id of the
//   slab before it (one extra load), the last with the first id of the slab
//   after it.  Nothing is searched.
// - Ownership without atomics: a run belongs to the block in whose slab it
//   starts.  Entries at the front of a slab that continue an earlier run
//   are skipped; a run that crosses the slab's end is finished by its owner
//   reading on into the following slabs from device memory.  Every output
//   element gets its value from one thread, in an order fixed by the
//   layout, so the result is the same bit for bit from run to run.
// - Short runs: a run of at most kShort = 8 entries that ends inside the
//   slab is summed by the thread that holds its head, left to right with
//   __fadd_rn, straight from shared memory.  At the train step's streams
//   the mean run is one entry long.
// - Long runs: a run of more than kShort entries, or one that crosses the
//   slab's end, goes on a list in shared memory and is summed by one whole
//   warp.  Lane l adds the entries at run start + l, + l + 32, + l + 64, ...
//   in ascending order; then the 32 partial sums are combined by a fixed
//   shuffle tree (lane l += lane l + 16, then + 8, 4, 2, 1).  That order is
//   not left to right, and it is the same in every run.  A round loads the
//   ids and values of kStrides = 8 strides (256 entries) before it adds any,
//   from addresses clamped into the row, so that no load waits for a
//   compare: with the loads behind the compares a round took about 3 us and
//   the train step's longest run (1023 entries) as long as the rest of the
//   kernel.  Against index_add_ on the card, which adds with atomics in no
//   fixed order, the tolerance is 1e-5 * (1 + sum of |vals| in the segment).
//   A run of many thousands of entries is still one warp's work (a row that
//   is one id throughout: 30000 entries, 118 rounds).
// - Empty segments: `out` arrives uninitialised.  Each block zero-fills the
//   segments after the last id of the slab before it, up to and including
//   the last id of its own slab (the row's first block from segment 0, its
//   last block to S - 1), with coalesced stores, before it writes its sums.
//   These ranges partition [0, S), so a gap of any length is filled by a
//   whole block, and no separate pass is launched.  The zeros are 12 B per
//   segment on top of the bound's bytes; a filled segment is written a
//   second time by its owner while the line is still in L2.  The
//   alternative, one cudaMemsetAsync of `out` before the kernel, writes the
//   same bytes in a pass of its own and measured slower at every main-path
//   shape (on an H100 80GB HBM3 at 700 W, as every measurement named here).
// - kSlab = 1024 and kShort = 8 measured fastest on the train steps'
//   streams among slabs of 512 to 2816 and thresholds of 4 to 32: four
//   entries a thread keep the dependent shared-memory loads of the head loop
//   short, and 1440 blocks at (48, 30000) fill the 132 SMs more evenly than
//   720.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 1024;  // entries of one row per block
constexpr int kShort = 8;    // longest run summed by one thread
constexpr int kStrides = 8;  // warp strides of a long run loaded at a time
// runs longer than kShort that start in one slab, plus the crossing one
constexpr int kMaxLong = kSlab / (kShort + 1) + 2;
static_assert(kSlab % 4 == 0 && kSlab >= kThreads, "slab: a multiple of 4, >= the block");
static_assert(kShort >= 1, "a thread sums at least a run of one");

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
segsum_sorted_kernel(const int* __restrict__ idx, const float* __restrict__ vals,
                     float* __restrict__ out, int m, int s) {
  __shared__ __align__(16) int sid[kSlab + 4];  // sid[count]: the next slab's first id
  __shared__ __align__(16) float sval[3 * kSlab];
  __shared__ int long_at[kMaxLong];
  __shared__ int n_long;

  const int t = threadIdx.x;
  const int base = blockIdx.x * kSlab;
  const int count = max(0, min(kSlab, m - base));  // 0 only for an empty row
  const int* row = idx + (size_t)blockIdx.y * m;
  const float* v = vals + (size_t)blockIdx.y * m * 3;
  float* o = out + (size_t)blockIdx.y * s * 3;

  if constexpr (kVec) {  // m % 4 == 0: the slab starts on 16 bytes and count % 4 == 0
    const int4* src = reinterpret_cast<const int4*>(row + base);
    for (int q = t; q < count / 4; q += kThreads) reinterpret_cast<int4*>(sid)[q] = src[q];
    const float4* vsrc = reinterpret_cast<const float4*>(v + 3 * (size_t)base);
    for (int q = t; q < 3 * (count / 4); q += kThreads)
      reinterpret_cast<float4*>(sval)[q] = vsrc[q];
  } else {
    for (int q = t; q < count; q += kThreads) sid[q] = row[base + q];
    const float* vsrc = v + 3 * (size_t)base;
    for (int q = t; q < 3 * count; q += kThreads) sval[q] = vsrc[q];
  }
  // the ids around the slab; -1 equals no id that is in range
  const int prev = base > 0 ? row[base - 1] : -1;
  if (t == 0) {
    sid[count] = base + count < m ? row[base + count] : -1;
    n_long = 0;
  }

  {
    // zero the segments (lo, hi]: after the last id before the slab, up to
    // the slab's own last id, both clamped into [-1, S - 1]
    const int last = count > 0 ? row[base + count - 1] : prev;
    const int lo = min(max(prev, -1), s - 1);
    const int hi = blockIdx.x == gridDim.x - 1 ? s - 1 : min(max(last, -1), s - 1);
    for (size_t q = 3 * (size_t)(lo + 1) + t; q < 3 * (size_t)(hi + 1); q += kThreads) o[q] = 0.f;
  }
  __syncthreads();  // the slab is staged, and the zeros are ordered before the sums

  for (int e = t; e < count; e += kThreads) {
    const int id = sid[e];
    const int before = e > 0 ? sid[e - 1] : prev;
    if (id == before || (unsigned)id >= (unsigned)s) continue;  // no head, or dropped
    const int lim = min(e + kShort, count);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    int j = e;
    while (j < lim && sid[j] == id) {
      a0 = __fadd_rn(a0, sval[3 * j]);
      a1 = __fadd_rn(a1, sval[3 * j + 1]);
      a2 = __fadd_rn(a2, sval[3 * j + 2]);
      ++j;
    }
    if (sid[j] != id) {  // j <= count: the run ended here
      o[3 * (size_t)id] = a0;
      o[3 * (size_t)id + 1] = a1;
      o[3 * (size_t)id + 2] = a2;
    } else {  // longer than kShort, or it goes on into the next slab
      long_at[atomicAdd(&n_long, 1)] = e;
    }
  }
  __syncthreads();

  // one warp per long run; the list's order varies, each run's sum does not
  const int lane = t & 31;
  for (int k = t >> 5; k < n_long; k += kWarps) {
    const int id = sid[long_at[k]];
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    bool more = true;
    for (int j0 = base + long_at[k]; more; j0 += 32 * kStrides) {
      // all loads of the round first, from clamped and so valid addresses,
      // so that none waits for another; what is outside the run is not added
      int ids[kStrides];
      float x0[kStrides], x1[kStrides], x2[kStrides];
#pragma unroll
      for (int u = 0; u < kStrides; ++u) {
        const size_t j = min(j0 + 32 * u + lane, m - 1);
        ids[u] = row[j];
        x0[u] = v[3 * j];
        x1[u] = v[3 * j + 1];
        x2[u] = v[3 * j + 2];
      }
      bool inside = true;
#pragma unroll
      for (int u = 0; u < kStrides; ++u) {
        const bool in = j0 + 32 * u + lane < m && ids[u] == id;
        a0 = in ? __fadd_rn(a0, x0[u]) : a0;
        a1 = in ? __fadd_rn(a1, x1[u]) : a1;
        a2 = in ? __fadd_rn(a2, x2[u]) : a2;
        inside = inside && in;
      }
      more = __all_sync(0xffffffffu, inside);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a0 = __fadd_rn(a0, __shfl_down_sync(0xffffffffu, a0, off));
      a1 = __fadd_rn(a1, __shfl_down_sync(0xffffffffu, a1, off));
      a2 = __fadd_rn(a2, __shfl_down_sync(0xffffffffu, a2, off));
    }
    if (lane == 0) {
      o[3 * (size_t)id] = a0;
      o[3 * (size_t)id + 1] = a1;
      o[3 * (size_t)id + 2] = a2;
    }
  }
}

}  // namespace

// idx (B, M) int32 sorted per row, vals (B, M, 3) f32 -> out (B, S, 3) f32.
// All contiguous on the device; 1 <= B <= 65535, M >= 0.
extern "C" int segsum_sorted_launch(const int* idx, const float* vals,
                                    float* out, int b, int m, int s,
                                    cudaStream_t stream) {
  if (b == 0 || s == 0) return 0;
  const dim3 grid(m > 0 ? (m + kSlab - 1) / kSlab : 1, b);  // an empty row still gets its zeros
  const bool vec = m % 4 == 0 && (uintptr_t)idx % 16 == 0 && (uintptr_t)vals % 16 == 0;
  if (vec) {
    segsum_sorted_kernel<true><<<grid, kThreads, 0, stream>>>(idx, vals, out, m, s);
  } else {
    segsum_sorted_kernel<false><<<grid, kThreads, 0, stream>>>(idx, vals, out, m, s);
  }
  return (int)cudaGetLastError();
}
