// Coordinate-wise trimmed mean over the client axis of a row-major [K, D]
// float32 matrix, for Hopper (sm_90a).
//
// Replaces: blades_tpu/ops/pallas_trimmed.py:_trimmed_mean_pallas (the
// pl.pallas_call at :97, kernel body _kernel :75, math _trim_survivor_mean
// :53). For every column it removes the b largest values, then the b
// smallest of the rows still left, ties going to the lowest row index first
// (what 2b passes of "argmax over the rows not yet removed" do), and returns
// the mean of the K - 2b survivors. The removed extremes never enter the sum,
// so rows at 1e30 or +-3e38 cannot overflow it or cancel against it.
//
// Bound: bytes. The function must read K*D*4 bytes and write D*4; at the
// main path's K=1000, D=59,850 that is 239 MB, about 71 us at the H100's
// 3.35 TB/s, and it does a handful of compares per element.
//
// Design: one read from device memory, each column spread over a warp.
//   A block of 8 warps owns a tile of 16 columns and all K rows. It copies
//   the tile into shared memory once (cp.async of 4 bytes: a row of the
//   matrix is only 4-byte aligned when D is odd, so neither float4 loads nor
//   a TMA tensor map, which needs 16-byte strides, can address it), with a
//   row pitch of 17 floats, so a warp that walks one column reads 32 banks.
//   At K=1000 the tile is 68 KB and three blocks share an SM. Each warp owns
//   two of the tile's columns, lane l holding rows l, l+32, ..., and every
//   later pass reads shared memory only:
//   1. Each lane takes the max and the min of its rows.
//   2. theta, the b-th largest lane max, has at least b entries at or above
//      it, so T (the top b under value desc, row asc) lies there; theta',
//      the b-th smallest lane min, has at least b at or below it. One pass
//      gathers both sets into 32-entry lists by ballot compaction, in row
//      order (at K=1000 each holds about b to 1.4b entries), and adds every entry
//      in neither list to its lane's sum. The compaction runs only on the
//      32-row steps where some lane has a candidate.
//   3. Each lane ranks its list entry against the list: T is the top list's
//      first b, and when the lists are disjoint (theta' < theta) the bottom
//      list lies outside T, so S (the first b of value asc, row asc outside
//      T) is the bottom list's first b. The lists' other entries join the
//      sum, so only survivors enter it, and a warp reduction finishes it.
//   A list that overflows takes the b-th of the 32 entries it kept as its
//   new threshold and the pass runs again; when that is no higher (a tie at
//   the threshold, as with ALIE's identical rows) it gathers strictly
//   beyond the threshold instead. A strict list left with fewer than b
//   entries, or lists that would overlap (a column of equal values), send
//   the column down the exact general route: bisect the 32-bit ordered keys
//   for the b-th value (one count pass per step; at a tie the first step
//   settles it), scan its ties in row order for the row, first for T, then
//   for S outside T, then sum the survivors in one more pass. The columns
//   of a block run each pass together, so every pass stays block-uniform.
// Large K: a tile of K rows fits 227 KB of shared memory up to K = 3297
// (kMaxTileRows). Above that the same kernel streams each pass through the
// tile in chunks of 960 rows from device memory: at least two reads of the
// matrix instead of one.
// Ties are the rule on the main path, not an edge case: ALIE writes the
// same row for every byzantine client.
//
// Contract: x finite (the round engine applies nan_to_num before it
// aggregates, blades_tpu/core/engine.py:729); 1 <= b <= 16; 2b < K.
// Infinities and NaN are outside it: the thresholds use +-inf as "none" and
// NaN fails every compare.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kCols = 16;               // columns of a block's tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlots = kCols / kWarps;  // columns of a warp
constexpr int kPitch = kCols + 1;       // tile row pitch, floats: a column walk hits 32 banks
constexpr int kCap = 32;                // entries of a candidate list: one a lane
constexpr int kStreamRows = 960;        // rows of a chunk when K exceeds kMaxTileRows
constexpr int kMaxSmem = 227 * 1024;    // static + dynamic shared memory of a block
constexpr int kStaticSmem = kWarps * kSlots * 2 * kCap * (sizeof(float) + sizeof(int));
constexpr int kMaxTileRows = (kMaxSmem - kStaticSmem) / (kPitch * sizeof(float));
constexpr unsigned kFull = 0xffffffffu;

// Order-preserving map of a float's bits to an unsigned key, and back.
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ bool in_order(bool top, float a, float b) { return top ? a > b : a < b; }

__device__ __forceinline__ bool in_top(float v, int r, float tval, int trow) {
  return v > tval || (v == tval && r <= trow);
}

// The k-th largest (1-based) of the warp's 32 values: a bitonic sort,
// descending across the lanes, then a read of lane k-1.
__device__ __forceinline__ float warp_kth_largest(float v, int k) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 2; w <= 32; w <<= 1) {
#pragma unroll
    for (int j = w >> 1; j > 0; j >>= 1) {
      const float o = __shfl_xor_sync(kFull, v, j);
      const bool keep_max = ((lane & j) == 0) == ((lane & w) == 0);
      v = keep_max ? fmaxf(v, o) : fminf(v, o);
    }
  }
  return __shfl_sync(kFull, v, k - 1);
}

__device__ __forceinline__ float warp_kth_smallest(float v, int k) {
  return -warp_kth_largest(-v, k);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

struct Tile {
  const float* x;
  float* s;  // [R][kPitch]
  int K;
  int64_t D;
  int64_t col0;
  int ncols;  // columns of the tile inside the matrix
  int R;      // rows the tile holds: K, or kStreamRows
};

// Copy rows [r0, r0 + rows) of the tile's columns into shared memory: thread
// i copies column i % kCols of every (kThreads / kCols)-th row.
__device__ __forceinline__ void load_rows(const Tile& t, int r0, int rows) {
  constexpr int kStep = kThreads / kCols;
  const int c = threadIdx.x % kCols;
  int r = threadIdx.x / kCols;
  if (c < t.ncols) {
    const float* src = t.x + static_cast<int64_t>(r0 + r) * t.D + t.col0 + c;
    float* dst = t.s + r * kPitch + c;
    for (; r < rows; r += kStep, src += kStep * t.D, dst += kStep * kPitch) cp_async4(dst, src);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// f(slot, value, row, ok) for the rows of each column the warp owns, in row
// order, 32 rows a step (ok is false past the last row; every lane calls f,
// so f may ballot). Every thread of the block calls sweep: a streamed tile
// reloads its chunks.
template <class F>
__device__ __forceinline__ void sweep(const Tile& t, F&& f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = 0; r0 < t.K; r0 += t.R) {
    const int rows = min(t.R, t.K - r0);
    if (t.R < t.K) {
      __syncthreads();  // the previous chunk is read
      load_rows(t, r0, rows);
    }
    auto step = [&](int i, bool ok) {
      float v[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) v[s] = ok ? t.s[(i + lane) * kPitch + warp + s * kWarps] : 0.0f;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (warp + s * kWarps < t.ncols) f(s, v[s], r0 + i + lane, ok);
      }
    };
    const int full = rows & ~31;
    for (int i = 0; i < full; i += 32) step(i, true);
    if (full < rows) step(full, full + lane < rows);
  }
}

__device__ __forceinline__ bool any_slot(const bool (&flag)[kSlots]) {
  bool a = false;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) a = a || flag[s];
  return a;
}

// Append (v, r) to a candidate list where pred holds, in row order, keeping
// the first kCap; n counts every entry offered.
__device__ __forceinline__ void gather(float* lv, int* lr, int& n, float v, int r, bool pred) {
  const unsigned m = __ballot_sync(kFull, pred);
  if (pred) {
    const int pos = n + __popc(m & ((1u << (threadIdx.x & 31)) - 1u));
    if (pos < kCap) {
      lv[pos] = v;
      lr[pos] = r;
    }
  }
  n += __popc(m);
}

// The general route, for the slots flagged in `slow`: the B-th entry
// (val, row) among the eligible ones under the top or bottom order, where
// `thr` has at least B eligible entries at or beyond it. Bisect the ordered
// keys for the value (count passes), then scan its ties in row order.
// Every thread of the block calls it.
template <int B, bool kTop, class Elig>
__device__ void select_general(const Tile& t, const bool (&slow)[kSlots],
                               const float (&thr)[kSlots], Elig eligible,
                               float (&val)[kSlots], int (&row)[kSlots]) {
  const int lane = threadIdx.x & 31;
  // top: lo always has >= B entries at or above it, hi fewer;
  // bottom: hi always has >= B entries at or below it, lo fewer.
  uint32_t lo[kSlots], hi[kSlots], mid[kSlots];
  int edge[kSlots];  // the count at the failing end
  bool searching[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    lo[s] = kTop ? order_key(thr[s]) : order_key(-INFINITY);
    hi[s] = kTop ? order_key(INFINITY) : order_key(thr[s]);
    mid[s] = kTop ? lo[s] + 1 : hi[s] - 1;  // first: is thr itself the value?
    edge[s] = 0;
    searching[s] = slow[s] && hi[s] - lo[s] > 1;
  }
  while (__syncthreads_or(any_slot(searching))) {
    float probe[kSlots];
    int count[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      probe[s] = key_value(mid[s]);
      count[s] = 0;
    }
    sweep(t, [&](int s, float v, int r, bool ok) {
      if (!searching[s]) return;
      const bool p = ok && eligible(s, v, r) && (v == probe[s] || in_order(kTop, v, probe[s]));
      count[s] += __popc(__ballot_sync(kFull, p));
    });
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (!searching[s]) continue;
      const bool reached = count[s] >= B;
      if (reached == kTop) {
        lo[s] = mid[s];
      } else {
        hi[s] = mid[s];
      }
      if (!reached) edge[s] = count[s];
      searching[s] = hi[s] - lo[s] > 1;
      mid[s] = lo[s] + (hi[s] - lo[s]) / 2;
    }
  }
  int need[kSlots];  // which tie in row order
  bool look[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (slow[s]) val[s] = key_value(kTop ? lo[s] : hi[s]);
    need[s] = B - edge[s];
    look[s] = slow[s];
  }
  sweep(t, [&](int s, float v, int r, bool ok) {
    if (!look[s]) return;
    const unsigned m = __ballot_sync(kFull, ok && eligible(s, v, r) && v == val[s]);
    const int n = __popc(m);
    if (need[s] <= n) {
      unsigned mm = m;
      for (int q = 1; q < need[s]; ++q) mm &= mm - 1;
      row[s] = r - lane + __ffs(mm) - 1;
      look[s] = false;
    } else {
      need[s] -= n;
    }
  });
}

template <int B>
__global__ void __launch_bounds__(kThreads, 3)  // three tiles of K=1000 share an SM
    trimmed_mean_kernel(const float* __restrict__ x, float* __restrict__ out, int K, int64_t D,
                        int R) {
  extern __shared__ float tile_smem[];
  // candidate lists of each column: [0] top, [1] bottom
  __shared__ float cand_v[kWarps][kSlots][2][kCap];
  __shared__ int cand_r[kWarps][kSlots][2][kCap];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kCols;
  const Tile t{x, tile_smem, K, D, col0, static_cast<int>(D - col0 < kCols ? D - col0 : kCols), R};
  if (R >= K) load_rows(t, 0, K);
  bool active[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) active[s] = warp + s * kWarps < t.ncols;

  // 1. lane extremes; the min keeps the last of equal rows, so a lane whose
  // min is in T has every row in T
  float lmax[kSlots], lmin[kSlots];
  int lmin_row[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    lmax[s] = -INFINITY;
    lmin[s] = INFINITY;
    lmin_row[s] = -1;
  }
  sweep(t, [&](int s, float v, int r, bool ok) {
    if (!ok) return;
    lmax[s] = fmaxf(lmax[s], v);
    if (v <= lmin[s]) {
      lmin[s] = v;
      lmin_row[s] = r;
    }
  });

  // 2. one pass gathers the entries at or above theta (>= B of them) and at
  // or below theta' (>= B lane minima), and sums the entries in neither
  // list. With the lists disjoint (theta' < theta) the bottom list lies
  // outside T, so S is its first B. A list past kCap entries takes the B-th
  // of the entries it kept as its threshold and the pass runs again; if
  // that is no higher (a tie at the threshold), it gathers strictly beyond
  // the threshold instead. A strict list left with fewer than B entries, or
  // lists that overlap, send the column down the general route.
  float thr_t[kSlots], thr_b[kSlots], acc[kSlots];
  bool strict_t[kSlots], strict_b[kSlots];
  int n_t[kSlots] = {}, n_b[kSlots] = {};
  bool again[kSlots], general[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    thr_t[s] = warp_kth_largest(lmax[s], B);
    thr_b[s] = warp_kth_smallest(lmin[s], B);
    strict_t[s] = strict_b[s] = false;
    again[s] = active[s];
    general[s] = false;
    acc[s] = 0.0f;
  }
  while (__syncthreads_or(any_slot(again))) {
    float ge[kSlots], le[kSlots];  // gather v >= ge into the top list, v <= le into the bottom
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (!again[s]) continue;  // a settled column keeps its lists
      const bool disjoint =
          thr_b[s] < thr_t[s] || (thr_b[s] == thr_t[s] && (strict_t[s] || strict_b[s]));
      general[s] = !disjoint;
      again[s] = disjoint;
      ge[s] = strict_t[s] ? nextafterf(thr_t[s], INFINITY) : thr_t[s];
      le[s] = strict_b[s] ? nextafterf(thr_b[s], -INFINITY) : thr_b[s];
      n_t[s] = n_b[s] = 0;
      acc[s] = 0.0f;
    }
    sweep(t, [&](int s, float v, int r, bool ok) {
      if (!again[s]) return;
      const bool pt = ok && v >= ge[s], pb = ok && v <= le[s];
      if (__any_sync(kFull, pt || pb)) {
        gather(cand_v[warp][s][0], cand_r[warp][s][0], n_t[s], v, r, pt);
        gather(cand_v[warp][s][1], cand_r[warp][s][1], n_b[s], v, r, pb);
      }
      if (ok && !pt && !pb) acc[s] += v;
    });
    __syncwarp();
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (!again[s]) continue;
      again[s] = false;
      if (n_t[s] > kCap) {
        const float th = warp_kth_largest(cand_v[warp][s][0][lane], B);
        strict_t[s] = !(th > thr_t[s]);
        thr_t[s] = th;
        again[s] = true;
      } else if (n_t[s] < B) {
        general[s] = true;
      }
      if (n_b[s] > kCap) {
        const float th = warp_kth_smallest(cand_v[warp][s][1][lane], B);
        strict_b[s] = !(th < thr_b[s]);
        thr_b[s] = th;
        again[s] = true;
      } else if (n_b[s] < B) {
        general[s] = true;
      }
      again[s] = again[s] && !general[s];
    }
    __syncwarp();
  }

  // 3. rank the lists: T is the top list's first B, S the bottom list's;
  // the rest of both lists are survivors
  float tval[kSlots], sval[kSlots];
  int trow[kSlots], srow[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    tval[s] = sval[s] = 0.0f;
    trow[s] = srow[s] = -1;
    if (!active[s] || general[s]) continue;
    const float* tv = cand_v[warp][s][0];
    const float* bv = cand_v[warp][s][1];
    const float mt = lane < n_t[s] ? tv[lane] : 0.0f;
    const float mb = lane < n_b[s] ? bv[lane] : 0.0f;
    int rt = 0, rb = 0;
    const int n = max(n_t[s], n_b[s]);
    for (int k = 0; k < n; ++k) {
      const float wt = tv[k], wb = bv[k];
      rt += k < n_t[s] && (wt > mt || (wt == mt && k < lane));
      rb += k < n_b[s] && (wb < mb || (wb == mb && k < lane));
    }
    if (lane < n_t[s] && rt >= B) acc[s] += mt;
    if (lane < n_b[s] && rb >= B) acc[s] += mb;
    const unsigned h = __ballot_sync(kFull, lane < n_t[s] && rt == B - 1);
    tval[s] = tv[__ffs(h) - 1];
    trow[s] = cand_r[warp][s][0][__ffs(h) - 1];
  }

  // the general route: bisection and tie scans for T, then for S outside
  // T below theta'' (the B-th lane min whose lane is not all in T), then the
  // survivors' sum
  if (__syncthreads_or(any_slot(general))) {
    select_general<B, true>(t, general, thr_t, [](int, float, int) { return true; }, tval, trow);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (!general[s]) continue;
      const bool valid = !in_top(lmin[s], lmin_row[s], tval[s], trow[s]);
      thr_b[s] = warp_kth_smallest(valid ? lmin[s] : INFINITY, B);
    }
    auto outside_top = [&](int s, float v, int r) { return !in_top(v, r, tval[s], trow[s]); };
    select_general<B, false>(t, general, thr_b, outside_top, sval, srow);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (general[s]) acc[s] = 0.0f;
    }
    sweep(t, [&](int s, float v, int r, bool ok) {
      const bool survivor = ok && !in_top(v, r, tval[s], trow[s]) &&
                            !(v < sval[s] || (v == sval[s] && r <= srow[s]));
      if (general[s] && survivor) acc[s] += v;
    });
  }

#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    float a = acc[s];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kFull, a, o);
    if (lane == 0 && active[s]) out[col0 + warp + s * kWarps] = a / static_cast<float>(K - 2 * B);
  }
}

// Configure the instantiation once per device: the dynamic shared memory
// above 48 KB and the largest shared-memory carveout.
template <int B>
cudaError_t configure() {
  static uint64_t done = 0;  // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? (uint64_t{1} << dev) : 0;
  if (done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(trimmed_mean_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxTileRows * kPitch * static_cast<int>(sizeof(float)));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(trimmed_mean_kernel<B>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e == cudaSuccess) done |= bit;
  return e;
}

template <int B>
cudaError_t launch(const float* x, float* out, int K, int64_t d, cudaStream_t s) {
  const cudaError_t e = configure<B>();
  if (e != cudaSuccess) return e;
  const int R = K <= kMaxTileRows ? K : kStreamRows;
  const size_t smem = static_cast<size_t>(R) * kPitch * sizeof(float);
  const dim3 grid(static_cast<unsigned>((d + kCols - 1) / kCols));
  trimmed_mean_kernel<B><<<grid, kThreads, smem, s>>>(x, out, K, d, R);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (blades_tpu_torch/ops/trimmed.py). Launches
// on `stream`, does not synchronise, and returns the cudaError_t of the
// launch (0 on success); an unsupported b returns cudaErrorInvalidValue
// without launching.
extern "C" int blades_trimmed_mean_f32(const float* x, float* out, int64_t k, int64_t d, int b,
                                       void* stream) {
  if (k <= 2 * static_cast<int64_t>(b) || k > INT32_MAX || d < 0 ||
      (d + kCols - 1) / kCols > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = static_cast<int>(k);
  switch (b) {
#define BLADES_TM_CASE(N) \
  case N:                 \
    return static_cast<int>(launch<N>(x, out, K, d, s));
    BLADES_TM_CASE(1)
    BLADES_TM_CASE(2)
    BLADES_TM_CASE(3)
    BLADES_TM_CASE(4)
    BLADES_TM_CASE(5)
    BLADES_TM_CASE(6)
    BLADES_TM_CASE(7)
    BLADES_TM_CASE(8)
    BLADES_TM_CASE(9)
    BLADES_TM_CASE(10)
    BLADES_TM_CASE(11)
    BLADES_TM_CASE(12)
    BLADES_TM_CASE(13)
    BLADES_TM_CASE(14)
    BLADES_TM_CASE(15)
    BLADES_TM_CASE(16)
#undef BLADES_TM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The rows a block keeps in shared memory at once: K when the whole column
// tile fits (one read of the matrix), else the chunk the passes stream.
extern "C" int blades_trimmed_mean_tile_rows(int64_t k) {
  return k <= kMaxTileRows ? static_cast<int>(k) : kStreamRows;
}
