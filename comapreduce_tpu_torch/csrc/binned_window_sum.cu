// K3: binned window sum — every pair / rank / offset sum of the
// destriper's CG matvec, in a fixed order.
//
// Replaces comapreduce_tpu/mapmaking/pallas_binning.py::
// binned_window_sum_pallas (kernel body _scatter_kernel):
//   out[r, ids[e]] += values[r, e]
// With c = e / chunk and b_c = clip(base[c], 0, out_size), an id adds
// only if b_c <= id < b_c + window and id < out_size; every other id
// (plan sentinels) drops — the semantics of
// pointing_plan._binned_window_sum_fori. The R leading rows (the
// multi-RHS bands) share the ids. The TPU kernel ran its chunks in order
// and summed each chunk's window in VMEM, so its sums had one order.
//
// Two bodies, each adding in an order fixed by the inputs, R and its
// compile-time constants, so the same inputs give the same bits on every
// run and every card (no float atomics anywhere).
//
// One-pass body (cr_binned_window_sum_sorted), for ids that never
// descend over the whole array — every plan's ids at all six call sites
// of the planned solvers (pointing_plan builds each layout from sorted
// keys). The terms of a bin are then one contiguous run, so the sum is a
// segmented reduction: no window in shared memory, no scratch, one
// launch and no memset.
// Bound on an H100: bytes — values R x M f32, ids M i32 and base
// M / chunk i32 read once, out R x out_size f32 written once, at
// 3.35 TB/s.
// - A block takes a tile of BW_TILE consecutive elements (a constant,
//   not tied to chunk, the card or its occupancy; a tile may straddle
//   chunks): 8 per thread, its ids and first bands' values loaded at
//   once in 16-byte loads. Each element's window test uses
//   clip(base[e / chunk], 0, out_size); a dropped element keeps its id
//   and adds +0.0.
// - Tile t owns the bins (ids[tT - 1], ids[(t + 1)T - 1]] clipped to
//   [0, out_size); the first tile's range starts at bin 0 and the last
//   tile's ends at out_size. It writes each bin it owns exactly once: a
//   run's sum where the id occurs, else 0 (the gaps between consecutive
//   ids, before the first id and after the last; a gap of more than 4
//   bins is written by the warp together). Bins owned by one tile are
//   written by nobody else, so blocks never talk to each other.
// - Inside the tile: a thread sums its runs of equal ids in registers in
//   element order; the runs that cross threads are joined by a segmented
//   scan of (ends a run, sum since the last end) pairs — a fixed
//   shuffle tree within the warp, then the warps' carries in warp order
//   through shared memory; each run's sum is written by the thread that
//   holds its last element.
// - The tile's last run may continue into later tiles: the owner reads
//   ahead, a tile at a time, all threads summing their terms of that id
//   in element order and the block adding them in a fixed tree, until
//   the run ends; a later tile skips the id its predecessor ended on.
//   (The plans hold such runs: 2 080 padding samples on one pair at the
//   flagship pair site, 6 384 at the transfer gate.)
// - Every thread tests its ids against the element before them (the
//   tile's first against the previous tile's last): a descent fails the
//   launch with a device-side assert, never a silent wrong sum.
// - Bands go in groups of BW_GROUP from one read of the ids (R = 1 has a
//   kernel of its own), and no group changes a band's order of adds.
// What holds it (PERF.md; k3_block_timing.py stamps a block's
// phases): a block's life is a cold load of its tile, then its scan, two
// barriers and its writes, and 64 registers a thread leave 4 blocks on
// an SM; a small site is one such life plus the launch.
//
// Two-pass body (cr_binned_window_sum), for ids in any order inside a
// chunk (the TPU kernel's contract).
// Bound: the bytes above plus its partial buffer below, written once
// and read once.
// - Pass 1, one block per chunk: the block sums its chunk into the
//   chunk's window, held in shared memory per band, then writes the
//   window to partial[r][c][0, window). A window wider than BW_SLICE
//   bins is done slice by slice (the chunk is re-read per slice).
//   - A thread loads BW_EPT consecutive ids and per band as many values
//     (16-byte evict-first loads), applies the window test and sums its
//     runs of equal kept ids in registers, in element order.
//   - A warp joins the runs that cross its lanes with a segmented scan
//     keyed on the id (__shfl_up_sync, a fixed tree).
//   - A tile of ids that is non-decreasing (tested per tile) keeps its
//     kept ids in one sorted stretch, so after the scans each id is
//     emitted once, but for a warp's last run, which the next warp may
//     continue: all warps add into the shared window at once with plain
//     adds, and the warps' last runs are added after a barrier in warp
//     order.
//   - Any other tile: the warps emit one after the other, a run per
//     round; a round in which two lanes hold the same id goes lane by
//     lane. So the order of adds into any bin is fixed by the ids.
// - Pass 2, one thread per output bin: adds the bin's entries of the
//   partial rows of the chunks whose windows cover it, in chunk order.
//   Where the clipped bases are non-decreasing two binary searches per
//   block of bins find the few chunks that can cover them; else (flagged
//   by pass 1) every chunk is tested. Every bin is written, so nothing is
//   zeroed first.
// Scratch: R x n_chunks x window f32 (at the field run's R = 4 pair sum,
// chunk 8192, window 1920: 38.7 MB against 165 MB of values).
// The asserts of the one-pass body stay on in every build.
#undef NDEBUG
#include <cassert>
#include <climits>
#include "common.cuh"

constexpr int BW_THREADS = 256;
constexpr int BW_WARPS = BW_THREADS / 32;
constexpr int BW_EPT = 8;        // consecutive elements per thread
constexpr int BW_BANDS = 4;      // bands summed together
constexpr int BW_SLICE = 4096;   // window bins held in shared memory
constexpr int BW_OUT_THREADS = 256;

// Adds ``s`` into ``row[k]`` for every lane with k >= 0; lanes that hold
// the same id add one after the other in lane order. Not inlined: the
// unsorted tiles' rounds call it 36 times, and inlined copies only grow
// the code (and nvcc's time) for a path plans never take.
__device__ __noinline__ void emit(float* row, int k, float s, int lane,
                                  bool clash) {
  if (!clash) {
    if (k >= 0) row[k] += s;
  } else {
    for (int l = 0; l < 32; ++l) {
      if (lane == l && k >= 0) row[k] += s;
      __syncwarp();
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(BW_THREADS)
binned_window_partial_kernel(const float* __restrict__ values,
                             const int* __restrict__ ids,
                             const int* __restrict__ base,
                             float* __restrict__ partial,
                             int* __restrict__ unsorted, long long M, int R,
                             int window, int chunk, int out_size, int vec,
                             int slice) {
  extern __shared__ float win[];  // [min(R, BW_BANDS)][slice]
  __shared__ int carry_key[BW_WARPS];
  __shared__ float carry_sum[BW_WARPS][BW_BANDS];
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long c = blockIdx.x;
  const long long n_chunks = M / chunk;
  int b = base[c];
  b = b < 0 ? 0 : (b > out_size ? out_size : b);
  const int hi = out_size - b < window ? out_size : b + window;
  if (threadIdx.x == 0 && c + 1 < n_chunks) {
    int bn = base[c + 1];
    bn = bn < 0 ? 0 : (bn > out_size ? out_size : bn);
    if (bn < b) atomicOr(unsorted, 1);  // an integer flag: order-free
  }
  const long long e_begin = c * chunk, e_end = e_begin + chunk;
  const int per_pass = BW_THREADS * BW_EPT;
  const int bands = R < BW_BANDS ? R : BW_BANDS;

  for (int s0 = 0; s0 < window; s0 += slice) {
    const int slo = b + s0;
    const int shi = hi - slo < slice ? hi : slo + slice;
    const int width = window - s0 < slice ? window - s0 : slice;
    for (int r0 = 0; r0 < R; r0 += BW_BANDS) {
      const int nb = R - r0 < BW_BANDS ? R - r0 : BW_BANDS;
      for (int j = threadIdx.x; j < bands * slice; j += BW_THREADS)
        win[j] = 0.f;
      __syncthreads();
      for (long long t0 = e_begin; t0 < e_end; t0 += per_pass) {
        const long long e0 = t0 + (long long)threadIdx.x * BW_EPT;
        const bool whole = vec && e0 + BW_EPT <= e_end;
        // kept id per element, relative to the slice; -1 where it drops
        int key[BW_EPT];
        if (whole) {
#pragma unroll
          for (int h = 0; h < BW_EPT; h += 4) {
            const int4 a =
                __ldcs(reinterpret_cast<const int4*>(ids + e0 + h));
            key[h] = a.x; key[h + 1] = a.y; key[h + 2] = a.z;
            key[h + 3] = a.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < BW_EPT; ++i)
            key[i] = e0 + i < e_end ? ids[e0 + i] : -1;
        }
        // whether the tile's ids are non-decreasing (every plan's are)
        bool up = true;
        if (e0 < e_end) {
          if (threadIdx.x > 0) up = __ldg(ids + e0 - 1) <= key[0];
#pragma unroll
          for (int i = 0; i < BW_EPT - 1; ++i)
            up = up && (e0 + i + 1 >= e_end || key[i] <= key[i + 1]);
        }
        const bool sorted = __syncthreads_and(up);
#pragma unroll
        for (int i = 0; i < BW_EPT; ++i) {
          const bool keep = e0 + i < e_end && key[i] >= slo && key[i] < shi;
          key[i] = keep ? key[i] - slo : -1;
        }
        // run structure, shared by every band: ``ends[i]`` closes a run
        // inside the thread; its first run is its head, its last its tail
        bool ends[BW_EPT];
        bool single = true;
#pragma unroll
        for (int i = 0; i < BW_EPT - 1; ++i) {
          ends[i] = key[i] != key[i + 1];
          single = single && !ends[i];
        }
        ends[BW_EPT - 1] = true;
        const int kf = key[0], kl = key[BW_EPT - 1];
        const int kl_prev = __shfl_up_sync(FULL, kl, 1);
        const int kf_next = __shfl_down_sync(FULL, kf, 1);
        // the head continues the previous lane's tail run
        const bool head_joins = lane > 0 && kf == kl_prev;
        // this lane holds the end of its tail run within the warp
        const bool tail_emits = kl >= 0 && (lane == 31 || kf_next != kl);
        // segmented inclusive scan of the tail sums: a segment is one
        // lane's tail run followed by whole lanes of the same id
        unsigned adds = 0;
        {
          bool f = !(single && head_joins);
#pragma unroll
          for (int t = 0; t < 5; ++t) {
            const bool fu = __shfl_up_sync(FULL, (int)f, 1 << t);
            if (lane >= (1 << t)) {
              if (!f) adds |= 1u << t;
              f = f || fu;
            }
          }
        }
        // emission rounds: runs closed inside the thread (element order),
        // then the head, then the tail; per round, whether two lanes hold
        // the same id (then that round goes lane by lane)
        int ek[BW_EPT + 1];
        bool seen_head = false;
#pragma unroll
        for (int i = 0; i < BW_EPT - 1; ++i) {
          ek[i] = (ends[i] && seen_head) ? key[i] : -1;
          seen_head = seen_head || ends[i];
        }
        ek[BW_EPT - 1] = (!single && kf >= 0) ? kf : -1;
        ek[BW_EPT] = tail_emits ? kl : -1;

        float es[BW_BANDS][BW_EPT + 1];
#pragma unroll
        for (int q = 0; q < BW_BANDS; ++q) {
          if (q >= nb) break;
          const float* row = values + (long long)(r0 + q) * M + e0;
          float v[BW_EPT];
          if (whole) {
#pragma unroll
            for (int h = 0; h < BW_EPT; h += 4) {
              const float4 a =
                  __ldcs(reinterpret_cast<const float4*>(row + h));
              v[h] = a.x; v[h + 1] = a.y; v[h + 2] = a.z; v[h + 3] = a.w;
            }
          } else {
#pragma unroll
            for (int i = 0; i < BW_EPT; ++i)
              v[i] = e0 + i < e_end ? row[i] : 0.f;
          }
          float run = 0.f, head = 0.f, tail = 0.f;
          bool in_head = true;
#pragma unroll
          for (int i = 0; i < BW_EPT; ++i) {
            run += v[i];
            if (i < BW_EPT - 1) es[q][i] = run;  // read where ek[i] >= 0
            if (ends[i]) {
              if (in_head) head = run;
              if (i == BW_EPT - 1) tail = run;
              in_head = false;
              run = 0.f;
            }
          }
          float s = tail;
#pragma unroll
          for (int t = 0; t < 5; ++t) {
            const float up = __shfl_up_sync(FULL, s, 1 << t);
            if (adds >> t & 1u) s += up;
          }
          const float s_prev = __shfl_up_sync(FULL, s, 1);
          es[q][BW_EPT - 1] = head_joins ? head + s_prev : head;
          es[q][BW_EPT] = s;
        }
        if (sorted) {
          // the kept ids are one sorted stretch of the tile, so every
          // emitted id is emitted once in the tile, but a warp's last run
          // (lane 31's tail), which the next warp may continue: the warps
          // add at once, and their last runs go in warp order after
#pragma unroll
          for (int q = 0; q < BW_BANDS; ++q) {
            if (q >= nb) break;
            float* row = win + q * slice;
#pragma unroll
            for (int i = 0; i < BW_EPT; ++i)
              if (ek[i] >= 0) row[ek[i]] += es[q][i];
            if (ek[BW_EPT] >= 0) {
              if (lane == 31) carry_sum[warp][q] = es[q][BW_EPT];
              else row[ek[BW_EPT]] += es[q][BW_EPT];
            }
          }
          if (lane == 31) carry_key[warp] = ek[BW_EPT];
          __syncthreads();
          if (threadIdx.x < nb) {
            float* row = win + threadIdx.x * slice;
            for (int w = 0; w < BW_WARPS; ++w)
              if (carry_key[w] >= 0)
                row[carry_key[w]] += carry_sum[w][threadIdx.x];
          }
          __syncthreads();
        } else {
          // per round, whether two lanes hold the same id (then that
          // round goes lane by lane); the warps emit one after the other
          unsigned clash = 0;
#pragma unroll
          for (int i = 0; i < BW_EPT + 1; ++i) {
            const unsigned peers = __match_any_sync(FULL, ek[i]);
            if (__any_sync(FULL, ek[i] >= 0 && __popc(peers) > 1))
              clash |= 1u << i;
          }
          for (int w = 0; w < BW_WARPS; ++w) {
            if (warp == w) {
#pragma unroll
              for (int i = 0; i < BW_EPT + 1; ++i) {
#pragma unroll
                for (int q = 0; q < BW_BANDS; ++q) {
                  if (q >= nb) break;
                  emit(win + q * slice, ek[i], es[q][i], lane,
                       clash >> i & 1u);
                }
              }
            }
            __syncthreads();
          }
        }
      }
      for (int q = 0; q < nb; ++q) {
        float* dst = partial + ((long long)(r0 + q) * n_chunks + c) * window
                     + s0;
        for (int j = threadIdx.x; j < width; j += BW_THREADS)
          dst[j] = win[q * slice + j];
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int clip_base(const int* base, long long c,
                                         int out_size) {
  const int b = __ldg(base + c);
  return b < 0 ? 0 : (b > out_size ? out_size : b);
}

__global__ void __launch_bounds__(BW_OUT_THREADS)
binned_window_out_kernel(const float* __restrict__ partial,
                         const int* __restrict__ base,
                         const int* __restrict__ unsorted,
                         float* __restrict__ out, long long n_chunks, int R,
                         int window, int out_size) {
  __shared__ long long range[2];  // chunks [c_lo, c_hi) to test
  const long long id0 = (long long)blockIdx.x * BW_OUT_THREADS;
  const long long id = id0 + threadIdx.x;
  if (threadIdx.x == 0) {
    long long c_lo = 0, c_hi = n_chunks;
    if (!*unsorted) {
      // the block's bins [id0, last]: the first chunk with
      // b > id0 - window, and the first chunk with b > last
      const long long last =
          (id0 + BW_OUT_THREADS < out_size ? id0 + BW_OUT_THREADS
                                           : out_size) - 1;
      long long lo = 0, hi = n_chunks;
      while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (clip_base(base, mid, out_size) > id0 - window) hi = mid;
        else lo = mid + 1;
      }
      c_lo = lo;
      hi = n_chunks;
      while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (clip_base(base, mid, out_size) > last) hi = mid;
        else lo = mid + 1;
      }
      c_hi = lo;
    }
    range[0] = c_lo;
    range[1] = c_hi;
  }
  __syncthreads();
  if (id >= out_size) return;
  const long long c_lo = range[0], c_hi = range[1];
  for (int r = 0; r < R; ++r) {
    const float* p = partial + (long long)r * n_chunks * window;
    float s = 0.f;
    for (long long c = c_lo; c < c_hi; ++c) {
      const int b = clip_base(base, c, out_size);
      if (b <= id && id < (long long)b + window)
        s += p[c * window + (id - b)];
    }
    out[(long long)r * out_size + id] = s;
  }
}

constexpr int BW_TILE_THREADS = 256;
constexpr int BW_TILE_WARPS = BW_TILE_THREADS / 32;
constexpr int BW_TILE_EPT = 8;   // consecutive elements per thread
// elements a one-pass block owns: with the thread layout, this fixes the
// one-pass body's order of adds (tests/test_torch_window_sum_onepass.py
// reads it)
constexpr int BW_TILE = BW_TILE_THREADS * BW_TILE_EPT;
static_assert(BW_TILE_EPT % 4 == 0, "16-byte loads of a thread's part");
constexpr int BW_SMALL_GAP = 4;  // gaps a thread zeroes alone
constexpr int BW_PAST = INT_MAX; // the key of elements past the array
// bands summed together when R > 1, and the resident blocks asked of
// ptxas (64 registers a thread): the fastest of the layouts measured on
// an H100 (PERF.md); neither changes a sum's bits
constexpr int BW_GROUP = 2;
constexpr int BW_MIN_BLOCKS = 4;

__device__ __forceinline__ int bw_clip(int b, int out_size) {
  return b < 0 ? 0 : (b > out_size ? out_size : b);
}

// Zeroes bins [lo, hi) of every band row: the calling thread alone.
__device__ __forceinline__ void bw_zero(float* out, int R, int out_size,
                                        int lo, int hi) {
  for (int j = lo; j < hi; ++j)
    for (int r = 0; r < R; ++r) out[(long long)r * out_size + j] = 0.f;
}

// A thread's part of its tile, all loaded before any is used: its
// BW_TILE_EPT ids and the first NB bands' values (0 past R or past the
// array).
template <int NB>
struct BwTileIn {
  int key[BW_TILE_EPT];
  float v[NB][BW_TILE_EPT];
};

template <int NB>
struct BwShared {
  int warp_reset[BW_TILE_WARPS];
  float warp_sum[BW_TILE_WARPS][NB];
  float warp_carry[BW_TILE_WARPS][NB];
  float tile_tail[NB];
};

// Loads bands [r0, r0 + NB) of the thread's elements from e0 (16-byte
// loads where ``vec`` and the elements lie inside the array).
template <int NB>
__device__ __forceinline__ void bw_load_values(
    float (&v)[NB][BW_TILE_EPT], const float* __restrict__ values,
    long long M, int R, int r0, long long e0, bool whole) {
  constexpr int EPT = BW_TILE_EPT;
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const float* row = values + (long long)(r0 + q) * M + e0;
    if (r0 + q >= R) {
#pragma unroll
      for (int i = 0; i < EPT; ++i) v[q][i] = 0.f;
    } else if (whole) {
#pragma unroll
      for (int h = 0; h < EPT; h += 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(row + h));
        v[q][h] = a.x; v[q][h + 1] = a.y; v[q][h + 2] = a.z;
        v[q][h + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < EPT; ++i) v[q][i] = e0 + i < M ? row[i] : 0.f;
    }
  }
}

template <int NB>
__device__ __forceinline__ void bw_load(BwTileIn<NB>& in,
                                        const float* __restrict__ values,
                                        const int* __restrict__ ids,
                                        long long M, int R, long long e0,
                                        int vec) {
  constexpr int EPT = BW_TILE_EPT;
  const bool whole = vec && e0 + EPT <= M;
  if (whole) {
#pragma unroll
    for (int h = 0; h < EPT; h += 4) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(ids + e0 + h));
      in.key[h] = a.x; in.key[h + 1] = a.y; in.key[h + 2] = a.z;
      in.key[h + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < EPT; ++i)
      in.key[i] = e0 + i < M ? __ldg(ids + e0 + i) : BW_PAST;
  }
  bw_load_values<NB>(in.v, values, M, R, 0, e0, whole);
}

// Tile t: every bin it owns written once (see the note at the top).
template <int NB>
__device__ __forceinline__ void bw_tile(
    const BwTileIn<NB>& in, long long t, BwShared<NB>& sh,
    const float* __restrict__ values, const int* __restrict__ ids,
    const int* __restrict__ base, float* __restrict__ out, long long M,
    int R, int window, int chunk, int out_size, int vec) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int EPT = BW_TILE_EPT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // 32-bit index math: the wrapper refuses M >= 2**31 - 2 BW_TILE
  const int m = (int)M;
  const int t0 = (int)t * BW_TILE;
  const int t1 = m - t0 < BW_TILE ? m : t0 + BW_TILE;
  const int e0 = t0 + (int)threadIdx.x * EPT;
  // the tile owns the bins above ``lo`` up to its last id (from bin 0 in
  // the first tile)
  const int lo = t0 > 0 ? __ldg(ids + t0 - 1) : INT_MIN;
  const int* key = in.key;
  // the ids just before and just after the thread's elements
  int prev = __shfl_up_sync(FULL, key[EPT - 1], 1);
  if (lane == 0)
    prev = e0 == 0 ? INT_MIN : (e0 <= m ? __ldg(ids + e0 - 1) : BW_PAST);
  int next = __shfl_down_sync(FULL, key[0], 1);
  if (lane == 31) next = e0 + EPT < m ? __ldg(ids + e0 + EPT) : BW_PAST;
  bool up = prev <= key[0];
#pragma unroll
  for (int i = 0; i < EPT - 1; ++i) up = up && key[i] <= key[i + 1];
  assert(up && "binned_window_sum: ids_sorted=True but the ids descend");

  // the window starts of the thread's chunks: two at most when
  // chunk >= EPT (c1 * chunk <= M: no overflow), else one per element
  const int c0 = e0 < m ? (int)((unsigned)e0 / (unsigned)chunk) : 0;
  const int c1_start = (c0 + 1) * chunk;
  const int b0 = e0 < m ? bw_clip(__ldg(base + c0), out_size) : 0;
  const int b1 = chunk >= EPT && c1_start < m && c1_start < e0 + EPT
                     ? bw_clip(__ldg(base + c0 + 1), out_size)
                     : b0;
  const int n_in = m - e0;  // the thread's elements inside the array
  // bit i: element i ends a run / starts one / passes its window test
  unsigned ends = 0, starts = 0, keep = 0;
  // a gap before some id of the thread (a superset: the zeros below work
  // out the exact bins)
  bool gap = false;
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int nk = i + 1 < EPT ? key[i + 1] : next;
    const int pk = i > 0 ? key[i - 1] : prev;
    const bool in = i < n_in;
    const bool st = in && key[i] != pk;
    ends |= (unsigned)(key[i] != nk) << i;
    starts |= (unsigned)st << i;
    gap = gap || (st && (unsigned)key[i] - (unsigned)pk > 1u);
    const int b = chunk >= EPT
                      ? (e0 + i < c1_start ? b0 : b1)
                      : bw_clip(__ldg(base + (e0 + i) / chunk), out_size);
    // b <= key < b + window, in unsigned arithmetic (no overflow)
    keep |= (unsigned)(in && (unsigned)key[i] - (unsigned)b <
                                 (unsigned)window) << i;
  }

  // zeros: the bins strictly between an id and the one before it (the
  // previous tile's last id before the tile's first, bin -1 before the
  // array's first), within [0, out_size); a warp without any skips this
  if (__any_sync(FULL, gap)) {
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      int gs = 0, ge = 0;
      if (starts >> i & 1u) {
        const int pk = i > 0 ? key[i - 1] : prev;
        gs = pk < 0 ? 0 : (pk >= out_size ? out_size : pk + 1);
        ge = key[i] < out_size ? key[i] : out_size;
      }
      const bool wide = ge - gs > BW_SMALL_GAP;
      if (!wide) bw_zero(out, R, out_size, gs, ge);
      unsigned pend = __ballot_sync(FULL, wide);
      while (pend) {
        const int l = __ffs(pend) - 1;
        pend &= pend - 1;
        const int s = __shfl_sync(FULL, gs, l);
        const int u = __shfl_sync(FULL, ge, l);
        for (int j = s + lane; j < u; j += 32)
          for (int r = 0; r < R; ++r)
            out[(long long)r * out_size + j] = 0.f;
      }
    }
  }
  // the last tile owns every bin past the array's last id
  if (t1 == m) {
    const int last = __ldg(ids + m - 1);
    const int s = last < 0 ? 0 : (last >= out_size ? out_size : last + 1);
    for (int j = s + threadIdx.x; j < out_size; j += BW_TILE_THREADS)
      for (int r = 0; r < R; ++r) out[(long long)r * out_size + j] = 0.f;
  }

  // the tile's last id continues past it: its owner reads ahead
  const int k_last = __ldg(ids + t1 - 1);
  const bool ahead = t1 < m && __ldg(ids + t1) == k_last && k_last > lo &&
                     k_last >= 0 && k_last < out_size;

  for (int r0 = 0; r0 < R; r0 += NB) {
    const int nb = R - r0 < NB ? R - r0 : NB;
    float v[NB][EPT];
    if (r0 == 0) {
#pragma unroll
      for (int q = 0; q < NB; ++q)
#pragma unroll
        for (int i = 0; i < EPT; ++i) v[q][i] = in.v[q][i];
    } else {
      bw_load_values<NB>(v, values, M, R, r0, e0, vec && e0 + EPT <= m);
    }
#pragma unroll
    for (int q = 0; q < NB; ++q)
#pragma unroll
      for (int i = 0; i < EPT; ++i)
        if (!(keep >> i & 1u)) v[q][i] = 0.f;
    // (reset, s): whether the thread ends a run, and its sum since the
    // last end (in element order); the scan carries s into later threads
    // up to the first that ends a run
    int reset = ends != 0;
    float s[NB];
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        a += v[q][i];
        if (ends >> i & 1u) a = 0.f;
      }
      s[q] = a;
    }
    // inclusive segmented scan over the warp's lanes (a fixed tree)
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int ru = __shfl_up_sync(FULL, reset, d);
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        if (q < nb) {
          const float su = __shfl_up_sync(FULL, s[q], d);
          if (lane >= d && !reset) s[q] = su + s[q];
        }
      }
      if (lane >= d) reset |= ru;
    }
    if (lane == 31) {
      sh.warp_reset[warp] = reset;
#pragma unroll
      for (int q = 0; q < NB; ++q) sh.warp_sum[warp][q] = s[q];
    }
    // exclusive: what the lanes before this one carry into it
    const int ex_reset = __shfl_up_sync(FULL, reset, 1);
    float carry[NB];
#pragma unroll
    for (int q = 0; q < NB; ++q)
      carry[q] = q < nb ? __shfl_up_sync(FULL, s[q], 1) : 0.f;
    __syncthreads();
    // the warps' carries, in warp order
    if (threadIdx.x < nb) {
      const int q = threadIdx.x;
      float a = 0.f;
      for (int w = 0; w < BW_TILE_WARPS; ++w) {
        sh.warp_carry[w][q] = a;
        a = sh.warp_reset[w] ? sh.warp_sum[w][q] : a + sh.warp_sum[w][q];
      }
      sh.tile_tail[q] = a;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      if (q >= nb) break;
      const float wc = sh.warp_carry[warp][q];
      float run = lane == 0 ? wc : (ex_reset ? carry[q] : wc + carry[q]);
      float* row = out + (long long)(r0 + q) * out_size;
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        run += v[q][i];
        if (ends >> i & 1u) {
          if (key[i] > lo && (unsigned)key[i] < (unsigned)out_size)
            row[key[i]] = run;
          run = 0.f;
        }
      }
    }
    if (ahead) {
      float acc = threadIdx.x < nb ? sh.tile_tail[threadIdx.x] : 0.f;
      for (int p = t1;; p += BW_TILE) {
        const int f0 = p + (int)threadIdx.x * EPT;
        float part[NB];
#pragma unroll
        for (int q = 0; q < NB; ++q) part[q] = 0.f;
        if (f0 < m) {
          int cc = (int)((unsigned)f0 / (unsigned)chunk);
          int cc_end = (cc + 1) * chunk;
          int bb = bw_clip(__ldg(base + cc), out_size);
          for (int i = 0; i < EPT && f0 + i < m; ++i) {
            const int e = f0 + i;
            const int k = __ldg(ids + e);
            if (k != k_last) break;  // the run is a prefix of what follows
            if (e >= cc_end) {
              ++cc;
              cc_end += chunk;
              bb = bw_clip(__ldg(base + cc), out_size);
            }
            if (k >= bb && k - bb < window) {
#pragma unroll
              for (int q = 0; q < NB; ++q)
                if (q < nb) part[q] += values[(long long)(r0 + q) * M + e];
            }
          }
        }
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          if (q < nb) {
#pragma unroll
            for (int d = 16; d > 0; d >>= 1)
              part[q] += __shfl_down_sync(FULL, part[q], d);
            if (lane == 0) sh.warp_sum[warp][q] = part[q];
          }
        }
        const bool more =
            p + BW_TILE < m && __ldg(ids + p + BW_TILE) == k_last;
        __syncthreads();
        if (threadIdx.x < nb)
          for (int w = 0; w < BW_TILE_WARPS; ++w)
            acc += sh.warp_sum[w][threadIdx.x];
        __syncthreads();
        if (!more) break;
      }
      if (threadIdx.x < nb)
        out[(long long)(r0 + threadIdx.x) * out_size + k_last] = acc;
    }
    __syncthreads();
  }
}

// A block a tile: the tile's ids and first bands loaded at once, then
// summed (a grid-stride loop over tiles with the next tile in flight, in
// registers or in a cp.async ring, was slower on an H100: fewer resident
// blocks). NB bands a group: 1 for R = 1, else BW_GROUP.
template <int NB>
__global__ void __launch_bounds__(BW_TILE_THREADS, BW_MIN_BLOCKS)
binned_window_sorted_kernel(const float* __restrict__ values,
                            const int* __restrict__ ids,
                            const int* __restrict__ base,
                            float* __restrict__ out, long long M, int R,
                            int window, int chunk, int out_size, int vec) {
  __shared__ BwShared<NB> sh;
  BwTileIn<NB> in;
  bw_load<NB>(in, values, ids, M, R,
              (long long)blockIdx.x * BW_TILE +
                  (long long)threadIdx.x * BW_TILE_EPT,
              vec);
  bw_tile<NB>(in, blockIdx.x, sh, values, ids, base, out, M, R, window,
              chunk, out_size, vec);
}

static int bw_slice(int window) {
  return window < BW_SLICE ? window : BW_SLICE;
}

static size_t bw_smem(int R, int window) {
  const int bands = R < BW_BANDS ? R : BW_BANDS;
  return (size_t)bands * bw_slice(window) * sizeof(float);
}

// ``partial`` holds R x (M / chunk) x window f32, ``flag`` one i32.
extern "C" int cr_binned_window_sum(const void* values, const void* ids,
                                    const void* base, void* out,
                                    void* partial, void* flag, long long M,
                                    int R, int window, int chunk,
                                    int out_size, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_chunks = M / chunk;
  const size_t smem = bw_smem(R, window);
  cudaError_t e = cudaFuncSetAttribute(
      binned_window_partial_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(flag, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  binned_window_partial_kernel<<<(unsigned)n_chunks, BW_THREADS, smem, s>>>(
      (const float*)values, (const int*)ids, (const int*)base,
      (float*)partial, (int*)flag, M, R, window, chunk, out_size, vec,
      bw_slice(window));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (out_size + BW_OUT_THREADS - 1) / BW_OUT_THREADS;
  binned_window_out_kernel<<<(unsigned)blocks, BW_OUT_THREADS, 0, s>>>(
      (const float*)partial, (const int*)base, (const int*)flag,
      (float*)out, n_chunks, R, window, out_size);
  return (int)cudaGetLastError();
}

// Resident pass-1 blocks per SM at this R and window (the occupancy the
// launch gets) and the elements one block takes per pass over its
// chunk; a CUDA error is returned negated.
extern "C" int cr_binned_window_sum_occupancy(int R, int window,
                                              int* elements_per_pass) {
  const size_t smem = bw_smem(R, window);
  cudaError_t e = cudaFuncSetAttribute(
      binned_window_partial_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, binned_window_partial_kernel, BW_THREADS, smem);
  *elements_per_pass = BW_THREADS * BW_EPT;
  return e == cudaSuccess ? n : -(int)e;
}

// The one-pass body: ids non-decreasing over all M (a descent asserts).
// One launch, a block a tile; every bin of out is written, so nothing is
// zeroed first, and no scratch is needed.
extern "C" int cr_binned_window_sum_sorted(const void* values,
                                           const void* ids,
                                           const void* base, void* out,
                                           long long M, int R, int window,
                                           int chunk, int out_size, int vec,
                                           void* stream) {
  const unsigned tiles = (unsigned)((M + BW_TILE - 1) / BW_TILE);
  cudaStream_t s = (cudaStream_t)stream;
  if (R == 1)
    binned_window_sorted_kernel<1><<<tiles, BW_TILE_THREADS, 0, s>>>(
        (const float*)values, (const int*)ids, (const int*)base, (float*)out,
        M, R, window, chunk, out_size, vec);
  else
    binned_window_sorted_kernel<BW_GROUP><<<tiles, BW_TILE_THREADS, 0, s>>>(
        (const float*)values, (const int*)ids, (const int*)base, (float*)out,
        M, R, window, chunk, out_size, vec);
  return (int)cudaGetLastError();
}

// Resident one-pass blocks per SM at R bands and the elements a block
// owns; a CUDA error is returned negated.
extern "C" int cr_binned_window_sum_sorted_occupancy(int R, int* tile) {
  int n = 0;
  const cudaError_t e =
      R == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, binned_window_sorted_kernel<1>, BW_TILE_THREADS, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, binned_window_sorted_kernel<BW_GROUP>,
                   BW_TILE_THREADS, 0);
  *tile = BW_TILE;
  return e == cudaSuccess ? n : -(int)e;
}
