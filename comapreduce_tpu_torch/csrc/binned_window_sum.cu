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
// Bound on an H100: bytes — values R x M f32 and ids M i32 read once,
// out R x out_size f32 written once, and the partial buffer below
// written once and read once, at 3.35 TB/s.
//
// Design: two passes, each adding in an order fixed by the inputs and
// the launch, so the same inputs give the same bits on every run (no
// float atomics anywhere).
// - Pass 1, one block per chunk: the block sums its chunk into the
//   chunk's window, held in shared memory per band, then writes the
//   window to partial[r][c][0, window). A window wider than BW_SLICE
//   bins is done slice by slice (the chunk is re-read per slice; every
//   main-path window, 256-4096 bins, is one slice).
//   - A thread loads BW_EPT consecutive ids and per band as many values
//     (16-byte evict-first loads), applies the window test and sums its
//     runs of equal kept ids in registers, in element order.
//   - A warp joins the runs that cross its lanes with a segmented scan
//     keyed on the id (__shfl_up_sync, a fixed tree).
//   - A tile of ids that is non-decreasing (every plan's tiles, tested per
//     tile) keeps its kept ids in one sorted stretch, so after the scans
//     each id is emitted once, but for a warp's last run, which the next
//     warp may continue: all warps add into the shared window at once
//     with plain adds, and the warps' last runs are added after a barrier
//     in warp order.
//   - Any other tile: the warps emit one after the other, a run per
//     round; a round in which two lanes hold the same id goes lane by
//     lane. So the order of adds into any bin is fixed by the ids.
// - Pass 2, one thread per output bin: adds the bin's entries of the
//   partial rows of the chunks whose windows cover it, in chunk order.
//   Where the clipped bases are non-decreasing (every plan: its ids are
//   sorted across chunks) two binary searches per block of bins find the
//   few chunks that can cover them; else (flagged by pass 1) every chunk
//   is tested. Every bin is written, so nothing is zeroed first.
// Scratch: R x n_chunks x window f32. At the largest site, the field
// run's R = 4 pair sum (4 observations x 19 feeds x 135 700 samples,
// chunk 8192, window 1920): 4 x 1259 x 1920 x 4 B = 38.7 MB, against
// 165 MB of values.
// Correct for ids in any order; sorted ids make the runs long and the
// lane-by-lane rounds never happen.
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
