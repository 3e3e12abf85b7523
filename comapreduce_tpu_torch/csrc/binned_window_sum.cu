// K3: binned window sum — every pair / rank / offset sum of the
// destriper's CG matvec.
//
// Replaces comapreduce_tpu/mapmaking/pallas_binning.py::
// binned_window_sum_pallas (kernel body _scatter_kernel):
//   out[r, ids[e]] += values[r, e]
// With c = e / chunk and b_c = clip(base[c], 0, out_size), an id adds
// only if b_c <= id < b_c + window and id < out_size; every other id
// (plan sentinels) drops — the semantics of
// pointing_plan._binned_window_sum_fori. The R leading rows (the
// multi-RHS bands) share the ids.
//
// Bound on an H100: bytes — values R x M f32 and ids M i32 read once,
// out R x out_size f32 written once, at 3.35 TB/s.
//
// Design. The TPU kernel ran its chunks in order and summed each chunk's
// window in VMEM. CUDA blocks run concurrently, so this kernel adds into
// device memory with atomics and makes each atomic carry a whole run:
// - The grid tiles the element axis, independent of the plan's chunk:
//   a block of BW_THREADS threads takes BW_THREADS x BW_EPT consecutive
//   elements, so even the smallest main-path site (the flagship's
//   rank_sum, M ~ 5.6e5) launches several blocks per SM.
// - A thread loads its BW_EPT consecutive ids, and per band as many
//   values, with 16-byte evict-first loads (read once: measured faster
//   than __ldg here), applies the window test (one division per chunk it
//   touches, not per element) and sums its runs of equal kept ids in
//   registers.
// - A warp joins the runs that cross its threads with a segmented scan
//   keyed on the id (__shfl_up_sync). Only the lane that holds a run's
//   end issues its global atomicAdd (a RED), so a run of equal ids costs
//   one atomic per band and per warp, not one per element: the plan's
//   ids are ascending at every site, so runs are long.
// - The ids, the window test and the run structure are computed once and
//   serve all R bands. Nothing is zeroed or flushed per chunk (the
//   wrapper zeroes `out`), so one body serves every window width.
// Correct for ids in any order; sorted ids only make the runs long.
// Float atomics and the scan's tree change the summation order from run
// to run: results agree with the ordered reference to f32
// summation-order tolerance, not bitwise.
#include "common.cuh"

constexpr int BW_THREADS = 128;
constexpr int BW_EPT = 8;    // consecutive elements per thread
constexpr int BW_BANDS = 4;  // bands whose values are loaded together

__global__ void __launch_bounds__(BW_THREADS, 8)
binned_window_sum_kernel(const float* __restrict__ values,
                         const int* __restrict__ ids,
                         const int* __restrict__ base,
                         float* __restrict__ out, long long M, int R,
                         int window, int chunk, int out_size, int vec) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long e0 =
      ((long long)blockIdx.x * BW_THREADS + threadIdx.x) * BW_EPT;
  const bool whole = vec && e0 + BW_EPT <= M;

  // kept id per element, -1 where it drops
  int key[BW_EPT];
  if (whole) {
#pragma unroll
    for (int h = 0; h < BW_EPT; h += 4) {
      const int4 a = __ldcs(reinterpret_cast<const int4*>(ids + e0 + h));
      key[h] = a.x; key[h + 1] = a.y; key[h + 2] = a.z; key[h + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BW_EPT; ++i)
      key[i] = e0 + i < M ? ids[e0 + i] : -1;
  }
  int lo = 0, hi = 0;
  long long next = 0;  // first element of the next chunk
#pragma unroll
  for (int i = 0; i < BW_EPT; ++i) {
    const long long e = e0 + i;
    if (e >= M) { key[i] = -1; continue; }
    if (e >= next) {
      const long long c = e / chunk;
      next = (c + 1) * chunk;
      int b = __ldg(base + c);
      b = b < 0 ? 0 : (b > out_size ? out_size : b);
      lo = b;
      hi = out_size - b < window ? out_size : b + window;
    }
    if (key[i] < lo || key[i] >= hi) key[i] = -1;
  }

  // run structure, shared by every band: ``ends[i]`` closes a run inside
  // the thread; the thread's first run is its head, its last its tail
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
  // segmented inclusive scan of the tail sums: a segment is one lane's
  // tail run followed by whole lanes of the same id. Precompute, per
  // step d = 1, 2, 4, 8, 16, whether a lane adds the sum d lanes up.
  unsigned adds = 0;
  {
    bool f = !(single && head_joins);  // the tail run starts a segment
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const bool fu = __shfl_up_sync(FULL, (int)f, 1 << t);
      if (lane >= (1 << t)) {
        if (!f) adds |= 1u << t;
        f = f || fu;
      }
    }
  }

  for (int r0 = 0; r0 < R; r0 += BW_BANDS) {
    float v[BW_BANDS][BW_EPT];
#pragma unroll
    for (int q = 0; q < BW_BANDS; ++q) {
      if (r0 + q >= R) break;
      const float* row = values + (long long)(r0 + q) * M + e0;
      if (whole) {
#pragma unroll
        for (int h = 0; h < BW_EPT; h += 4) {
          const float4 a = __ldcs(reinterpret_cast<const float4*>(row + h));
          v[q][h] = a.x; v[q][h + 1] = a.y; v[q][h + 2] = a.z;
          v[q][h + 3] = a.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < BW_EPT; ++i)
          v[q][i] = e0 + i < M ? row[i] : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < BW_BANDS; ++q) {
      if (r0 + q >= R) break;
      float* o = out + (long long)(r0 + q) * out_size;
      float run = 0.f, head = 0.f, tail = 0.f;
      bool in_head = true;
#pragma unroll
      for (int i = 0; i < BW_EPT; ++i) {
        run += v[q][i];
        if (ends[i]) {
          if (in_head)
            head = run;
          else if (i < BW_EPT - 1 && key[i] >= 0)
            atomicAdd(o + key[i], run);  // a run inside the thread
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
      // a head that is not also the tail closes the run it continues
      if (!single && kf >= 0) atomicAdd(o + kf, head_joins ? head + s_prev
                                                           : head);
      if (tail_emits) atomicAdd(o + kl, s);
    }
  }
}

extern "C" int cr_binned_window_sum(const void* values, const void* ids,
                                    const void* base, void* out, long long M,
                                    int R, int window, int chunk,
                                    int out_size, int vec, void* stream) {
  const long long per_block = (long long)BW_THREADS * BW_EPT;
  const long long blocks = (M + per_block - 1) / per_block;
  binned_window_sum_kernel<<<(unsigned)blocks, BW_THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const float*)values, (const int*)ids, (const int*)base, (float*)out,
      M, R, window, chunk, out_size, vec);
  return (int)cudaGetLastError();
}

// Resident blocks per SM (the occupancy the launch gets) and the
// elements one block takes; a CUDA error is returned negated.
extern "C" int cr_binned_window_sum_occupancy(int* elements_per_block) {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, binned_window_sum_kernel, BW_THREADS, 0);
  *elements_per_block = BW_THREADS * BW_EPT;
  return e == cudaSuccess ? n : -(int)e;
}
