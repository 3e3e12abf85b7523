// K2: exact rolling median over caller-padded rows.
//
// Replaces comapreduce_tpu/ops/pallas_median.py::
// rolling_median_windows_pallas (kernel body _kernel):
//   out[r, i] = median(x[r, i : i + window]),  i < T = P - window + 1
// exactly, with jnp.median's NaN semantics (any NaN in a window gives
// NaN) and the equal-middles midpoint of ops/stats._median_mid.
//
// Bound on an H100: at the main-path shape (window 500, 8 rows x 2130
// padded samples per launch) the function needs ~120 KB of traffic and
// at most one linear selection per output (8 x 1631 x 500 compares), a
// fraction of a microsecond either way, so a launch is bounded by its
// own latency: the work has to be short per thread, not just small.
//
// Design (sorted body). Neighbouring outputs share window - 1 samples,
// so a block of RM_OUT threads (one output each) stages its
// ``RM_OUT + window - 1`` segment once, as (i32 key, position) pairs packed
// in one i64 (key high, so i64 order is key order; NaN -> the CR_IMAX
// sentinel), padded to a power of two, and sorts it with a bitonic
// network in shared memory: the selection work is done once per block,
// not once per output. Then each thread:
//   - finds whether its window [t, t + window) holds a NaN by one binary
//     search: NaN keys sort last, ordered by position, so the first
//     CR_IMAX entry at or after position t says it;
//   - walks the sorted segment from its start, counting only entries
//     whose position lies in its window, and takes the keys of the
//     (k_lo+1)-th and (k_hi+1)-th: its two middle order statistics, so
//     median_mid gives the plain version's bits (ties, -0/+0 included).
//     Every lane of a warp reads the same entry at a step (a shared
//     memory broadcast); a walk takes at most RM_OUT + window - 1 steps
//     (about half that on typical data) against the bisection's 34
//     passes over the window.
// Segments whose sorted pairs pass the wrapper's budget take the second
// body, chosen by shape (``ops.cuda_median.rolling_median_sorts``, which
// passes ``sorted``): the segment staged as i32 keys and each thread
// bisecting its own window's value range (32 passes, a NaN count, the
// upper median) with RM_BISECT_OUT outputs a block, so it serves every
// window whose 4 (RM_BISECT_OUT + window - 1) bytes fit a block's shared
// memory (window <= 57 985 on an H100).
#include "common.cuh"

// outputs (threads) per block of each body: 256 was the fastest of 64,
// 128, 256 and 512 for the sorted body at the main path's 8 x 2130,
// window 500 on an H100 (PERF.md): fewer outputs sort the same 1024
// pairs with fewer threads, more leave SMs idle and walk longer segments
constexpr int RM_OUT = 256;
constexpr int RM_BISECT_OUT = 128;

__device__ __forceinline__ long long rm_pack(int key, int pos) {
  return (long long)(((unsigned long long)(unsigned)key << 32) |
                     (unsigned)pos);
}
__device__ __forceinline__ int rm_key(long long e) {
  return (int)((unsigned long long)e >> 32);
}
__device__ __forceinline__ int rm_pos(long long e) {
  return (int)(unsigned)(unsigned long long)e;
}

__device__ __forceinline__ int rm_load_key(const float* xr, long long p,
                                           long long P) {
  if (p >= P) return CR_IMAX;
  const float v = xr[p];
  return (v != v) ? CR_IMAX : f32_key(v);
}

// n: the padded pair count (a power of two >= blockDim.x + window - 1)
__device__ void rm_sorted_body(const float* __restrict__ xr,
                               float* __restrict__ outr, long long P,
                               long long T, int window, long long i0,
                               long long* srt, int n) {
  const int seg_len = blockDim.x + window - 1;
  for (int s = threadIdx.x; s < n; s += blockDim.x)
    srt[s] = rm_pack(s < seg_len ? rm_load_key(xr, i0 + s, P) : CR_IMAX, s);
  __syncthreads();
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
        const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const long long va = srt[a], vb = srt[a + j];
        if ((va > vb) == ((a & k) == 0)) {
          srt[a] = vb;
          srt[a + j] = va;
        }
      }
      // a warp's 32 consecutive compare-exchanges i touch one 64-pair
      // tile while j <= 32, the same tile in every such stage: between
      // two of them the warp needs only its own barrier
      const int next_j = j > 1 ? j >> 1 : k << 1;
      if (j <= 32 && next_j <= 32) __syncwarp(); else __syncthreads();
    }
  }
  const long long i = i0 + threadIdx.x;
  if (i >= T) return;
  const int t = threadIdx.x;

  // first pair >= (CR_IMAX, t): every such pair is a NaN (or a position
  // past the row, never inside a window) at a position >= t
  const long long target = rm_pack(CR_IMAX, t);
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (srt[mid] < target) lo = mid + 1; else hi = mid;
  }
  if (lo < n && rm_pos(srt[lo]) - t < window) {
    outr[i] = __int_as_float(0x7fc00000);
    return;
  }
  // no NaN in the window: its (need_hi)-th in-window pair is finite and
  // lies before every CR_IMAX pair, so the walk stops inside the array;
  // n is a multiple of 4, so a step of four never reads past it
  const int need_lo = (window - 1) / 2 + 1, need_hi = window / 2 + 1;
  int cnt = 0, k_lo = 0, k_hi = 0;
  for (int j = 0; cnt < need_hi; j += 4) {
    const longlong2 a = *reinterpret_cast<const longlong2*>(srt + j);
    const longlong2 b = *reinterpret_cast<const longlong2*>(srt + j + 2);
    const long long e[4] = {a.x, a.y, b.x, b.y};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = (unsigned)(rm_pos(e[u]) - t) < (unsigned)window;
      cnt += in;
      if (in && cnt == need_lo) k_lo = rm_key(e[u]);
      if (in && cnt == need_hi) k_hi = rm_key(e[u]);
    }
  }
  outr[i] = median_mid(key_f32(k_lo), key_f32(k_hi));
}

// the second body: keys staged once, each thread bisects its own window
__device__ void rm_bisect_body(const float* __restrict__ xr,
                               float* __restrict__ outr, long long P,
                               long long T, int window, long long i0,
                               int* seg) {
  const int seg_len = blockDim.x + window - 1;
  for (int s = threadIdx.x; s < seg_len; s += blockDim.x)
    seg[s] = rm_load_key(xr, i0 + s, P);
  __syncthreads();
  const long long i = i0 + threadIdx.x;
  if (i >= T) return;
  const int* w = seg + threadIdx.x;

  int n_nan = 0;
  for (int j = 0; j < window; ++j) n_nan += w[j] == CR_IMAX;
  if (n_nan > 0) {
    outr[i] = __int_as_float(0x7fc00000);
    return;
  }
  const int k_lo = (window - 1) / 2, k_hi = window / 2;
  int lo = INT_MIN, hi = INT_MAX;
  for (int it = 0; it < 32; ++it) {
    const int mid = bisect_mid(lo, hi);
    int c = 0;
    for (int j = 0; j < window; ++j) c += w[j] <= mid;
    if (c >= k_lo + 1) hi = mid; else lo = mid + 1;
  }
  int c_le = 0, v_next = CR_IMAX;
  for (int j = 0; j < window; ++j) {
    const int k = w[j];
    c_le += k <= lo;
    if (k > lo && k < v_next) v_next = k;
  }
  const int v_hi = c_le >= k_hi + 1 ? lo : v_next;
  outr[i] = median_mid(key_f32(lo), key_f32(v_hi));
}

// one block: blockDim.x consecutive outputs of one row
template <bool SORTED>
__global__ void __launch_bounds__(RM_OUT)
rolling_median_kernel(const float* __restrict__ x, float* __restrict__ out,
                      long long P, long long T, int window,
                      long long n_chunks, int n_sort) {
  extern __shared__ __align__(16) unsigned char rm_smem[];
  const long long row = blockIdx.x / n_chunks;
  const long long i0 = (blockIdx.x - row * n_chunks) * blockDim.x;
  if constexpr (SORTED)
    rm_sorted_body(x + row * P, out + row * T, P, T, window, i0,
                   reinterpret_cast<long long*>(rm_smem), n_sort);
  else
    rm_bisect_body(x + row * P, out + row * T, P, T, window, i0,
                   reinterpret_cast<int*>(rm_smem));
}

using rm_kernel_t = void (*)(const float*, float*, long long, long long,
                             int, long long, int);

static long long rm_pow2(long long n) {
  long long p = 1;
  while (p < n) p <<= 1;
  return p;
}

static rm_kernel_t rm_kernel(int sorted) {
  if (sorted) return rolling_median_kernel<true>;
  return rolling_median_kernel<false>;
}

static int rm_threads(int sorted) { return sorted ? RM_OUT : RM_BISECT_OUT; }

static size_t rm_smem_bytes(int window, int sorted) {
  const long long seg = (long long)rm_threads(sorted) + window - 1;
  return sorted ? sizeof(long long) * (size_t)rm_pow2(seg)
                : sizeof(int) * (size_t)seg;
}

static cudaError_t rm_prepare(int window, int sorted) {
  const size_t smem = rm_smem_bytes(window, sorted);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(rm_kernel(sorted),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// sorted: 1 for the sorted body, 0 for the bisection body
extern "C" int cr_rolling_median(const void* x, void* out, long long rows,
                                 long long P, int window, int sorted,
                                 void* stream) {
  const long long T = P - window + 1;
  cudaError_t e = rm_prepare(window, sorted);
  if (e != cudaSuccess) return (int)e;
  const int threads = rm_threads(sorted);
  const long long n_chunks = (T + threads - 1) / threads;
  const int n_sort = (int)rm_pow2((long long)threads + window - 1);
  const rm_kernel_t kern = rm_kernel(sorted);
  kern<<<(unsigned)(n_chunks * rows), threads, rm_smem_bytes(window, sorted),
         (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, P, T, window, n_chunks, n_sort);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of one launch; a CUDA error is returned negated.
extern "C" int cr_rolling_median_occupancy(int window, int sorted) {
  cudaError_t e = rm_prepare(window, sorted);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, rm_kernel(sorted), rm_threads(sorted),
        rm_smem_bytes(window, sorted));
  return e == cudaSuccess ? n : -(int)e;
}
