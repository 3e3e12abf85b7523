// K1: fused masked fill — the reduction pre-filter's NaN fill.
//
// Replaces comapreduce_tpu/ops/pallas_median.py::masked_fill_pallas
// (kernel body _fill_kernel). Per row of L samples:
//   out = where(mask > 0, tod, fill)
// where ``fill`` is the exact masked median of the stride-4 subsample
// (its k_lo-th and k_hi-th smallest monotone i32 keys, then the
// equal-middles midpoint), or the row's full-length masked mean when the
// FLOAT mask sum over the stride-4 grid is 0.
//
// Bound on an H100: bytes. One launch at the main-path shape reads
// tod + mask (2 x 445 MB) and writes out (445 MB); the selection is a
// few passes over L/4 keys per row, far below the card's integer rate.
//
// Design: one block per row.
// - The row crosses device memory once. The load pass reads tod and mask
//   with 16-byte __ldg loads (FILL_UNROLL groups in flight per thread;
//   evict-first loads measured slower here), takes the mean sums, builds
//   the stride-4 keys and keeps the row on chip: tod in shared memory,
//   the mask as one bit per sample, the keys beside them (21 bytes per 4
//   samples: 70 KB at L = 13 568, so three rows are resident per SM and
//   one row's selection overlaps another's loads). The write pass selects
//   from shared memory.
// - Radix select, not bisection: the keys' 32 bits in four 8-bit
//   digits. Each pass is one shared-memory histogram (counts aggregated
//   per warp with __match_any_sync, FILL_UNROLL keys per thread loaded
//   before their counts) and one warp-level prefix that finds the digit.
//   The two order statistics descend together, in one histogram while
//   they share a prefix and in two once they part. The first digit's
//   histogram is built during the load pass, so a row takes three sweeps
//   over its keys after its loads.
// - Rows too long for that (past the wrapper's shared-memory budget) take
//   the second body, chosen by shape: the keys in a device scratch
//   buffer, the same radix select, and the row read a second time for
//   the write pass.
#include "common.cuh"

constexpr int FILL_THREADS = 256;
constexpr int FILL_UNROLL = 4;  // float4 groups a thread loads before use
constexpr int RADIX = 256;      // bins of an 8-bit digit

// Add one to hist[bin] for every lane of the warp whose bin is >= 0: one
// shared atomic per distinct bin. Every lane of the warp must call it.
__device__ __forceinline__ void warp_count(int* hist, int bin, int lane) {
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  if (bin >= 0 && lane == __ffs(peers) - 1)
    atomicAdd(hist + bin, __popc(peers));
}

// One warp finds, for nk ranks k[t] (each below the histogram's total),
// the bin of hist[0..RADIX) that holds the rank-k[t] element and k[t]'s
// rank inside it, writes them to sel[2t], sel[2t + 1], and zeroes the
// histogram for the next pass. Lane l owns bins 8l..8l+7, read and
// zeroed as two 16-byte words (no bank conflicts).
__device__ __forceinline__ void radix_digit(int* hist, int lane, int nk,
                                            const int* k, int* sel) {
  int4* h4 = reinterpret_cast<int4*>(hist) + 2 * lane;
  const int4 x = h4[0], y = h4[1];
  const int c[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  int sum = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) sum += c[q];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  for (int t = 0; t < nk; ++t) {
    int acc = incl - sum;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (k[t] >= acc && k[t] < acc + c[q]) {
        sel[2 * t] = 8 * lane + q;
        sel[2 * t + 1] = k[t] - acc;
      }
      acc += c[q];
    }
  }
  __syncwarp();
  h4[0] = h4[1] = make_int4(0, 0, 0, 0);
}

// A thread's partial sums of the load pass: valid stride-4 samples, and
// the f32 sums of tod * mask, of mask and of the stride-4 mask.
struct FillSums {
  int n;
  float tm, m, sub;
};

// The block's sums, received by every thread, behind one barrier (which
// also publishes the load pass's shared-memory writes). The warp
// partials combine in a fixed order, so the float sums are
// deterministic.
__device__ __forceinline__ FillSums block_sums(FillSums s, FillSums* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s.n += __shfl_xor_sync(0xffffffffu, s.n, o);
    s.tm += __shfl_xor_sync(0xffffffffu, s.tm, o);
    s.m += __shfl_xor_sync(0xffffffffu, s.m, o);
    s.sub += __shfl_xor_sync(0xffffffffu, s.sub, o);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  FillSums r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
    r.n += red[w].n;
    r.tm += red[w].tm;
    r.m += red[w].m;
    r.sub += red[w].sub;
  }
  return r;
}

template <bool kRowOnChip>
__global__ void __launch_bounds__(FILL_THREADS, 3)
masked_fill_kernel(const float* __restrict__ tod,
                   const float* __restrict__ mask,
                   float* __restrict__ out, int* __restrict__ gkeys,
                   long long L, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  // lower statistic's bins, then upper's
  __shared__ __align__(16) int hist[2 * RADIX];
  __shared__ int sel[4];  // digit, rank: lower, then upper
  __shared__ FillSums red[FILL_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = blockIdx.x;
  const float* t = tod + row * L;
  const float* m = mask + row * L;
  float* o = out + row * L;
  const int L4 = (int)((L + 3) / 4);
  // row on chip: tod in float4 groups, then the keys, then one byte of
  // mask bits per group (bit q: mask > 0 at sample 4j + q)
  float4* srow = reinterpret_cast<float4*>(smem);
  int* keys = kRowOnChip ? reinterpret_cast<int*>(srow + L4)
                         : gkeys + row * (long long)L4;
  unsigned char* sbits = reinterpret_cast<unsigned char*>(keys + L4);

  for (int i = threadIdx.x; i < 2 * RADIX; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  // load pass: the keys, the mean sums, the first digit's histogram and,
  // in the row-on-chip body, the row itself
  FillSums part = {0, 0.f, 0.f, 0.f};
  for (int j0 = threadIdx.x; j0 - lane < L4;
       j0 += FILL_UNROLL * blockDim.x) {
    float4 a[FILL_UNROLL], b[FILL_UNROLL];
#pragma unroll
    for (int u = 0; u < FILL_UNROLL; ++u) {
      const int j = j0 + u * blockDim.x;
      a[u] = b[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j >= L4) continue;
      if (vec) {
        a[u] = __ldg(reinterpret_cast<const float4*>(t) + j);
        b[u] = __ldg(reinterpret_cast<const float4*>(m) + j);
      } else {
        const long long i0 = 4LL * j;
        float tv[4], mv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          tv[q] = i0 + q < L ? t[i0 + q] : 0.f;
          mv[q] = i0 + q < L ? m[i0 + q] : 0.f;
        }
        a[u] = make_float4(tv[0], tv[1], tv[2], tv[3]);
        b[u] = make_float4(mv[0], mv[1], mv[2], mv[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < FILL_UNROLL; ++u) {
      const int j = j0 + u * blockDim.x;
      int bin = -1;
      if (j < L4) {
        const float tv[4] = {a[u].x, a[u].y, a[u].z, a[u].w};
        const float mv[4] = {b[u].x, b[u].y, b[u].z, b[u].w};
        const bool valid = mv[0] > 0.f;
        const int key = valid ? f32_key(tv[0]) : CR_IMAX;
        keys[j] = key;
        bin = (int)(((unsigned)key ^ 0x80000000u) >> 24);
        part.n += valid;
        part.sub = __fadd_rn(part.sub, mv[0]);
        unsigned bits = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          part.tm = __fadd_rn(part.tm, __fmul_rn(tv[q], mv[q]));
          part.m = __fadd_rn(part.m, mv[q]);
          bits |= (unsigned)(mv[q] > 0.f) << q;
        }
        if (kRowOnChip) {
          srow[j] = a[u];
          sbits[j] = (unsigned char)bits;
        }
      }
      warp_count(hist, bin, lane);
    }
  }
  // (its barrier also publishes the keys, the row and the first
  // histogram)
  const FillSums sums = block_sums(part, red);
  const int n_sub = sums.n;

  // radix select of the k_lo-th and k_hi-th smallest key (invalid slots
  // hold CR_IMAX, above every valid key) on u = key ^ 0x80000000, whose
  // unsigned order is the keys' signed order; pref[s] holds the digits
  // found so far, zeros below them
  const int cnt = n_sub > 1 ? n_sub : 1;
  int k[2] = {(cnt - 1) / 2, cnt / 2};
  unsigned pref[2] = {0u, 0u};
  for (int shift = 24; shift >= 0; shift -= 8) {
    const bool same = pref[0] == pref[1];
    if (shift < 24) {
      // histogram of the next digit over each statistic's bucket,
      // FILL_UNROLL keys loaded before their counts
      const int hs = shift + 8;
      for (int j0 = threadIdx.x; j0 - lane < L4;
           j0 += FILL_UNROLL * blockDim.x) {
        int bin[FILL_UNROLL];
#pragma unroll
        for (int u = 0; u < FILL_UNROLL; ++u) {
          const int j = j0 + u * blockDim.x;
          bin[u] = -1;
          if (j < L4) {
            const unsigned v = (unsigned)keys[j] ^ 0x80000000u;
            const int d = (int)((v >> shift) & 255u);
            if ((v >> hs) == (pref[0] >> hs))
              bin[u] = d;
            else if ((v >> hs) == (pref[1] >> hs))
              bin[u] = RADIX + d;
          }
        }
#pragma unroll
        for (int u = 0; u < FILL_UNROLL; ++u) warp_count(hist, bin[u], lane);
      }
      __syncthreads();
    }
    if (warp == 0)
      radix_digit(hist, lane, same ? 2 : 1, k, sel);
    else if (warp == 1 && !same)
      radix_digit(hist + RADIX, lane, 1, k + 1, sel + 2);
    __syncthreads();
    pref[0] |= (unsigned)sel[0] << shift;
    k[0] = sel[1];
    pref[1] |= (unsigned)sel[2] << shift;
    k[1] = sel[3];
  }
  const int v_lo = (int)(pref[0] ^ 0x80000000u);
  const int v_hi = (int)(pref[1] ^ 0x80000000u);
  const float med = n_sub > 0 ? median_mid(key_f32(v_lo), key_f32(v_hi))
                              : 0.f;
  const float mean = __fdiv_rn(sums.tm, fmaxf(sums.m, 1.f));
  const float fill = sums.sub > 0.f ? med : mean;

  // write pass (masked-in samples, NaN included, pass through)
  if (kRowOnChip) {
    if (vec) {
      for (int j = threadIdx.x; j < L4; j += blockDim.x) {
        const float4 a = srow[j];
        const unsigned bits = sbits[j];
        float4 r;
        r.x = bits & 1u ? a.x : fill;
        r.y = bits & 2u ? a.y : fill;
        r.z = bits & 4u ? a.z : fill;
        r.w = bits & 8u ? a.w : fill;
        reinterpret_cast<float4*>(o)[j] = r;
      }
    } else {
      const float* sr = reinterpret_cast<const float*>(srow);
      for (long long i = threadIdx.x; i < L; i += blockDim.x)
        o[i] = sbits[i >> 2] >> (i & 3) & 1u ? sr[i] : fill;
    }
  } else if (vec) {
    for (int j = threadIdx.x; j < L4; j += blockDim.x) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(t) + j);
      const float4 b = __ldg(reinterpret_cast<const float4*>(m) + j);
      float4 r;
      r.x = b.x > 0.f ? a.x : fill;
      r.y = b.y > 0.f ? a.y : fill;
      r.z = b.z > 0.f ? a.z : fill;
      r.w = b.w > 0.f ? a.w : fill;
      reinterpret_cast<float4*>(o)[j] = r;
    }
  } else {
    for (long long i = threadIdx.x; i < L; i += blockDim.x)
      o[i] = m[i] > 0.f ? t[i] : fill;
  }
}

// Dynamic shared memory of the row-on-chip body: tod, keys and mask bits,
// 21 bytes per 4 samples (the second body takes none).
static size_t fill_smem(long long L, int row_on_chip) {
  return row_on_chip ? 21 * (size_t)((L + 3) / 4) : 0;
}

static const void* fill_kernel(int row_on_chip) {
  return row_on_chip ? (const void*)masked_fill_kernel<true>
                     : (const void*)masked_fill_kernel<false>;
}

static cudaError_t fill_prepare(long long L, int row_on_chip) {
  const size_t smem = fill_smem(L, row_on_chip);
  if (smem <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      fill_kernel(row_on_chip), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  // the whole unified L1 / shared array as shared memory
  return cudaFuncSetAttribute(fill_kernel(row_on_chip),
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

extern "C" int cr_masked_fill(const void* tod, const void* mask, void* out,
                              void* gkeys, long long rows, long long L,
                              int row_on_chip, int vec, void* stream) {
  const cudaError_t e = fill_prepare(L, row_on_chip);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = fill_smem(L, row_on_chip);
  if (row_on_chip)
    masked_fill_kernel<true><<<(unsigned)rows, FILL_THREADS, smem,
                               (cudaStream_t)stream>>>(
        (const float*)tod, (const float*)mask, (float*)out, (int*)gkeys, L,
        vec);
  else
    masked_fill_kernel<false><<<(unsigned)rows, FILL_THREADS, smem,
                                (cudaStream_t)stream>>>(
        (const float*)tod, (const float*)mask, (float*)out, (int*)gkeys, L,
        vec);
  return (int)cudaGetLastError();
}

// Resident blocks (rows) per SM for rows of length L in the given body; a
// CUDA error is returned negated.
extern "C" int cr_masked_fill_occupancy(long long L, int row_on_chip) {
  cudaError_t e = fill_prepare(L, row_on_chip);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fill_kernel(row_on_chip), FILL_THREADS,
        fill_smem(L, row_on_chip));
  return e == cudaSuccess ? n : -(int)e;
}
