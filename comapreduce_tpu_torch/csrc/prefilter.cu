// K5: the reduction's atmosphere fit and radiometer normalisation, fused
// — the field branch of the pre-filter after the NaN fill (K1).
//
// Replaces no Pallas kernel: it stands for XLA's fusion of the reference's
// comapreduce_tpu/ops/reduce.py::_prefilter_chain (the elementwise and
// reduction math after the fill, which the TPU compiles into a few
// passes; eager PyTorch ran it as ~35 generic kernels over the block).
// Per row (scan, band, channel) of L samples, with d the filled counts,
// m the mask weights and a the scan's airmass:
//   cnt = sum m; a_mean = sum m a / max(cnt, 1); d_mean likewise
//   saa = sum m (a - a_mean)^2; sad = sum m (a - a_mean)(d - d_mean)
//   slope = sad / max(saa, 1e-12) if cnt >= 2 and saa > 1e-12, else 0
//   offset = d_mean - slope a_mean
//   pairs j < L / 4: diff = (d[4j] - d[4j+2]) - slope (a[4j] - a[4j+2]),
//   weight m[4j] m[4j+2]; rms = their masked two-pass std / sqrt(2)
//   norm = rms sqrt(bandwidth tau)
//   clean = norm > 0 ? (d - (offset + slope a)) / max(norm, 1e-30) : 0
// Every product, sum and quotient is one IEEE f32 operation in the order
// the plain version (ops/prefilter.py::prefilter_plain) takes them, so
// nothing is contracted into an FMA; only the summation order differs.
//
// Bound on an H100: bytes. One launch at the main path's scan-batch block
// (8 192 rows x 13 568) reads d and m (2 x 445 MB) and writes clean
// (445 MB): 0.398 ms at 3.35 TB/s. The arithmetic is ~20 operations a
// sample, far below the card's rate.
//
// Design: one block a row, and the row crosses device memory once.
// - The load issues the whole row at once as 16-byte cp.async copies
//   straight into shared memory (d, then m, f32: the mask's values are
//   weights in the fit), 32 bytes a group of four samples: 108.5 KB at
//   L = 13 568, so two rows are resident per SM and one row's passes
//   overlap the other's loads. Each thread owns the same groups of four
//   in every pass and reads no other thread's, so no barrier follows the
//   load: its copies come in two commit groups, and the fit's first pass
//   starts on the first while the second is in flight.
// - The fit's two passes, the pair std's two passes and the write pass
//   then run over shared memory. The fit's second pass stores each
//   group's pair weight and airmass difference over its mask slots, so
//   the std's passes read no airmass. The airmass row (shared by every
//   row of its scan) is read three times a row, from L2, PF_UNROLL groups
//   a thread in flight before their use (one at a time, with one commit
//   group, left the passes waiting: 0.602 ms a launch at the main path's
//   shape against 0.510 ms, H100 80GB HBM3 at 700 W).
// - clean is written once; offset, slope and norm once a row.
// - Sums add in a fixed order: each thread over its groups in turn, the
//   warp by a butterfly (every lane the same bits), the warps in order.
//   No atomics: a row's result depends on that row alone, whatever the
//   launch, the row count or the body.
// - Rows past the wrapper's shared-memory budget take the second body,
//   chosen by shape: the same passes over device memory (the row read
//   again in each), the same arithmetic and order, so the same bits.
#include <cuda_runtime.h>

constexpr int PF_THREADS = 512;
constexpr int PF_WARPS = PF_THREADS / 32;
constexpr int PF_UNROLL = 4;  // airmass groups a thread loads before use

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;  // NaN passes through, as torch.clamp
}

// One group of four samples of a row in device memory; samples past L
// read 0 (they are skipped in every pass).
__device__ __forceinline__ float4 load_group(const float* x, int j,
                                             long long L, int vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(x) + j);
  const long long i = 4LL * j;
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = i + q < L ? __ldg(x + i + q) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for the thread's copies but the newest N groups.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block's sums of N per-thread partials, received by every thread
// behind one barrier; ``red`` is this reduction's own buffer.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N],
                                          float (*red)[PF_WARPS]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k)
      v[k] = __fadd_rn(v[k], __shfl_xor_sync(0xffffffffu, v[k], o));
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) red[k][threadIdx.x >> 5] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = red[k][0];
    for (int w = 1; w < PF_WARPS; ++w) s = __fadd_rn(s, red[k][w]);
    v[k] = s;
  }
}

template <bool kOnChip>
__global__ void __launch_bounds__(PF_THREADS, 2)
prefilter_kernel(const float* __restrict__ d, const float* __restrict__ m,
                 const float* __restrict__ a, float* __restrict__ clean,
                 float* __restrict__ stats, long long rows, long long L,
                 long long rows_per_a, float sqrt2, float sqrt_bt,
                 int vec) {
  extern __shared__ __align__(16) float4 srow[];
  __shared__ float red[4][3][PF_WARPS];
  const long long row = blockIdx.x;
  const float* dr = d + row * L;
  const float* mr = m + row * L;
  const float* ar = a + (row / rows_per_a) * L;
  float* cr = clean + row * L;
  const int L4 = (int)((L + 3) / 4);  // groups of four
  const int P = (int)(L / 4);         // pairs: the full groups
  const int tid = threadIdx.x;
  // the on-chip row: d's groups, then m's (from the fit's second pass on,
  // a full group's m slot holds its pair weight and airmass difference)
  float4* sd = srow;
  float4* sm = srow + L4;

  // A thread reads only the groups it loads (j = tid + k PF_THREADS, its
  // k-th), so no barrier stands between the load and the passes: the
  // copies come in two commit groups, the first PF_UNROLL groups and the
  // rest, and the fit's first pass waits for each before its groups.
  const int K = tid < L4 ? (L4 - 1 - tid) / PF_THREADS + 1 : 0;
  const int Kh = K < PF_UNROLL ? K : PF_UNROLL;
  const bool async = kOnChip && vec;
  if (kOnChip) {
    for (int k = 0; k < K; ++k) {
      const int j = tid + k * PF_THREADS;
      if (vec) {
        cp_async16(sd + j, reinterpret_cast<const float4*>(dr) + j);
        cp_async16(sm + j, reinterpret_cast<const float4*>(mr) + j);
        if (k == Kh - 1) cp_async_commit();
      } else {
        sd[j] = load_group(dr, j, L, 0);
        sm[j] = load_group(mr, j, L, 0);
      }
    }
    if (vec) cp_async_commit();
  }
  auto D = [&](int j) { return kOnChip ? sd[j] : load_group(dr, j, L, vec); };
  auto M = [&](int j) { return kOnChip ? sm[j] : load_group(mr, j, L, vec); };
  // PF_UNROLL of the thread's airmass groups from iteration k0 on, loaded
  // before any is used (they come from L2)
  auto load_a = [&](int k0, float4 (&a4)[PF_UNROLL]) {
#pragma unroll
    for (int u = 0; u < PF_UNROLL; ++u)
      a4[u] = k0 + u < K ? load_group(ar, tid + (k0 + u) * PF_THREADS, L, vec)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  // fit, pass 1: cnt, sum m a, sum m d
  float s1[3] = {0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += PF_UNROLL) {
    float4 a4[PF_UNROLL];
    load_a(k0, a4);
    if (async) {
      if (k0 + PF_UNROLL <= Kh)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
    }
#pragma unroll
    for (int u = 0; u < PF_UNROLL; ++u) {
      if (k0 + u >= K) break;
      const int j = tid + (k0 + u) * PF_THREADS;
      const float4 d4 = D(j), m4 = M(j);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
      const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
      const float av[4] = {a4[u].x, a4[u].y, a4[u].z, a4[u].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (4LL * j + q >= L) break;
        s1[0] = __fadd_rn(s1[0], mv[q]);
        s1[1] = __fadd_rn(s1[1], __fmul_rn(mv[q], av[q]));
        s1[2] = __fadd_rn(s1[2], __fmul_rn(mv[q], dv[q]));
      }
    }
  }
  block_sum<3>(s1, red[0]);
  const float cnt = s1[0];
  const float n1 = clamp_min(cnt, 1.f);
  const float a_mean = __fdiv_rn(s1[1], n1);
  const float d_mean = __fdiv_rn(s1[2], n1);

  // fit, pass 2: the centred sums saa, sad
  float s2[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += PF_UNROLL) {
    float4 a4[PF_UNROLL];
    load_a(k0, a4);
#pragma unroll
    for (int u = 0; u < PF_UNROLL; ++u) {
      if (k0 + u >= K) break;
      const int j = tid + (k0 + u) * PF_THREADS;
      const float4 d4 = D(j), m4 = M(j);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
      const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
      const float av[4] = {a4[u].x, a4[u].y, a4[u].z, a4[u].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (4LL * j + q >= L) break;
        const float da = __fsub_rn(av[q], a_mean);
        const float md = __fmul_rn(mv[q], da);
        s2[0] = __fadd_rn(s2[0], __fmul_rn(md, da));
        s2[1] = __fadd_rn(s2[1], __fmul_rn(md, __fsub_rn(dv[q], d_mean)));
      }
      if (kOnChip && j < P)
        sm[j] = make_float4(__fmul_rn(m4.x, m4.z),
                            __fsub_rn(a4[u].x, a4[u].z), 0.f, 0.f);
    }
  }
  block_sum<2>(s2, red[1]);
  const float saa = s2[0];
  const float slope = (cnt >= 2.f && saa > 1e-12f)
                          ? __fdiv_rn(s2[1], clamp_min(saa, 1e-12f))
                          : 0.f;
  const float offset = __fsub_rn(d_mean, __fmul_rn(slope, a_mean));

  // the pair differences and weights of group j < P
  auto pair = [&](int j, float& diff, float& pm) {
    const float4 d4 = D(j);
    float ad;
    if (kOnChip) {
      const float4 s = sm[j];
      pm = s.x;
      ad = s.y;
    } else {
      const float4 m4 = M(j), a4 = load_group(ar, j, L, vec);
      pm = __fmul_rn(m4.x, m4.z);
      ad = __fsub_rn(a4.x, a4.z);
    }
    diff = __fsub_rn(__fsub_rn(d4.x, d4.z), __fmul_rn(slope, ad));
  };

  // std, pass 1: sum diff pm, sum pm
  float s3[2] = {0.f, 0.f};
  for (int j = tid; j < P; j += PF_THREADS) {
    float diff, pm;
    pair(j, diff, pm);
    s3[0] = __fadd_rn(s3[0], __fmul_rn(diff, pm));
    s3[1] = __fadd_rn(s3[1], pm);
  }
  block_sum<2>(s3, red[2]);
  const float np = clamp_min(s3[1], 1.f);
  const float mu = __fdiv_rn(s3[0], np);

  // std, pass 2: sum (diff - mu)^2 pm
  float s4[1] = {0.f};
  for (int j = tid; j < P; j += PF_THREADS) {
    float diff, pm;
    pair(j, diff, pm);
    const float dv = __fsub_rn(diff, mu);
    s4[0] = __fadd_rn(s4[0], __fmul_rn(__fmul_rn(dv, dv), pm));
  }
  block_sum<1>(s4, red[3]);
  const float var = __fdiv_rn(s4[0], np);
  const float rms = __fdiv_rn(__fsqrt_rn(clamp_min(var, 0.f)), sqrt2);
  const float norm = __fmul_rn(rms, sqrt_bt);
  if (tid == 0) {
    stats[row] = offset;
    stats[rows + row] = slope;
    stats[2 * rows + row] = norm;
  }

  // write pass: clean = (d - (offset + slope a)) / max(norm, 1e-30)
  const bool pos = norm > 0.f;
  const float safe = clamp_min(norm, 1e-30f);
  for (int k0 = 0; k0 < K; k0 += PF_UNROLL) {
    float4 a4[PF_UNROLL];
    load_a(k0, a4);
#pragma unroll
    for (int u = 0; u < PF_UNROLL; ++u) {
      if (k0 + u >= K) break;
      const int j = tid + (k0 + u) * PF_THREADS;
      const float4 d4 = D(j);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
      const float av[4] = {a4[u].x, a4[u].y, a4[u].z, a4[u].w};
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o[q] = pos ? __fdiv_rn(__fsub_rn(dv[q],
                                         __fadd_rn(offset,
                                                   __fmul_rn(slope, av[q]))),
                               safe)
                   : 0.f;
      if (vec) {
        reinterpret_cast<float4*>(cr)[j] =
            make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (4LL * j + q < L) cr[4LL * j + q] = o[q];
      }
    }
  }
}

// Dynamic shared memory of the on-chip body: d and m, 32 bytes a group of
// four samples (the second body takes none).
static size_t prefilter_smem(long long L, int on_chip) {
  return on_chip ? 32 * (size_t)((L + 3) / 4) : 0;
}

static const void* prefilter_fn(int on_chip) {
  return on_chip ? (const void*)prefilter_kernel<true>
                 : (const void*)prefilter_kernel<false>;
}

static cudaError_t prefilter_prepare(long long L, int on_chip) {
  const size_t smem = prefilter_smem(L, on_chip);
  if (smem <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      prefilter_fn(on_chip), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  // the whole unified L1 / shared array as shared memory
  return cudaFuncSetAttribute(prefilter_fn(on_chip),
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// d, m, clean: f32[rows, L]; a: f32[rows / rows_per_a, L]; stats:
// f32[3, rows] (offset, slope, norm). vec: L % 4 == 0 and every pointer
// 16-byte aligned.
extern "C" int cr_prefilter(const void* d, const void* m, const void* a,
                            void* clean, void* stats, long long rows,
                            long long L, long long rows_per_a, float sqrt2,
                            float sqrt_bt, int on_chip, int vec,
                            void* stream) {
  const cudaError_t e = prefilter_prepare(L, on_chip);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = prefilter_smem(L, on_chip);
  if (on_chip)
    prefilter_kernel<true><<<(unsigned)rows, PF_THREADS, smem,
                             (cudaStream_t)stream>>>(
        (const float*)d, (const float*)m, (const float*)a, (float*)clean,
        (float*)stats, rows, L, rows_per_a, sqrt2, sqrt_bt, vec);
  else
    prefilter_kernel<false><<<(unsigned)rows, PF_THREADS, smem,
                              (cudaStream_t)stream>>>(
        (const float*)d, (const float*)m, (const float*)a, (float*)clean,
        (float*)stats, rows, L, rows_per_a, sqrt2, sqrt_bt, vec);
  return (int)cudaGetLastError();
}

// Resident blocks (rows) per SM for rows of length L in the given body; a
// CUDA error is returned negated.
extern "C" int cr_prefilter_occupancy(long long L, int on_chip) {
  cudaError_t e = prefilter_prepare(L, on_chip);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, prefilter_fn(on_chip), PF_THREADS, prefilter_smem(L, on_chip));
  return e == cudaSuccess ? n : -(int)e;
}
