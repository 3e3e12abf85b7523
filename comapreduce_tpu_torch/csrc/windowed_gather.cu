// K4: windowed gather — the offset-order coefficient reads of the joint
// [offsets; ground] CG matvec.
//
// Replaces comapreduce_tpu/mapmaking/pallas_binning.py::
// windowed_gather_pallas (kernel body _gather_kernel):
//   out[r, e] = src[r, ids[e]]
// for plan-sorted ids. With b_c = clip(base[c], 0, S) for the chunk c of
// element e, the element reads its source only if b_c <= ids[e] <
// b_c + window and ids[e] < S; every other element (plan sentinels)
// reads 0.0. The R leading rows share the ids.
//
// Bound on an H100: bytes (ids M i32 and base M/chunk i32 read once, out
// R x M f32 written once, the distinct source words read: at most
// R x S f32). The TPU kernel DMA'd one source window per chunk into VMEM
// and selected with a one-hot MXU product; here nothing is staged.
// Design: a thread takes four consecutive elements — one 16-byte load of
// their ids, and per row four plain loads of the source through the
// read-only cache (neighbouring elements of a sorted chunk read the same
// or neighbouring words, so the loads coalesce) and one 16-byte store —
// and writes every row from that one read of ids, so R rows cost one
// pass over ids (the ground solve gathers its two coefficient rows in
// one launch). Index math is 32-bit: one unsigned division per four
// elements finds the chunk (a chunk that is a multiple of 1024 holds
// whole blocks, so a block's warps all read one window start). Chunks
// that are not a multiple of 4, or ids / out not 16-byte aligned, take
// the scalar body (one element per thread), chosen by shape. The value
// is copied, never combined with anything, so both bodies are bitwise
// equal to the plain version.
#include <cuda_runtime.h>

constexpr int WG_THREADS = 256;

__device__ __forceinline__ bool wg_in(int id, int b, int window, int S) {
  // id - b cannot overflow: b is in [0, S] and id >= b is tested first
  return id >= b && id - b < window && id < S;
}

__device__ __forceinline__ int wg_start(const int* __restrict__ base,
                                        unsigned e, unsigned chunk, int S) {
  const int b = __ldg(&base[e / chunk]);
  return b < 0 ? 0 : (b > S ? S : b);
}

// 8 resident blocks (2048 threads) per SM: without the bound the
// four-element body takes 62 registers and 4 blocks, and keeps half as
// many loads in flight
template <bool VEC>
__global__ void __launch_bounds__(WG_THREADS, 8)
windowed_gather_kernel(const float* __restrict__ src,
                       const int* __restrict__ ids,
                       const int* __restrict__ base,
                       float* __restrict__ out, int M, int R, int S,
                       int window, int chunk) {
  // unsigned: the tail block's t and 4t pass M before the bound test,
  // and stay below 2**32 for every M < 2**31
  const unsigned t = blockIdx.x * WG_THREADS + threadIdx.x;
  if constexpr (VEC) {
    const unsigned e = 4 * t;
    if (e >= (unsigned)M) return;
    const int b = wg_start(base, e, chunk, S);
    const int4 id = __ldg(reinterpret_cast<const int4*>(ids + e));
    const bool in0 = wg_in(id.x, b, window, S),
               in1 = wg_in(id.y, b, window, S),
               in2 = wg_in(id.z, b, window, S),
               in3 = wg_in(id.w, b, window, S);
    for (int r = 0; r < R; ++r) {
      const float* s = src + (size_t)r * S;
      float4 v;
      v.x = in0 ? __ldg(s + id.x) : 0.0f;
      v.y = in1 ? __ldg(s + id.y) : 0.0f;
      v.z = in2 ? __ldg(s + id.z) : 0.0f;
      v.w = in3 ? __ldg(s + id.w) : 0.0f;
      *reinterpret_cast<float4*>(out + (size_t)r * M + e) = v;
    }
  } else {
    const unsigned e = t;
    if (e >= (unsigned)M) return;
    const int b = wg_start(base, e, chunk, S);
    const int id = __ldg(&ids[e]);
    const bool in = wg_in(id, b, window, S);
    for (int r = 0; r < R; ++r)
      out[(size_t)r * M + e] = in ? __ldg(src + (size_t)r * S + id) : 0.0f;
  }
}

// M < 2**31 (the wrapper checks); vec: 1 for four elements per thread
// (chunk % 4 == 0, ids and out 16-byte aligned), 0 for the scalar body
extern "C" int cr_windowed_gather(const void* src, const void* ids,
                                  const void* base, void* out, long long M,
                                  int R, int S, int window, int chunk,
                                  int vec, void* stream) {
  const long long per_block = (long long)WG_THREADS * (vec ? 4 : 1);
  const unsigned blocks = (unsigned)((M + per_block - 1) / per_block);
  if (vec)
    windowed_gather_kernel<true><<<blocks, WG_THREADS, 0,
                                   (cudaStream_t)stream>>>(
        (const float*)src, (const int*)ids, (const int*)base, (float*)out,
        (int)M, R, S, window, chunk);
  else
    windowed_gather_kernel<false><<<blocks, WG_THREADS, 0,
                                    (cudaStream_t)stream>>>(
        (const float*)src, (const int*)ids, (const int*)base, (float*)out,
        (int)M, R, S, window, chunk);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of one body; a CUDA error is returned negated.
extern "C" int cr_windowed_gather_occupancy(int vec) {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n,
      vec ? (const void*)windowed_gather_kernel<true>
          : (const void*)windowed_gather_kernel<false>,
      WG_THREADS, 0);
  return e == cudaSuccess ? n : -(int)e;
}
