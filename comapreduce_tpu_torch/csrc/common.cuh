// Shared device helpers for the selection kernels: the monotone f32 ->
// signed i32 key map, the overflow-safe bisection midpoint and the
// equal-middles median midpoint.
#pragma once

#include <cuda_runtime.h>
#include <climits>

// Sentinel key above every finite (and every non-NaN) f32 key; its
// preimage is a NaN bit pattern, so no number collides with it.
#define CR_IMAX 0x7FFFFFFF

// Monotone f32 -> signed i32 key: integer order == float total order
// (-inf < negatives < -0 < +0 < positives < +inf). Same map as the TPU
// kernels' u32 key XOR 0x80000000.
__device__ __forceinline__ int f32_key(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : (i ^ 0x7FFFFFFF);
}

__device__ __forceinline__ float key_f32(int k) {
  return __int_as_float(k >= 0 ? k : (k ^ 0x7FFFFFFF));
}

// Midpoint of [lo, hi] over the full i32 range without overflow.
__device__ __forceinline__ int bisect_mid(int lo, int hi) {
  return (lo >> 1) + (hi >> 1) + (lo & hi & 1);
}

// Median of the lower/upper middle: equal middles return the ELEMENT
// (0.5 * (v + v) is not v for every f32), else 0.5 * (lo + hi) rounded
// as two separate IEEE operations (no contraction).
__device__ __forceinline__ float median_mid(float lo, float hi) {
  return lo == hi ? lo : __fmul_rn(0.5f, __fadd_rn(lo, hi));
}
