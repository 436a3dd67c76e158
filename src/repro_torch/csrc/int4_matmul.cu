// K3: packed-int4 weight matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/int4_matmul.py::_int4_kernel
// (built by int4_matmul_pallas): out = (x @ W) * scale, x (M, K) float32 or
// bf16, W (K, N) held as (K, N/2) bytes of two 4-bit codes (hi nibble = even
// column, lo nibble = odd column, code = value + 8).  The codes are unpacked
// and dequantized inside the tile, products accumulate in float32, the sum is
// rounded to x's type and then multiplied by the per-tensor scale in x's type
// (the reference's `out * jnp.asarray(scale, x.dtype)`, fused here so the
// output is written once).  The scale is read from device memory, so the
// caller never synchronises to pass it.
//
// Bound: on the predictor's path K is 12 or 48 (the simplified predictor's
// widths), so x @ W does 2*K FLOP per output element against 4 bytes written
// (float32): under 25 FLOP/byte, bytes bound.  The classification head
// (M = 4096, N = n_classes up to 20,000) writes 327.7 MB and dominates.  One
// block computes a 32 x 128 output tile with 256 threads, 4 x 4 outputs each;
// a warp's 32 threads own 32 consecutive columns, so every store of a row is
// one 128-byte line.  K runs in tiles of 32 through shared memory (x as
// float32, the codes dequantized to float32).  No tensor cores: K is below a
// wgmma tile's useful depth on the path, and a simple kernel that is right
// comes first.
//
// Any M, K >= 1 and any even N; the ragged tiles are masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define BM 32
#define BN 128
#define BK 32
#define THREADS 256   // 32 x 8: thread (tx, ty) owns rows ty*4+i, columns
                      // tx + 32*j (i, j < 4)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void int4_matmul_kernel(const T* __restrict__ x,
                                   const uint8_t* __restrict__ w,
                                   const float* __restrict__ scale,
                                   T* __restrict__ out, int m, int kdim,
                                   int n) {
  __shared__ float sX[BM][BK + 1];
  __shared__ float sW[BK][BN];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int half = n / 2;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = m0 + r, gc = k0 + c;
      sX[r][c] = (gr < m && gc < kdim) ? to_f32(x[(size_t)gr * kdim + gc])
                                       : 0.f;
    }
    // one byte -> two columns: (BN / 2) bytes per K row
    for (int e = threadIdx.x; e < BK * (BN / 2); e += THREADS) {
      const int r = e / (BN / 2), c = e % (BN / 2);
      const int gr = k0 + r, gb = n0 / 2 + c;
      float hi = 0.f, lo = 0.f;
      if (gr < kdim && gb < half) {
        const uint8_t byte = w[(size_t)gr * half + gb];
        hi = (float)((int)(byte >> 4) - 8);
        lo = (float)((int)(byte & 0xF) - 8);
      }
      sW[r][2 * c] = hi;
      sW[r][2 * c + 1] = lo;
    }
    __syncthreads();
    const int kk_end = min(BK, kdim - k0);
    for (int kk = 0; kk < kk_end; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sX[ty * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sW[kk][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  const T s = from_f32<T>(*scale);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = m0 + ty * 4 + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = n0 + tx + 32 * j;
      if (gc < n)
        out[(size_t)gr * n + gc] =
            from_f32<T>(to_f32(from_f32<T>(acc[i][j])) * to_f32(s));
    }
  }
}

template <typename T>
static int launch(const void* x, const uint8_t* w, const float* scale,
                  void* out, int m, int kdim, int n, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaSuccess;
  if (kdim <= 0 || n % 2 != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  int4_matmul_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, w, scale, (T*)out, m, kdim, n);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (x and out); scale: one float32 on the
// device
extern "C" int int4_matmul_launch(const void* x, const void* w,
                                  const void* scale, void* out, int m,
                                  int kdim, int n, int dtype, void* stream) {
  if (dtype == 0)
    return launch<float>(x, (const uint8_t*)w, (const float*)scale, out, m,
                         kdim, n, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, (const uint8_t*)w, (const float*)scale,
                                 out, m, kdim, n, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
