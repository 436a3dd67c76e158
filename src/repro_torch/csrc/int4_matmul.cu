// K3: packed-int4 weight matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/int4_matmul.py::_int4_kernel
// (built by int4_matmul_pallas): out = (x @ W) * scale, x (M, K) float32 or
// bf16, W (K, N) held as (K, N/2) bytes of two 4-bit codes (hi nibble = even
// column, lo nibble = odd column, code = value + 8).  The codes are unpacked
// and dequantized on chip, products accumulate in float32 in K order, the
// sum is rounded to x's type and then multiplied by the per-tensor scale in
// x's type (the reference's `out * jnp.asarray(scale, x.dtype)`, fused here
// so the output is written once).  The scale is read from device memory, so
// the caller never synchronises to pass it.
//
// Bound: on the predictor's path K and N are 12 or 48 (the simplified
// predictor's widths) with M = 122,880 token rows, or the classification
// head (M = 4096, K = 12, N = n_classes up to 20,000).  x @ W does 2*K FLOP
// per output element against 4 bytes written (float32): under 25 FLOP/byte,
// bound by bytes everywhere; the head writes 327.7 MB.  No tensor cores: the
// float32 path stays in full float32 (TF32 would break the reference's
// tolerance at K = 128-256), and the bytes bound the path's shapes anyway.
//
// Three variants, nine compiled bodies; the wrapper picks one body from the
// shape and the pointers and passes its code (this file checks again that
// the body can compute the shape):
//   narrow  (K, N <= 64, rows of x and out whole 16-byte chunks, x and out
//           16-byte aligned): a tile of 128 (or 256) consecutive rows is
//           one contiguous span of x and one of out.  As many persistent
//           blocks of 128 threads as fit on the card walk the tiles with a
//           two-stage ring: the next tile's x span arrives by 16-byte
//           cp.async copies (into shared rows padded to an odd number of
//           chunks: no bank conflicts when each thread reads its own row)
//           while this one computes.  Each block decodes the whole weight
//           (<= 64 x 64 floats) into shared memory once; each thread
//           computes one whole output row (two where x's rows are short and
//           16 < N <= 48, so each float4 broadcast of W feeds both), stages
//           it in shared memory, and the block writes the tile flat with
//           16-byte stores.
//   wide    (N > 64, rows of out whole 16-byte chunks, K <= 32 float32 or
//           16 bf16, M <= 65535 x 32: the row tiles lie on grid.y, and a
//           larger M returns an error here): each thread owns 16 bytes of
//           output columns (4 float32 or 8 bf16) and keeps their K
//           dequantized weights in registers; a block of 256 threads walks
//           32 rows whose x values are broadcast from shared memory, and
//           every store is one 16-byte vector store (a warp writes 512
//           contiguous bytes).
//   general (anything else: the reference's K = 128-256 shapes, odd K,
//           unaligned pointers): a 32 x 128 output tile per block, K in
//           steps of 32 through shared memory, scalar loads and stores.
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
#define NARROW_THREADS 128  // threads of a narrow block
#define NARROW_MAX 64     // K and N of the narrow variant
#define WIDE_THREADS 256
#define WIDE_ROWS 32      // rows per wide block

// the bodies, in the order of the wrapper's VARIANTS: narrowN[x2] holds
// N <= NMAX output columns (x2: two rows a thread), wideK K <= KMAX
enum Variant {
  GENERAL = 0,
  NARROW16 = 1,
  NARROW32 = 2,
  NARROW32X2 = 3,
  NARROW48 = 4,
  NARROW48X2 = 5,
  NARROW64 = 6,
  WIDE16 = 7,
  WIDE32 = 8
};

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

// the reference's store: the float32 sum rounded to T, times the scale in T
template <typename T>
__device__ __forceinline__ T scaled(float acc, float s) {
  return from_f32<T>(to_f32(from_f32<T>(acc)) * s);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every committed group but the newest has landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

  const float s = to_f32(from_f32<T>(*scale));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = m0 + ty * 4 + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = n0 + tx + 32 * j;
      if (gc < n) out[(size_t)gr * n + gc] = scaled<T>(acc[i][j], s);
    }
  }
}

// narrow: NMAX >= n, a multiple of 16; kdim and n multiples of VE (the
// elements of one 16-byte chunk); each thread computes R rows (rows tid +
// NARROW_THREADS * rr of a tile), so each float4 read of W feeds 4 * R
// FMAs.  Persistent blocks walk the row tiles with a two-stage ring: the
// next tile's copies fly while this one computes.
template <typename T, int NMAX, int R>
__global__ void __launch_bounds__(NARROW_THREADS)
    int4_narrow_kernel(const T* __restrict__ x,
                       const uint8_t* __restrict__ w,
                       const float* __restrict__ scale, T* __restrict__ out,
                       int m, int kdim, int n) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int TILE = NARROW_THREADS * R;   // rows of a tile
  const int kc = kdim / VE, kcp = kc | 1;   // chunks of an x row, padded
  const int nc = n / VE, ncp = nc | 1;      // chunks of an out row, padded
  extern __shared__ uint4 smem[];
  uint4* sX = smem;                          // 2 x TILE x kcp chunks
  uint4* sO = sX + 2 * TILE * kcp;           // NARROW_THREADS x ncp chunks
  float* sW = reinterpret_cast<float*>(sO + NARROW_THREADS * ncp);  // K x N
  const int tid = threadIdx.x;
  const int tiles = (m + TILE - 1) / TILE;

  // the x rows of one tile, flat 16-byte copies into padded rows
  auto load = [&](int tile, uint4* buf) {
    const size_t row0 = (size_t)tile * TILE;
    const int rows = min(TILE, (int)(m - row0));
    const uint4* xs = reinterpret_cast<const uint4*>(x + row0 * kdim);
    for (int g = tid; g < rows * kc; g += NARROW_THREADS) {
      const int r = g / kc;
      cp_async16(buf + r * kcp + (g - r * kc), xs + g);
    }
  };
  int tile = blockIdx.x;
  load(tile, sX);
  cp_async_commit();
  // the weight: byte e holds columns 2e and 2e + 1 of the flat (K, N) W
  for (int e = tid; e < kdim * (n / 2); e += NARROW_THREADS) {
    const uint8_t byte = w[e];
    sW[2 * e] = (float)((int)(byte >> 4) - 8);
    sW[2 * e + 1] = (float)((int)(byte & 0xF) - 8);
  }
  const float s = to_f32(from_f32<T>(*scale));

  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const uint4* cur = sX + (it & 1) * TILE * kcp;
    if (tile + (int)gridDim.x < tiles)
      load(tile + gridDim.x, sX + ((it + 1) & 1) * TILE * kcp);
    cp_async_commit();
    cp_async_wait_prev();            // this tile's copies have landed
    __syncthreads();
    const size_t row0 = (size_t)tile * TILE;
    const int rows = min(TILE, (int)(m - row0));
    // rows past the tile's end compute on stale copies and store nothing
    float acc[R][NMAX];
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
#pragma unroll
      for (int j = 0; j < NMAX; ++j) acc[rr][j] = 0.f;
    for (int c = 0; c < kc; ++c) {
      float a[R][VE];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const uint4 chunk = cur[(tid + rr * NARROW_THREADS) * kcp + c];
        const T* xv = reinterpret_cast<const T*>(&chunk);
#pragma unroll
        for (int e = 0; e < VE; ++e) a[rr][e] = to_f32(xv[e]);
      }
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const float4* wr =
            reinterpret_cast<const float4*>(sW + (c * VE + e) * n);
#pragma unroll
        for (int j = 0; j < NMAX / 4; ++j) {
          if (4 * j < n) {
            const float4 b = wr[j];
#pragma unroll
            for (int rr = 0; rr < R; ++rr) {
              acc[rr][4 * j] += a[rr][e] * b.x;
              acc[rr][4 * j + 1] += a[rr][e] * b.y;
              acc[rr][4 * j + 2] += a[rr][e] * b.z;
              acc[rr][4 * j + 3] += a[rr][e] * b.w;
            }
          }
        }
      }
    }
    // out, NARROW_THREADS rows at a time: staged, then flat 16-byte stores
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      if (rr > 0) __syncthreads();   // the previous rows have left
      if (tid + rr * NARROW_THREADS < rows) {
        uint4* orow = sO + tid * ncp;
#pragma unroll
        for (int c = 0; c < NMAX / VE; ++c) {
          if (c < nc) {
            uint4 chunk;
            T* ov = reinterpret_cast<T*>(&chunk);
#pragma unroll
            for (int e = 0; e < VE; ++e)
              ov[e] = scaled<T>(acc[rr][c * VE + e], s);
            orow[c] = chunk;
          }
        }
      }
      __syncthreads();
      const int done = rr * NARROW_THREADS;
      const int part = min(NARROW_THREADS, rows - done);
      uint4* os = reinterpret_cast<uint4*>(out + (row0 + done) * n);
      for (int g = tid; g < part * nc; g += NARROW_THREADS) {
        const int r = g / nc;
        os[g] = sO[r * ncp + (g - r * nc)];
      }
    }
  }
}

// wide: kdim <= KMAX, n a multiple of CPT
template <typename T, int KMAX>
__global__ void __launch_bounds__(WIDE_THREADS)
    int4_wide_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
                     const float* __restrict__ scale, T* __restrict__ out,
                     int m, int kdim, int n) {
  constexpr int CPT = 16 / sizeof(T);       // columns per thread
  __shared__ float sX[WIDE_ROWS * KMAX];    // flat (rows, kdim)
  const int tid = threadIdx.x;
  const int c0 = (blockIdx.x * WIDE_THREADS + tid) * CPT;
  const size_t row0 = (size_t)blockIdx.y * WIDE_ROWS;
  const int rows = min(WIDE_ROWS, (int)(m - row0));
  for (int e = tid; e < rows * kdim; e += WIDE_THREADS)
    sX[e] = to_f32(x[row0 * kdim + e]);
  const int half = n / 2;
  float wr[KMAX][CPT];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
#pragma unroll
    for (int b = 0; b < CPT / 2; ++b) {
      uint8_t byte = 0x88;                   // codes of two zeros
      if (k < kdim && c0 < n) byte = w[(size_t)k * half + c0 / 2 + b];
      wr[k][2 * b] = (float)((int)(byte >> 4) - 8);
      wr[k][2 * b + 1] = (float)((int)(byte & 0xF) - 8);
    }
  }
  __syncthreads();
  if (c0 >= n) return;
  const float s = to_f32(from_f32<T>(*scale));
  T* op = out + row0 * n + c0;
  for (int r = 0; r < rows; ++r) {
    float acc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
    const float* xr = sX + r * kdim;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < kdim) {
        const float a = xr[k];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[j] += a * wr[k][j];
      }
    }
    uint4 chunk;
    T* ov = reinterpret_cast<T*>(&chunk);
#pragma unroll
    for (int j = 0; j < CPT; ++j) ov[j] = scaled<T>(acc[j], s);
    *reinterpret_cast<uint4*>(op + (size_t)r * n) = chunk;
  }
}

static bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// dynamic shared memory above 48 KB needs the kernel's opt-in, once
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes, size_t* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

// as many persistent blocks as fit on the card at once, at most one a tile
template <typename K>
static cudaError_t resident_blocks(K kernel, int threads, size_t smem,
                                   int* blocks) {
  static int sms = 0;
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (sms == 0) {
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

template <typename T, int NMAX, int R>
static int launch_narrow(const T* x, const uint8_t* w, const float* scale,
                         T* out, int m, int kdim, int n,
                         cudaStream_t stream) {
  static size_t allowed = 0;
  constexpr int VE = 16 / sizeof(T);
  if (n > NMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = 16 * (size_t)NARROW_THREADS *
                          (2 * R * (kdim / VE | 1) + (n / VE | 1)) +
                      sizeof(float) * (size_t)kdim * n;
  cudaError_t err =
      allow_smem(int4_narrow_kernel<T, NMAX, R>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  static size_t blocks_smem = 0;      // the grid of the last smem size
  static int blocks = 0;
  if (smem != blocks_smem) {
    err = resident_blocks(int4_narrow_kernel<T, NMAX, R>, NARROW_THREADS,
                          smem, &blocks);
    if (err != cudaSuccess) return (int)err;
    blocks_smem = smem;
  }
  const int tiles = (m + NARROW_THREADS * R - 1) / (NARROW_THREADS * R);
  int4_narrow_kernel<T, NMAX, R>
      <<<tiles < blocks ? tiles : blocks, NARROW_THREADS, smem, stream>>>(
          x, w, scale, out, m, kdim, n);
  return (int)cudaGetLastError();
}

template <typename T, int KMAX>
static int launch_wide(const T* x, const uint8_t* w, const float* scale,
                       T* out, int m, int kdim, int n, cudaStream_t stream) {
  constexpr int CPT = 16 / sizeof(T);
  if (kdim > KMAX) return (int)cudaErrorInvalidValue;
  dim3 grid((n / CPT + WIDE_THREADS - 1) / WIDE_THREADS,
            (m + WIDE_ROWS - 1) / WIDE_ROWS);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  int4_wide_kernel<T, KMAX><<<grid, WIDE_THREADS, 0, stream>>>(
      x, w, scale, out, m, kdim, n);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* xv, const uint8_t* w, const float* scale,
                  void* outv, int m, int kdim, int n, int variant,
                  void* stream_v) {
  if (m <= 0 || n <= 0) return (int)cudaSuccess;
  if (kdim <= 0 || n % 2 != 0) return (int)cudaErrorInvalidValue;
  const T* x = (const T*)xv;
  T* out = (T*)outv;
  cudaStream_t stream = (cudaStream_t)stream_v;
  constexpr int VE = 16 / sizeof(T);
  if (variant >= NARROW16 && variant <= NARROW64) {
    if (kdim > NARROW_MAX || kdim % VE || n % VE || !aligned16(x) ||
        !aligned16(out))
      return (int)cudaErrorInvalidValue;
#define NARROW(NMAX, R) \
  return launch_narrow<T, NMAX, R>(x, w, scale, out, m, kdim, n, stream)
    switch (variant) {
      case NARROW16: NARROW(16, 1);
      case NARROW32: NARROW(32, 1);
      case NARROW32X2: NARROW(32, 2);
      case NARROW48: NARROW(48, 1);
      case NARROW48X2: NARROW(48, 2);
      default: NARROW(64, 1);
    }
#undef NARROW
  }
  if (variant == WIDE16 || variant == WIDE32) {
    // the weights of a thread's columns stay in registers: K * CPT <= 128
    if (n % VE || kdim * VE > 128 || !aligned16(out))
      return (int)cudaErrorInvalidValue;
    if (variant == WIDE16)
      return launch_wide<T, 16>(x, w, scale, out, m, kdim, n, stream);
    if constexpr (VE == 4)                   // float32 only: K <= 32
      return launch_wide<T, 32>(x, w, scale, out, m, kdim, n, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (variant != GENERAL) return (int)cudaErrorInvalidValue;
  dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  int4_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(x, w, scale, out, m,
                                                      kdim, n);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (x and out); scale: one float32 on the
// device; variant: a body of enum Variant
extern "C" int int4_matmul_launch(const void* x, const void* w,
                                  const void* scale, void* out, int m,
                                  int kdim, int n, int dtype, int variant,
                                  void* stream) {
  if (dtype == 0)
    return launch<float>(x, (const uint8_t*)w, (const float*)scale, out, m,
                         kdim, n, variant, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, (const uint8_t*)w, (const float*)scale,
                                 out, m, kdim, n, variant, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
