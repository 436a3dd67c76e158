// K2: HLSH masked attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hlsh_attention.py::_hlsh_kernel
// (built by hlsh_attention_pallas): softmax((q*keep)(k*keep)^T / sqrt(D)) v
// per batch row, q, k, v (B, N, D) and keep (B, N) in one type (float32 or
// bf16), float32 arithmetic, the output in the inputs' type.  An erased key
// needs no dot product: its logit is exactly 0 for every query, so a row
// whose keys are all erased is the mean of v.  The share map (output row
// gather) stays in the Python wrapper.
//
// Bound: on the predictor's path (B = 4096 rows, N = 30, D = 12, float32)
// the work is ~4*N*N*D = 43 kFLOP per row against 4*N*D*4 + N*4 = 5.9 kB
// moved, about 7 FLOP/byte, below the card's float32 ridge (67 TFLOP/s over
// 3.35 TB/s, about 20 FLOP/byte): bound by bytes moved.  No tensor cores
// (D = 12 is below a wgmma tile's depth).
//
// Two tilings; the wrapper picks one (hlsh_geometry) and this file checks
// it.
//   A warp per row (N <= 32, D <= 64: the path's N = 30, D = 12): one warp
//     owns a batch row; several warps share a block with no barrier between
//     them.  The row's q, k and v are each one contiguous span of N*D
//     elements, staged flat in shared memory as float32: float32 by 16-byte
//     cp.async (8- or 4-byte where the span is not 16-byte aligned), all in
//     flight at once; bf16 by 16-byte loads converted in registers (4- or
//     2-byte where unaligned).  keep is applied once: lane i holds query i's
//     keep-masked row in registers, and lane j scales key row j in shared
//     memory.  Each lane then reads every key row and every value row as a
//     shared-memory broadcast (float4 where D is a multiple of 4), so no
//     bank conflicts arise, and computes its whole row of N logits and the
//     softmax in one pass in registers, then its output row.  Erased keys
//     (a warp-uniform branch) skip their dot products.  The output goes
//     through shared memory and leaves as flat 16-byte stores.
//   General (anything larger: the reference's N up to 512, D up to 128):
//     one block of 128 threads per (batch row, query tile of 32) stages its
//     tiles in shared memory by scalar loads and runs the online softmax
//     over key tiles of 32; a key tile whose keys are all erased adds
//     exp(-m) * n_keys to the denominator and exp(-m) * sum(v) to the
//     numerator without any dot product.
//
// Any N, any D up to 128.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define TQ 32        // general: query rows per block
#define TK 32        // general: keys per tile
#define THREADS 128  // general: >= TK, one thread per key for the kept count
#define MAX_D 128
#define WARP_N 32          // a warp's row: queries and keys, at most
#define WARP_MAX_D 64
#define WARP_MAX_ROWS 8    // rows (warps) of a block
#define WARP_SMEM (48 * 1024)
#define LOG2E 1.4426950408889634f
#define FULL 0xffffffffu

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
__global__ void hlsh_general_kernel(const T* __restrict__ q,
                                      const T* __restrict__ k,
                                      const T* __restrict__ v,
                                      const T* __restrict__ keep,
                                      T* __restrict__ out,
                                      int n, int d, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;              // TQ x d, keep-masked
  float* sK = sQ + TQ * d;       // TK x d, keep-masked
  float* sV = sK + TK * d;       // TK x d
  float* sS = sV + TK * d;       // TQ x TK logits, then probabilities
  float* sAcc = sS + TQ * TK;    // TQ x d numerator
  __shared__ float sM[TQ], sL[TQ], sAlpha[TQ], sW[TQ];

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int q0 = blockIdx.y * TQ;
  const size_t row0 = (size_t)b * n;
  const T* qb = q + row0 * d;
  const T* kb = k + row0 * d;
  const T* vb = v + row0 * d;
  const T* keepb = keep + row0;

  for (int e = tid; e < TQ * d; e += THREADS) {
    const int i = e / d, qi = q0 + i;
    sQ[e] = qi < n ? to_f32(qb[(size_t)qi * d + e % d]) * to_f32(keepb[qi])
                    : 0.f;
    sAcc[e] = 0.f;
  }
  if (tid < TQ) {
    sM[tid] = 0.f;   // zero logits always exist (every erased key is one)
    sL[tid] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < n; k0 += TK) {
    const int nk = min(TK, n - k0);
    const int kept =
        __syncthreads_count(tid < nk && to_f32(keepb[k0 + tid]) != 0.f);
    for (int e = tid; e < nk * d; e += THREADS) {
      const int j = e / d;
      const size_t src = (size_t)(k0 + j) * d + e % d;
      sV[e] = to_f32(vb[src]);
      if (kept) sK[e] = to_f32(kb[src]) * to_f32(keepb[k0 + j]);
    }
    __syncthreads();
    if (kept > 0) {
      for (int e = tid; e < TQ * TK; e += THREADS) {
        const int i = e / TK, j = e % TK;
        float s = -INFINITY;
        if (j < nk) {
          float acc = 0.f;
          for (int c = 0; c < d; ++c) acc += sQ[i * d + c] * sK[j * d + c];
          s = acc * scale;
        }
        sS[e] = s;
      }
      __syncthreads();
      if (tid < TQ) {
        float* srow = sS + tid * TK;
        float m_new = sM[tid];
        for (int j = 0; j < nk; ++j) m_new = fmaxf(m_new, srow[j]);
        float sum = 0.f;
        for (int j = 0; j < nk; ++j) {
          const float p = expf(srow[j] - m_new);
          srow[j] = p;
          sum += p;
        }
        const float alpha = expf(sM[tid] - m_new);
        sL[tid] = alpha * sL[tid] + sum;
        sM[tid] = m_new;
        sAlpha[tid] = alpha;
      }
      __syncthreads();
      for (int e = tid; e < TQ * d; e += THREADS) {
        const int i = e / d, c = e % d;
        const float* prow = sS + i * TK;
        float acc = sAcc[e] * sAlpha[i];
        for (int j = 0; j < nk; ++j) acc += prow[j] * sV[j * d + c];
        sAcc[e] = acc;
      }
    } else {
      // every key of the tile is erased: all its logits are exactly 0
      if (tid < TQ) {
        const float m_new = fmaxf(sM[tid], 0.f);
        const float alpha = expf(sM[tid] - m_new);
        const float w = expf(-m_new);
        sL[tid] = alpha * sL[tid] + w * (float)nk;
        sM[tid] = m_new;
        sAlpha[tid] = alpha;
        sW[tid] = w;
      }
      __syncthreads();
      for (int e = tid; e < TQ * d; e += THREADS) {
        const int i = e / d, c = e % d;
        float vsum = 0.f;
        for (int j = 0; j < nk; ++j) vsum += sV[j * d + c];
        sAcc[e] = sAcc[e] * sAlpha[i] + sW[i] * vsum;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < TQ * d; e += THREADS) {
    const int i = e / d, qi = q0 + i;
    if (qi < n)
      out[(row0 + qi) * d + e % d] =
          from_f32<T>(sAcc[e] / fmaxf(sL[i], 1e-30f));
  }
}

// ---- a warp per row ------------------------------------------------------

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// n float32 elements from src to the 16-byte aligned shared dst, flat: the
// widest copies the source's alignment allows, all of the warp's in flight
// (the caller waits)
__device__ void stage_row(const float* __restrict__ src, int n,
                          float* __restrict__ dst, int lane) {
  const uintptr_t a = (uintptr_t)src;
  const int w = (a & 15) == 0 ? 4 : (a & 7) == 0 ? 2 : 1;
  const int nv = n / w;
  for (int i = lane; i < nv; i += 32) cp_async(dst + w * i, src + w * i, 4 * w);
  for (int e = nv * w + lane; e < n; e += 32) cp_async(dst + e, src + e, 4);
}

// bf16: 16-byte loads (4- or 2-byte where the source is not 16-byte
// aligned) converted to float32 in registers
__device__ void stage_row(const __nv_bfloat16* __restrict__ src, int n,
                          float* __restrict__ dst, int lane) {
  const uintptr_t a = (uintptr_t)src;
  int done = 0;
  if ((a & 15) == 0) {
    const int nv = n / 8;
    for (int i = lane; i < nv; i += 32) {
      const uint4 c = reinterpret_cast<const uint4*>(src)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&c);
      float4* d4 = reinterpret_cast<float4*>(dst + 8 * i);
      const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
      const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
      d4[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
      d4[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
    done = nv * 8;
  } else if ((a & 3) == 0) {
    const int nv = n / 2;
    for (int i = lane; i < nv; i += 32)
      reinterpret_cast<float2*>(dst)[i] = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(src)[i]);
    done = nv * 2;
  }
  for (int e = done + lane; e < n; e += 32) dst[e] = to_f32(src[e]);
}

// n elements from shared src (16-byte aligned) to dst: 16-byte stores
// where dst is 16-byte aligned, else element by element
template <typename T>
__device__ void copy_out(const T* __restrict__ src, T* __restrict__ dst,
                         int n, int lane) {
  constexpr int VE = 16 / sizeof(T);
  int done = 0;
  if (((uintptr_t)dst & 15) == 0) {
    const int nv = n / VE;
    for (int i = lane; i < nv; i += 32)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    done = nv * VE;
  }
  for (int e = done + lane; e < n; e += 32) dst[e] = src[e];
}

// floats of one row's span in shared memory (q, k and v have one each)
__host__ __device__ __forceinline__ int row_span(int n, int d) {
  return (n * d + 3) & ~3;
}

// One warp per batch row (N <= WARP_N, D <= DMAX).  Lane i owns query i: its
// keep-masked q row in registers, its N logits in registers (log2 domain),
// the softmax over them in one pass, then its output row.  V4: D is a
// multiple of 4, so key and value rows are read as float4 broadcasts.
template <typename T, int DMAX, bool V4>
__global__ void __launch_bounds__(32 * WARP_MAX_ROWS)
    hlsh_warp_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ keep,
                     T* __restrict__ out, int b, int n, int d,
                     float scale_log2) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= b) return;            // the whole warp: no block barrier here
  const int nd = n * d, span = row_span(n, d);
  float* sQ = reinterpret_cast<float*>(smem4) + (size_t)warp * 3 * span;
  float* sK = sQ + span;
  float* sV = sK + span;
  const size_t off = (size_t)row * nd;
  stage_row(q + off, nd, sQ, lane);
  stage_row(k + off, nd, sK, lane);
  stage_row(v + off, nd, sV, lane);
  const float kp = lane < n ? to_f32(keep[(size_t)row * n + lane]) : 0.f;
  cp_async_wait_all();
  __syncwarp();

  // query `lane`, keep-masked, in registers (zero past the row's N)
  float qr[DMAX];
#pragma unroll
  for (int c = 0; c < DMAX; ++c)
    qr[c] = lane < n && c < d ? sQ[lane * d + c] * kp : 0.f;
  if (lane < n)                    // key `lane`, keep-masked in place
    for (int c = 0; c < d; ++c) sK[lane * d + c] *= kp;
  const unsigned kept = __ballot_sync(FULL, kp != 0.f);
  __syncwarp();

  float s[WARP_N];
#pragma unroll
  for (int j = 0; j < WARP_N; ++j) {
    float acc = 0.f;               // an erased key: exactly 0
    if ((kept >> j) & 1u) {        // warp-uniform
      const float* kr = sK + j * d;
      if constexpr (V4) {
#pragma unroll
        for (int c = 0; c < DMAX; c += 4) {
          if (c < d) {
            const float4 kv = *reinterpret_cast<const float4*>(kr + c);
            acc = fmaf(qr[c], kv.x, acc);
            acc = fmaf(qr[c + 1], kv.y, acc);
            acc = fmaf(qr[c + 2], kv.z, acc);
            acc = fmaf(qr[c + 3], kv.w, acc);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < DMAX; ++c)
          if (c < d) acc = fmaf(qr[c], kr[c], acc);
      }
    }
    s[j] = acc * scale_log2;
  }
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < WARP_N; ++j)
    if (j < n) mx = fmaxf(mx, s[j]);
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < WARP_N; ++j) {
    s[j] = j < n ? exp2f(s[j] - mx) : 0.f;
    l += s[j];
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);

  float o[DMAX];
#pragma unroll
  for (int c = 0; c < DMAX; ++c) o[c] = 0.f;
#pragma unroll
  for (int j = 0; j < WARP_N; ++j) {
    if (j < n) {                   // warp-uniform
      const float p = s[j];
      const float* vr = sV + j * d;
      if constexpr (V4) {
#pragma unroll
        for (int c = 0; c < DMAX; c += 4) {
          if (c < d) {
            const float4 vv = *reinterpret_cast<const float4*>(vr + c);
            o[c] = fmaf(p, vv.x, o[c]);
            o[c + 1] = fmaf(p, vv.y, o[c + 1]);
            o[c + 2] = fmaf(p, vv.z, o[c + 2]);
            o[c + 3] = fmaf(p, vv.w, o[c + 3]);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < DMAX; ++c)
          if (c < d) o[c] = fmaf(p, vr[c], o[c]);
      }
    }
  }
  // Q is in registers: its span takes the flat output row
  T* sO = reinterpret_cast<T*>(sQ);
  if (lane < n) {
#pragma unroll
    for (int c = 0; c < DMAX; ++c)
      if (c < d) sO[lane * d + c] = from_f32<T>(o[c] * inv);
  }
  __syncwarp();
  copy_out<T>(sO, out + off, nd, lane);
}

template <typename T, int DMAX, bool V4>
static int launch_warp_t(const void* q, const void* k, const void* v,
                         const void* keep, void* out, int b, int n, int d,
                         int rows, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * (size_t)row_span(n, d) * rows;
  hlsh_warp_kernel<T, DMAX, V4><<<(unsigned)((b + rows - 1) / rows),
                                  32 * rows, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)keep, (T*)out, b, n,
      d, LOG2E / sqrtf((float)d));
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_warp(const void* q, const void* k, const void* v,
                       const void* keep, void* out, int b, int n, int d,
                       int rows, cudaStream_t stream) {
  if (n > WARP_N || d > WARP_MAX_D || rows < 1 || rows > WARP_MAX_ROWS ||
      sizeof(float) * 3 * (size_t)row_span(n, d) * rows > WARP_SMEM)
    return (int)cudaErrorInvalidValue;
  const bool v4 = d % 4 == 0;
#define K2_WARP(DM)                                                        \
  return v4 ? launch_warp_t<T, DM, true>(q, k, v, keep, out, b, n, d, rows, \
                                         stream)                           \
            : launch_warp_t<T, DM, false>(q, k, v, keep, out, b, n, d,     \
                                          rows, stream)
  if (d <= 16) K2_WARP(16);
  if (d <= 32) K2_WARP(32);
  K2_WARP(64);
#undef K2_WARP
}

// ---- the general tile: launch --------------------------------------------

template <typename T>
static int launch_general(const void* q, const void* k, const void* v,
                          const void* keep, void* out, int b, int n, int d,
                          cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const size_t smem = sizeof(float) * (size_t)(2 * TQ * d + 2 * TK * d + TQ * TK);
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        hlsh_general_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  dim3 grid(b, (n + TQ - 1) / TQ);
  hlsh_general_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)keep, (T*)out, n, d,
      1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

enum Tiling { GENERAL = 0, WARP = 1 };

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* keep, void* out, int b, int n, int d,
                  int tiling, int rows, void* stream_v) {
  if (b <= 0 || n <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > MAX_D) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_v;
  if (tiling == WARP)
    return launch_warp<T>(q, k, v, keep, out, b, n, d, rows, stream);
  if (tiling == GENERAL && rows == 1)
    return launch_general<T>(q, k, v, keep, out, b, n, d, stream);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16; tiling: 0 = general, 1 = a warp per
// row; rows: batch rows of a block (1 for the general tiling), as the
// wrapper's hlsh_geometry gives them
extern "C" int hlsh_attention_launch(const void* q, const void* k,
                                     const void* v, const void* keep,
                                     void* out, int b, int n, int d,
                                     int dtype, int tiling, int rows,
                                     void* stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, keep, out, b, n, d, tiling, rows, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, keep, out, b, n, d, tiling, rows,
                                 stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
