// K4: flash (online-softmax) multi-head attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (built by flash_attention_pallas): softmax(Q K^T / sqrt(D)) V per head,
// q (B, H, Sq, D), k/v (B, Hkv, Sk, D), H % Hkv == 0 (head h reads kv head
// h / (H / Hkv)), optional causal mask offset by Sk - Sq, float32 or bf16
// inputs, float32 accumulation, output in the inputs' type.
//
// Bound: on the predictor's path (B = 4096, H = 4, S = 30, D = 50, float32)
// the work is 4*S*S*D = 180 kFLOP per head against 4*S*D*4 = 24 kB moved,
// about 7.5 FLOP/byte, below the card's float32 ridge (67 TFLOP/s over
// 3.35 TB/s, about 20 FLOP/byte): bound by bytes moved.  No tensor cores:
// the float32 path stays in full float32 (TF32 would break the reference's
// tolerance at D = 64-128).
//
// Two tilings; the wrapper picks one (flash_geometry) and this file checks
// it.
//   A warp per head (Sq, Sk <= 32, D <= 64: the path's S = 30, D = 50):
//     each head's Q, K and V rows (one contiguous span of device memory
//     each) are staged in shared memory as float32 rows padded to whole
//     float4 chunks: float32 by asynchronous 8-byte copies (4-byte where D
//     is odd), all of a warp's in flight at once; bf16 by 16-byte loads
//     converted in registers (4-byte loads where the span is not 16-byte
//     aligned, as for heads of S * D = 1,500).  The softmax runs in one
//     pass over all keys, both products as register tiles (a lane owns 4
//     query rows x 8 keys of the logits, then 4 rows x 4 float4 chunks of
//     the output), so each float4 read of shared memory feeds 8 to 16
//     FMAs.  Warps share no barrier; 2 heads a block.  The output leaves
//     through shared memory as flat 16-byte stores.
//   General (anything longer: the reference's S up to 384, D up to 128):
//     one block of 128 threads per (batch x head, query tile of 32) stages
//     its query tile and each key/value tile of 32 in shared memory as
//     float32 by scalar loads, and runs the online softmax over the key
//     tiles (logits and the output numerator in shared memory).
// Under the causal mask, key tiles past a tile's last query are skipped
// only where Sk >= Sq (every row then sees key 0, so the skipped keys'
// probabilities are exactly 0); where Sq > Sk a row that sees no key is
// spread evenly over all Sk keys masked with -1e30, as the reference's
// oracle does.
//
// Any Sq, Sk >= 1 and any D up to 128.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define MAX_D 128
#define NEG_INF_MASK (-1e30f)  // the reference's causal fill value
#define LOG2E 1.4426950408889634f

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

// n elements of src (flat rows of d) -> float32 rows of stride ds at dst,
// the pad columns and the rows from n / d up to row_to zeroed
template <typename T>
__device__ void stage_rows(const T* __restrict__ src, int n, int d, int ds,
                           int row_to, float* __restrict__ dst, int tid,
                           int nthr) {
  constexpr int VE = 16 / sizeof(T);
  int done = 0;
  if (((uintptr_t)src & 15) == 0) {
    const int nvec = n / VE;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int vi = tid; vi < nvec; vi += nthr) {
      const uint4 chunk = s4[vi];
      const T* ev = reinterpret_cast<const T*>(&chunk);
      int j = vi * VE / d, c = vi * VE - j * d;
#pragma unroll
      for (int t = 0; t < VE; ++t) {
        dst[j * ds + c] = to_f32(ev[t]);
        if (++c == d) {
          c = 0;
          ++j;
        }
      }
    }
    done = nvec * VE;
  }
  for (int e = done + tid; e < n; e += nthr) {
    const int j = e / d;
    dst[j * ds + e - j * d] = to_f32(src[e]);
  }
  const int pad = ds - d;
  for (int e = tid; e < n / d * pad; e += nthr) {
    const int j = e / pad;
    dst[j * ds + d + e - j * pad] = 0.f;
  }
  for (int e = n / d * ds + tid; e < row_to * ds; e += nthr)
    dst[e] = 0.f;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 8)
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

// float32: asynchronous copies of n elements of src (flat rows of d) into
// rows of stride ds at dst, in pairs where d is even, so that every load of
// the block is in flight at once; the pad columns and the rows from n / d
// up to row_to zeroed
__device__ void stage_rows_async(const float* __restrict__ src, int n,
                                 int d, int ds, int row_to,
                                 float* __restrict__ dst, int tid, int nthr) {
  const int w = (d % 2 == 0 && ((uintptr_t)src & 7) == 0) ? 2 : 1;
  const int per_row = d / w, step_j = nthr / per_row,
            step_c = nthr % per_row;
  int j = tid / per_row, c = tid % per_row;
  for (int e = tid; e < n / w; e += nthr) {
    cp_async(dst + j * ds + w * c, src + w * e, 4 * w);
    j += step_j;
    c += step_c;
    if (c >= per_row) {
      c -= per_row;
      ++j;
    }
  }
  const int pad = ds - d;
  for (int e = tid; e < n / d * pad; e += nthr) {
    const int r = e / pad;
    dst[r * ds + d + e - r * pad] = 0.f;
  }
  for (int e = n / d * ds + tid; e < row_to * ds; e += nthr)
    dst[e] = 0.f;
}

// stage n elements as float32 rows: asynchronously for float32 (the caller
// waits), through registers for bf16
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int n,
                                      int d, int ds, int row_to,
                                      float* __restrict__ dst, int tid,
                                      int nthr) {
  if constexpr (sizeof(T) == 4)
    stage_rows_async(reinterpret_cast<const float*>(src), n, d, ds, row_to,
                     dst, tid, nthr);
  else
    stage_rows<T>(src, n, d, ds, row_to, dst, tid, nthr);
}

// n elements from shared src (16-byte aligned) to dst
template <typename T>
__device__ void copy_out(const T* __restrict__ src, T* __restrict__ dst,
                         int n, int tid, int nthr) {
  constexpr int VE = 16 / sizeof(T);
  int done = 0;
  if (((uintptr_t)dst & 15) == 0) {
    const int nvec = n / VE;
    for (int vi = tid; vi < nvec; vi += nthr)
      reinterpret_cast<uint4*>(dst)[vi] =
          reinterpret_cast<const uint4*>(src)[vi];
    done = nvec * VE;
  }
  for (int e = done + tid; e < n; e += nthr) dst[e] = src[e];
}

__device__ __forceinline__ float dot4v(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One warp per head where Sq, Sk <= 32 and D <= 64 (the Transformer
// family's S = 30, D = 50): the softmax in one pass over all keys, and both
// products as register tiles.  Lane l owns the query rows a + 8 * ii (a =
// l / 4, ii < 4) and, of Q K^T, the keys b + 4 * jj (b = l % 4, jj < 8): a
// 4 x 8 tile of logits that costs 12 float4 reads of shared memory for 128
// FMAs per chunk of 4 dims.  A row's max and sum meet across its 4 lanes by
// shuffles; the probabilities go through shared memory (rows of P_STRIDE
// floats: no bank conflicts), and the lane then owns a 4 x 4-chunk tile of
// the output (rows a + 8 * ii, chunks b + 4 * cc): per key 4 probability
// and 4 float4 value reads for 64 FMAs.  Rows of Q, K and V are staged with
// an odd number of float4 chunks, so the 8 rows or 4 keys that one read
// touches fall in distinct banks.
#define WARP_ROWS 32            // queries and keys of a warp's head, at most
#define WARP_MAX_D 64
#define P_STRIDE 36             // floats of a probability row

// floats of one warp's shared memory: Q (then P), K (then the output), V
__host__ __device__ __forceinline__ int warp_region(int rs) {
  return WARP_ROWS * 4 * rs > WARP_ROWS * P_STRIDE ? WARP_ROWS * 4 * rs
                                                   : WARP_ROWS * P_STRIDE;
}

template <typename T>
__global__ void __launch_bounds__(128, 4)
    flash_warp_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      int bh_total, int h, int hkv, int sq, int sk, int d,
                      float scale_log2, int causal) {
  extern __shared__ float4 smem4[];
  const int dc = (d + 3) / 4, rs = dc | 1;   // chunks of a row; row stride
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int bh = blockIdx.x * (blockDim.x / 32) + warp;
  if (bh >= bh_total) return;       // the whole warp: no block barrier here
  float* sQ = reinterpret_cast<float*>(smem4) +
              (size_t)warp * (warp_region(rs) + 2 * WARP_ROWS * 4 * rs);
  float* sK = sQ + warp_region(rs);
  float* sV = sK + WARP_ROWS * 4 * rs;
  const int kvh = (bh / h) * hkv + (bh % h) / (h / hkv);
  stage<T>(q + (size_t)bh * sq * d, sq * d, d, 4 * rs, sq, sQ, lane, 32);
  stage<T>(k + (size_t)kvh * sk * d, sk * d, d, 4 * rs, sk, sK, lane, 32);
  stage<T>(v + (size_t)kvh * sk * d, sk * d, d, 4 * rs, sk, sV, lane, 32);
  cp_async_wait_all();
  __syncwarp();

  const int a = lane >> 2, b = lane & 3;
  const float4* q4 = reinterpret_cast<const float4*>(sQ);
  const float4* k4 = reinterpret_cast<const float4*>(sK);
  const float4* v4 = reinterpret_cast<const float4*>(sV);
  float s[4][8];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) s[ii][jj] = 0.f;
  for (int c = 0; c < dc; ++c) {
    float4 qv[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) qv[ii] = q4[(a + 8 * ii) * rs + c];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float4 kv = k4[(b + 4 * jj) * rs + c];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) s[ii][jj] = dot4v(qv[ii], kv, s[ii][jj]);
    }
  }
  // the softmax of each row over all its keys: past Sk no key (-inf), the
  // causal mask the reference's -1e30
  const int offset = sk - sq;
  float inv[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = a + 8 * ii;
    float mx = NEG_INF_MASK;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = b + 4 * jj;
      const float sv = j >= sk ? -INFINITY
                       : causal && i + offset < j ? NEG_INF_MASK
                                                  : s[ii][jj] * scale_log2;
      s[ii][jj] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      s[ii][jj] = exp2f(s[ii][jj] - mx);
      sum += s[ii][jj];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[ii] = 1.f / fmaxf(sum, 1e-30f);
  }
  __syncwarp();                     // every read of Q is done: P replaces it
  float* sP = sQ;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      sP[(a + 8 * ii) * P_STRIDE + b + 4 * jj] = s[ii][jj];
  __syncwarp();

  float4 acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      acc[ii][cc] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int j = 0; j < sk; ++j) {
    float pj[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) pj[ii] = sP[(a + 8 * ii) * P_STRIDE + j];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = b + 4 * cc;
      const float4 vv = c < dc ? v4[j * rs + c]
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        acc[ii][cc].x = fmaf(pj[ii], vv.x, acc[ii][cc].x);
        acc[ii][cc].y = fmaf(pj[ii], vv.y, acc[ii][cc].y);
        acc[ii][cc].z = fmaf(pj[ii], vv.z, acc[ii][cc].z);
        acc[ii][cc].w = fmaf(pj[ii], vv.w, acc[ii][cc].w);
      }
    }
  }
  T* sO = reinterpret_cast<T*>(sK);  // K is read: flat (sq, d) output
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = a + 8 * ii;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = 4 * (b + 4 * cc);
      const float o[4] = {acc[ii][cc].x, acc[ii][cc].y, acc[ii][cc].z,
                          acc[ii][cc].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i < sq && c + e < d)
          sO[i * d + c + e] = from_f32<T>(o[e] * inv[ii]);
    }
  }
  __syncwarp();
  copy_out<T>(sO, out + (size_t)bh * sq * d, sq * d, lane, 32);
}

template <typename T>
static int launch_warps(const void* q, const void* k, const void* v,
                        void* out, int b, int h, int hkv, int sq, int sk,
                        int d, int causal, int nh, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  if (sq > WARP_ROWS || sk > WARP_ROWS || d > WARP_MAX_D || nh < 1 ||
      nh > 4)
    return (int)cudaErrorInvalidValue;
  const int rs = ((d + 3) / 4) | 1;
  const size_t smem = sizeof(float) * (size_t)nh *
                      (warp_region(rs) + 2 * WARP_ROWS * 4 * rs);
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_warp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const long long bh = (long long)b * h;
  flash_warp_kernel<T><<<(unsigned)((bh + nh - 1) / nh), 32 * nh, smem,
                         stream>>>((const T*)q, (const T*)k, (const T*)v,
                                   (T*)out, (int)bh, h, hkv, sq, sk, d,
                                   LOG2E / sqrtf((float)d), causal);
  return (int)cudaGetLastError();
}

// General: one block per (batch x head, query tile of TQ rows); the query
// tile and each key/value tile of TK rows staged in shared memory as
// float32, the logits and the output numerator there too, the online
// softmax's running max and sum on TQ threads.
#define TQ 32                  // query rows per block
#define TK 32                  // keys per tile
#define GENERAL_THREADS 128

template <typename T>
__global__ void flash_general_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     T* __restrict__ out, int h, int hkv,
                                     int sq, int sk, int d, float scale,
                                     int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;              // TQ x d
  float* sK = sQ + TQ * d;       // TK x d
  float* sV = sK + TK * d;       // TK x d
  float* sS = sV + TK * d;       // TQ x TK logits, then probabilities
  float* sAcc = sS + TQ * TK;    // TQ x d numerator
  __shared__ float sM[TQ], sL[TQ], sAlpha[TQ];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;                  // b * h + head
  const int kvh = (bh / h) * hkv + (bh % h) / (h / hkv);
  const int q0 = blockIdx.y * TQ;
  const int offset = sk - sq;                 // causal: key j visible to
                                              // query i iff i + offset >= j
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)kvh * sk * d;
  const T* vb = v + (size_t)kvh * sk * d;

  for (int e = tid; e < TQ * d; e += GENERAL_THREADS) {
    const int qi = q0 + e / d;
    sQ[e] = qi < sq ? to_f32(qb[(size_t)q0 * d + e]) : 0.f;
    sAcc[e] = 0.f;
  }
  if (tid < TQ) {
    sM[tid] = NEG_INF_MASK;
    sL[tid] = 0.f;
  }
  // keys past the tile's last query are masked for every row of the tile,
  // unless a row sees no key at all (Sq > Sk): the reference's softmax then
  // spreads it evenly over all Sk masked keys, so every tile is visited
  int kend = sk;
  if (causal && offset >= 0) kend = min(sk, min(q0 + TQ, sq) + offset);
  __syncthreads();

  for (int k0 = 0; k0 < kend; k0 += TK) {
    const int nk = min(TK, sk - k0);
    for (int e = tid; e < nk * d; e += GENERAL_THREADS) {
      const size_t src = (size_t)k0 * d + e;
      sK[e] = to_f32(kb[src]);
      sV[e] = to_f32(vb[src]);
    }
    __syncthreads();
    for (int e = tid; e < TQ * TK; e += GENERAL_THREADS) {
      const int i = e / TK, j = e % TK;
      float s = -INFINITY;                    // past Sk: no key at all
      if (j < nk) {
        float acc = 0.f;
        const float* qr = sQ + i * d;
        const float* kr = sK + j * d;
        for (int c = 0; c < d; ++c) acc += qr[c] * kr[c];
        s = acc * scale;
        if (causal && q0 + i + offset < k0 + j) s = NEG_INF_MASK;
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
    for (int e = tid; e < TQ * d; e += GENERAL_THREADS) {
      const int i = e / d, c = e % d;
      const float* prow = sS + i * TK;
      float acc = sAcc[e] * sAlpha[i];
      for (int j = 0; j < nk; ++j) acc += prow[j] * sV[j * d + c];
      sAcc[e] = acc;
    }
    __syncthreads();
  }

  T* ob = out + (size_t)bh * sq * d;
  for (int e = tid; e < TQ * d; e += GENERAL_THREADS) {
    const int i = e / d, qi = q0 + i;
    if (qi < sq)
      ob[(size_t)q0 * d + e] = from_f32<T>(sAcc[e] / fmaxf(sL[i], 1e-30f));
  }
}

template <typename T>
static int launch_general(const void* q, const void* k, const void* v,
                          void* out, int b, int h, int hkv, int sq, int sk,
                          int d, int causal, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const size_t smem =
      sizeof(float) * (size_t)(2 * TQ * d + 2 * TK * d + TQ * TK);
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_general_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  dim3 grid((unsigned)((long long)b * h), (unsigned)((sq + TQ - 1) / TQ));
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  flash_general_kernel<T><<<grid, GENERAL_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, h, hkv, sq, sk, d,
      1.0f / sqrtf((float)d), causal);
  return (int)cudaGetLastError();
}

enum Tiling { GENERAL = 0, WARP = 1 };

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int b, int h, int hkv, int sq, int sk, int d, int causal,
                  int tiling, int nh, void* stream_v) {
  if (b <= 0 || sq <= 0) return (int)cudaSuccess;
  if (sk <= 0 || d <= 0 || d > MAX_D || hkv <= 0 || h % hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_v;
  if (tiling == WARP)
    return launch_warps<T>(q, k, v, out, b, h, hkv, sq, sk, d, causal, nh,
                           stream);
  if (tiling == GENERAL && nh == 1)
    return launch_general<T>(q, k, v, out, b, h, hkv, sq, sk, d, causal,
                             stream);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16; tiling: 0 = general, 1 = a warp per
// head; nh: heads per block (1 for the general tiling), as the wrapper's
// flash_geometry gives them
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int h,
                                      int hkv, int sq, int sk, int d,
                                      int causal, int dtype, int tiling,
                                      int nh, void* stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, out, b, h, hkv, sq, sk, d, causal, tiling,
                         nh, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, b, h, hkv, sq, sk, d, causal,
                                 tiling, nh, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
