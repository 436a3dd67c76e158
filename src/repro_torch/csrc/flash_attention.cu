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
// 3.35 TB/s, about 20 FLOP/byte): bound by bytes moved.  No tensor cores
// there: the float32 path stays in full float32 (TF32 would break the
// reference's tolerance at D = 64-128).  On the LM zoo's serve path
// (llama3-8b, bf16, 32 query heads over 8 kv heads of 128, causal), with
// each input read once and the output written once at 3.35 TB/s:
//   prefill (8, 32, 8, Sq = Sk = 512): 83.9 MB, 0.0250 ms (its 17.2 GFLOP
//     of causal products take 0.0174 ms at 989 TFLOP/s): bound by bytes,
//     but close to the ridge, so the products must run on the tensor
//     cores (mma tiling) and each K/V tile must serve 64 query rows;
//   decode (8, 32, 8, Sq = 1, Sk = 575): 19.0 MB, 0.0057 ms, nearly all
//     the cache: bound by bytes read, so a kv head's keys must be read once
//     for all its G query heads, straight from the cache (no copy), by
//     enough blocks to keep HBM busy (split tiling).
//
// Four tilings; the wrapper picks one (flash_geometry) and this file checks
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
//   mma and split (bf16 at D = 64 or 128, no mask or a causal one with
//     Sk >= Sq; they take these shapes before the two above): the
//     tensor-core tilings, described where they begin below.
// Under the causal mask, key tiles past a tile's last query are skipped
// only where Sk >= Sq (every row then sees key 0, so the skipped keys'
// probabilities are exactly 0); where Sq > Sk a row that sees no key is
// spread evenly over all Sk keys masked with -1e30, as the reference's
// oracle does (on the warp and general tilings only).
//
// Any Sq, Sk >= 1 and any D up to 128 on the warp and general tilings.  k
// and v may be views with dense rows (a KV cache sliced to its live keys):
// every tiling takes their batch and head strides.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define MAX_D 128
#define NEG_INF_MASK (-1e30f)  // the reference's causal fill value
#define LOG2E 1.4426950408889634f

// k's and v's batch and head strides in elements; their rows are dense
// (stride D), so a head's keys are one span of Sk * D elements
struct KvStrides {
  long long kb, kh, vb, vh;
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
                      KvStrides kv, int bh_total, int h, int hkv, int sq,
                      int sk, int d, float scale_log2, int causal) {
  extern __shared__ float4 smem4[];
  const int dc = (d + 3) / 4, rs = dc | 1;   // chunks of a row; row stride
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int bh = blockIdx.x * (blockDim.x / 32) + warp;
  if (bh >= bh_total) return;       // the whole warp: no block barrier here
  float* sQ = reinterpret_cast<float*>(smem4) +
              (size_t)warp * (warp_region(rs) + 2 * WARP_ROWS * 4 * rs);
  float* sK = sQ + warp_region(rs);
  float* sV = sK + WARP_ROWS * 4 * rs;
  const int bi = bh / h, kvh = (bh % h) / (h / hkv);
  stage<T>(q + (size_t)bh * sq * d, sq * d, d, 4 * rs, sq, sQ, lane, 32);
  stage<T>(k + bi * kv.kb + kvh * kv.kh, sk * d, d, 4 * rs, sk, sK, lane,
           32);
  stage<T>(v + bi * kv.vb + kvh * kv.vh, sk * d, d, 4 * rs, sk, sV, lane,
           32);
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
                        void* out, const KvStrides& kv, int b, int h, int hkv,
                        int sq, int sk, int d, int causal, int nh,
                        cudaStream_t stream) {
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
                                   (T*)out, kv, (int)bh, h, hkv, sq, sk, d,
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
                                     T* __restrict__ out, KvStrides kv,
                                     int h, int hkv, int sq, int sk, int d,
                                     float scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;              // TQ x d
  float* sK = sQ + TQ * d;       // TK x d
  float* sV = sK + TK * d;       // TK x d
  float* sS = sV + TK * d;       // TQ x TK logits, then probabilities
  float* sAcc = sS + TQ * TK;    // TQ x d numerator
  __shared__ float sM[TQ], sL[TQ], sAlpha[TQ];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;                  // b * h + head
  const int bi = bh / h, kvh = (bh % h) / (h / hkv);
  const int q0 = blockIdx.y * TQ;
  const int offset = sk - sq;                 // causal: key j visible to
                                              // query i iff i + offset >= j
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + bi * kv.kb + kvh * kv.kh;
  const T* vb = v + bi * kv.vb + kvh * kv.vh;

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
                          void* out, const KvStrides& kv, int b, int h,
                          int hkv, int sq, int sk, int d, int causal,
                          cudaStream_t stream) {
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
      (const T*)q, (const T*)k, (const T*)v, (T*)out, kv, h, hkv, sq, sk, d,
      1.0f / sqrtf((float)d), causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core tilings: bf16 at D = 64 or 128, no mask or a causal mask
// with Sk >= Sq.  Both run one kernel body (flash_mma_kernel): a block of 4
// warps owns up to MMA_BQ rows of q and walks its keys in tiles of MMA_BK,
// double-buffered in shared memory by 16-byte cp.async copies (rows padded
// by 16 bytes, so that the 8 rows of an ldmatrix read fall in distinct
// banks).  A warp owns a 16-row slice of the block's rows (its Q fragments
// stay in registers, loaded once by ldmatrix) and, of each key tile, the
// KW = 8 * NKT keys of its key group: S = Q K^T and O += P V run as
// mma.sync.m16n8k16 bf16 products with float32 accumulators (K by
// ldmatrix, V by ldmatrix.trans); the online softmax stays in registers
// (exp2f with log2(e) / sqrt(D) folded into the scale; a row's max and sum
// meet across the 4 lanes of its quad by shuffles), and P goes to bf16 in
// registers as the A operand of P V, as the plain version rounds its
// probabilities to q's type.
//   mma (prefill): a block per (batch x head, query tile of 64 rows), the
//     longest causal tiles first; key tiles past the tile's last row are
//     skipped and only the tiles that reach past a row's last key (or past
//     Sk) are masked.  It writes the normalised output.
//   split (decode): a block per (batch, kv head, split of split_keys keys):
//     its rows are the G query heads x Sq rows of that kv head, which lie
//     contiguous in q, so each key and value byte is read from HBM once for
//     all G heads and no row is empty.  With R = G * Sq <= 64 rows in
//     ceil(R / 16) row slices, the 4 warps split each key tile over
//     key_groups = 4 / slices groups (4, 2 or 1).  Each warp writes its
//     partial (max, sum, unnormalised numerator) to scratch the wrapper
//     allocates; flash_merge_kernel then merges the splits x key_groups
//     partials of each row (a partial that saw no key has max -inf and
//     sum 0 and weighs 0).
#define MMA_BQ 64              // q rows of a block: 4 warps x 16
#define MMA_BK 64              // keys of a tile
#define MMA_THREADS 128
#define MMA_PAD 8              // bf16 of padding at the end of a smem row

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;     // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16 in one register, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

struct MmaArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  float* part_o;               // split: (B * Hkv, parts, rows, D)
  float* part_ml;              // split: (B * Hkv, parts, rows, 2)
  KvStrides kv;
  int h, hkv, sq, sk, causal;
  int rows;                    // split: G * Sq
  int split_keys;              // split: keys of a split, a multiple of MMA_BK
  int parts;                   // split: splits x key groups
  float scale_log2;            // log2(e) / sqrt(D)
};

template <int D>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(MMA_BQ + 4 * MMA_BK) *
         (D + MMA_PAD);
}

template <int D, int NKT, bool SPLIT>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_mma_kernel(const MmaArgs a) {
  constexpr int RS = D + MMA_PAD;            // bf16 of a smem row
  constexpr int KG = 8 / NKT;                // key groups
  constexpr int KW = 8 * NKT;                // keys a warp takes of a tile
  constexpr int SLICES = 4 / KG;             // 16-row slices of the block
  constexpr int CH = D / 8;                  // 16-byte chunks of a row
  static_assert(NKT == 2 || NKT == 4 || NKT == 8, "NKT");
  static_assert(SPLIT || NKT == 8, "the prefill tile takes whole tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sKV = sQ + MMA_BQ * RS;     // [stage][K, V][MMA_BK][RS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int group = a.h / a.hkv, off = a.sk - a.sq;
  int bi, kvh, nrows, i0, kbeg, kend;
  long long qrow;                            // the block's first row of q
  if (SPLIT) {
    bi = blockIdx.x / a.hkv;
    kvh = blockIdx.x % a.hkv;
    qrow = ((long long)bi * a.h + (long long)kvh * group) * a.sq;
    nrows = a.rows;
    i0 = 0;
    kbeg = blockIdx.y * a.split_keys;
    kend = min(a.sk, kbeg + a.split_keys);
  } else {
    const int bh = blockIdx.x, head = bh % a.h;
    bi = bh / a.h;
    kvh = head / group;
    i0 = (gridDim.y - 1 - blockIdx.y) * MMA_BQ;
    qrow = (long long)bh * a.sq + i0;
    nrows = min(MMA_BQ, a.sq - i0);
    kbeg = 0;
    // keys past the tile's last row are in every row's future
    kend = a.causal ? min(a.sk, i0 + nrows + off) : a.sk;
  }
  const __nv_bfloat16* kb = a.k + bi * a.kv.kb + kvh * a.kv.kh;
  const __nv_bfloat16* vb = a.v + bi * a.kv.vb + kvh * a.kv.vh;

  // this warp's rows and keys
  const int slice = warp % SLICES, kg = warp / SLICES;
  const int r0 = slice * 16 + g, r1 = r0 + 8;
  const bool active = slice * 16 < nrows;
  // the query index of each of the thread's two rows (for the causal mask)
  const int iq0 = SPLIT ? r0 % a.sq : i0 + r0;
  const int iq1 = SPLIT ? r1 % a.sq : i0 + r1;
  // the smallest query index of the block's rows: a key past it + off is
  // masked for some row
  const int imin = SPLIT ? 0 : i0;

  for (int c = tid; c < SLICES * 16 * CH; c += MMA_THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = r < nrows;
    cp_async16(sQ + r * RS + col, ok ? a.q + (qrow + r) * D + col : a.q, ok);
  }
  auto load_tile = [&](int st, int k0) {
    __nv_bfloat16* sK = sKV + st * 2 * MMA_BK * RS;
    __nv_bfloat16* sV = sK + MMA_BK * RS;
    for (int c = tid; c < MMA_BK * CH; c += MMA_THREADS) {
      const int r = c / CH, col = (c % CH) * 8, key = k0 + r;
      const bool ok = key < kend;
      cp_async16(sK + r * RS + col, ok ? kb + (size_t)key * D + col : kb, ok);
      cp_async16(sV + r * RS + col, ok ? vb + (size_t)key * D + col : vb, ok);
    }
  };
  const int ntiles = (kend - kbeg + MMA_BK - 1) / MMA_BK;
  load_tile(0, kbeg);
  cp_async_commit();

  unsigned qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl = a.scale_log2;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile((t + 1) & 1, kbeg + (t + 1) * MMA_BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldmatrix_x4(qf[kk], sQ + (slice * 16 + (lane & 15)) * RS +
                                  kk * 16 + (lane >> 4) * 8);
      }
      const __nv_bfloat16* sK = sKV + (t & 1) * 2 * MMA_BK * RS;
      const __nv_bfloat16* sV = sK + MMA_BK * RS;
      const int k0 = kbeg + t * MMA_BK;      // the tile's first key
      const int kw0 = kg * KW;               // the warp's first key in it
      float s[NKT][4];
#pragma unroll
      for (int j = 0; j < NKT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < NKT / 2; ++np) {
          unsigned b[4];
          ldmatrix_x4(b, sK + (kw0 + np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                  RS + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
        }
      }
      // keys at or past kend get -inf, and under the causal mask keys past
      // a row's query index + off: only on tiles that reach that far
      if (k0 + MMA_BK > kend || (a.causal && k0 + MMA_BK - 1 > imin + off)) {
#pragma unroll
        for (int j = 0; j < NKT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + kw0 + 8 * j + 2 * t4 + (e & 1);
            const int iq = e < 2 ? iq0 : iq1;
            if (key >= kend || (a.causal && key > iq + off))
              s[j][e] = -INFINITY;
          }
      }
      // the online softmax, in the log2 domain
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NKT; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx * sl);
        // a row with no key seen yet keeps weight 0 (no -inf - -inf)
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[r] - m_use);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NKT; ++j) {
          s[j][2 * r] = exp2f(fmaf(s[j][2 * r], sl, -m_use));
          s[j][2 * r + 1] = exp2f(fmaf(s[j][2 * r + 1], sl, -m_use));
          sum += s[j][2 * r] + s[j][2 * r + 1];
        }
        l[r] = l[r] * alpha + sum;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
      }
      // O += P V, P as bf16 A fragments straight from the S accumulators
#pragma unroll
      for (int kk = 0; kk < NKT / 2; ++kk) {
        const unsigned pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          unsigned b[4];
          ldmatrix_x4_trans(b, sV + (kw0 + kk * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * RS +
                                   np * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * np], pa, b[0], b[1]);
          mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();                // the stage is read: the next load
  }                                 // may overwrite it

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? r1 : r0;
    if (row >= nrows) continue;
    if (!SPLIT) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      unsigned* dst =
          reinterpret_cast<unsigned*>(a.out + (qrow + row) * D + 2 * t4);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        dst[4 * n] = pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    } else {
      const size_t part =
          ((size_t)blockIdx.x * a.parts + blockIdx.y * KG + kg) * a.rows +
          row;
      float2* dst = reinterpret_cast<float2*>(a.part_o + part * D + 2 * t4);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        dst[4 * n] = make_float2(o[n][2 * r], o[n][2 * r + 1]);
      if (t4 == 0) {
        a.part_ml[2 * part] = m[r];
        a.part_ml[2 * part + 1] = l[r];
      }
    }
  }
}

// the split tiling's second pass: for each (batch, kv head) and each of its
// rows, the weighted sum of its parts' numerators over their weighted sums
// (weights exp2(max - the largest max)), written in bf16 to the rows of q's
// layout
__global__ void flash_merge_kernel(const float* __restrict__ part_o,
                                   const float* __restrict__ part_ml,
                                   __nv_bfloat16* __restrict__ out, int h,
                                   int hkv, int sq, int d, int rows,
                                   int parts) {
  const int pair = blockIdx.x;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= rows * d) return;
  const int r = e / d, c = e - r * d;
  const float* ml = part_ml + (size_t)pair * parts * rows * 2;
  const float* po = part_o + (size_t)pair * parts * rows * d;
  float mx = -INFINITY;
  for (int p = 0; p < parts; ++p) mx = fmaxf(mx, ml[2 * (p * rows + r)]);
  const float m_use = mx == -INFINITY ? 0.f : mx;
  float sum = 0.f, acc = 0.f;
  for (int p = 0; p < parts; ++p) {
    const float w = exp2f(ml[2 * (p * rows + r)] - m_use);
    sum = fmaf(w, ml[2 * (p * rows + r) + 1], sum);
    acc = fmaf(w, po[(size_t)(p * rows + r) * d + c], acc);
  }
  const int bi = pair / hkv, kvh = pair % hkv;
  const long long row =
      ((long long)bi * h + (long long)kvh * (h / hkv)) * sq + r;
  out[row * d + c] = __float2bfloat16(sum > 0.f ? acc / sum : 0.f);
}

template <int D, int NKT, bool SPLIT>
static int launch_mma_kernel(const MmaArgs& a, dim3 grid,
                             cudaStream_t stream) {
  static bool sized = false;
  constexpr size_t smem = mma_smem_bytes<D>();
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<D, NKT, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  flash_mma_kernel<D, NKT, SPLIT><<<grid, MMA_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_mma(MmaArgs a, int b, int tiling, int splits,
                      int key_groups, cudaStream_t stream) {
  if (tiling == 2) {                          // mma (prefill)
    if (splits != 1 || key_groups != 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((long long)b * a.h),
                    (unsigned)((a.sq + MMA_BQ - 1) / MMA_BQ));
    if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
    return launch_mma_kernel<D, 8, false>(a, grid, stream);
  }
  // split (decode): the rows of a kv head in 16-row slices, 4 / slices
  // key groups
  const int slices = (a.rows + 15) / 16;
  if (a.rows < 1 || slices > 4 || key_groups != 4 / slices || splits < 1 ||
      splits > 65535 || a.split_keys < 1 || a.split_keys % MMA_BK ||
      (long long)(splits - 1) * a.split_keys >= a.sk ||
      (long long)splits * a.split_keys < a.sk)
    return (int)cudaErrorInvalidValue;
  a.parts = splits * key_groups;
  const dim3 grid((unsigned)((long long)b * a.hkv), (unsigned)splits);
  int err;
  if (key_groups == 4)
    err = launch_mma_kernel<D, 2, true>(a, grid, stream);
  else if (key_groups == 2)
    err = launch_mma_kernel<D, 4, true>(a, grid, stream);
  else
    err = launch_mma_kernel<D, 8, true>(a, grid, stream);
  if (err != (int)cudaSuccess) return err;
  const dim3 mgrid(grid.x, (unsigned)((a.rows * D + 127) / 128));
  flash_merge_kernel<<<mgrid, 128, 0, stream>>>(
      a.part_o, a.part_ml, a.out, a.h, a.hkv, a.sq, D, a.rows, a.parts);
  return (int)cudaGetLastError();
}

enum Tiling { GENERAL = 0, WARP = 1, MMA = 2, SPLIT = 3 };

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out,
                  const KvStrides& kv, int b, int h, int hkv, int sq, int sk,
                  int d, int causal, int tiling, int nh, void* stream_v) {
  cudaStream_t stream = (cudaStream_t)stream_v;
  if (tiling == WARP)
    return launch_warps<T>(q, k, v, out, kv, b, h, hkv, sq, sk, d, causal,
                           nh, stream);
  if (tiling == GENERAL && nh == 1)
    return launch_general<T>(q, k, v, out, kv, b, h, hkv, sq, sk, d, causal,
                             stream);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16; tiling: 0 = general, 1 = a warp per
// head, 2 = mma (prefill), 3 = split (decode); nh: heads per block (the
// warp tiling; 1 otherwise); splits, split_keys, key_groups: the split
// tiling's (1, 0, 1 otherwise), whose scratch part_o holds B * Hkv *
// splits * key_groups * G * Sq * D floats and part_ml twice that over D;
// k and v rows are dense (stride D), their batch and head strides k_sb,
// k_sh, v_sb, v_sh in elements; q and out are contiguous.  All as the
// wrapper's flash_geometry gives them.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* part_o,
    void* part_ml, int b, int h, int hkv, int sq, int sk, int d,
    long long k_sb, long long k_sh, long long v_sb, long long v_sh,
    int causal, int dtype, int tiling, int nh, int splits, int split_keys,
    int key_groups, void* stream) {
  if (b <= 0 || sq <= 0) return (int)cudaSuccess;
  if (sk <= 0 || d <= 0 || d > MAX_D || hkv <= 0 || h % hkv != 0)
    return (int)cudaErrorInvalidValue;
  const KvStrides kv = {k_sb, k_sh, v_sb, v_sh};
  if (tiling == MMA || tiling == SPLIT) {
    if (dtype != 1 || (d != 64 && d != 128) || (causal && sq > sk) ||
        nh != 1)
      return (int)cudaErrorInvalidValue;
    MmaArgs a;
    a.q = (const __nv_bfloat16*)q;
    a.k = (const __nv_bfloat16*)k;
    a.v = (const __nv_bfloat16*)v;
    a.out = (__nv_bfloat16*)out;
    a.part_o = (float*)part_o;
    a.part_ml = (float*)part_ml;
    a.kv = kv;
    a.h = h;
    a.hkv = hkv;
    a.sq = sq;
    a.sk = sk;
    a.causal = causal;
    a.rows = (h / hkv) * sq;
    a.split_keys = split_keys;
    a.parts = 1;
    a.scale_log2 = LOG2E / sqrtf((float)d);
    if (tiling == SPLIT && (part_o == nullptr || part_ml == nullptr))
      return (int)cudaErrorInvalidValue;
    return d == 64
               ? launch_mma<64>(a, b, tiling, splits, key_groups,
                                (cudaStream_t)stream)
               : launch_mma<128>(a, b, tiling, splits, key_groups,
                                 (cudaStream_t)stream);
  }
  if (splits != 1 || key_groups != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, out, kv, b, h, hkv, sq, sk, d, causal,
                         tiling, nh, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, kv, b, h, hkv, sq, sk, d,
                                 causal, tiling, nh, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
