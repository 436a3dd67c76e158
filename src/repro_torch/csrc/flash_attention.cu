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
// 3.35 TB/s, about 20 FLOP/byte): bound by bytes moved.  One block per
// (batch x head, query tile of 32) stages its query tile and each key/value
// tile in shared memory as float32 (scalar loads: D = 50 rows are not 16-byte
// aligned), so each input is read once per query tile and the output written
// once.  Under the causal mask, key tiles past the tile's last query are
// skipped (their probabilities are exactly 0).  No tensor cores: a simple
// kernel that is right comes first; wgmma and TMA are later work.
//
// Any Sq, Sk >= 1 and any D up to 128; the ragged last tiles are masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#define TQ 32        // query rows per block
#define TK 32        // keys per tile
#define THREADS 128
#define MAX_D 128
#define NEG_INF_MASK (-1e30f)  // the reference's causal fill value

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
__global__ void flash_attention_kernel(const T* __restrict__ q,
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

  for (int e = tid; e < TQ * d; e += THREADS) {
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
    for (int e = tid; e < nk * d; e += THREADS) {
      const size_t src = (size_t)k0 * d + e;
      sK[e] = to_f32(kb[src]);
      sV[e] = to_f32(vb[src]);
    }
    __syncthreads();
    for (int e = tid; e < TQ * TK; e += THREADS) {
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
    for (int e = tid; e < TQ * d; e += THREADS) {
      const int i = e / d, c = e % d;
      const float* prow = sS + i * TK;
      float acc = sAcc[e] * sAlpha[i];
      for (int j = 0; j < nk; ++j) acc += prow[j] * sV[j * d + c];
      sAcc[e] = acc;
    }
    __syncthreads();
  }

  T* ob = out + (size_t)bh * sq * d;
  for (int e = tid; e < TQ * d; e += THREADS) {
    const int i = e / d, qi = q0 + i;
    if (qi < sq)
      ob[(size_t)q0 * d + e] = from_f32<T>(sAcc[e] / fmaxf(sL[i], 1e-30f));
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int b, int h, int hkv, int sq, int sk, int d, int causal,
                  void* stream) {
  if (b <= 0 || sq <= 0) return (int)cudaSuccess;
  if (sk <= 0 || d <= 0 || d > MAX_D || hkv <= 0 || h % hkv != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (size_t)(2 * TQ * d + 2 * TK * d + TQ * TK);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(b * h, (sq + TQ - 1) / TQ);
  flash_attention_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, h, hkv, sq, sk, d,
      1.0f / sqrtf((float)d), causal);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int h,
                                      int hkv, int sq, int sk, int d,
                                      int causal, int dtype, void* stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, out, b, h, hkv, sq, sk, d, causal, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, b, h, hkv, sq, sk, d, causal,
                                 stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
