// K2: HLSH masked attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hlsh_attention.py::_hlsh_kernel
// (built by hlsh_attention_pallas): online-softmax attention over key tiles
// with keep-masked Q and K rows.  A key tile whose keys are all erased needs
// no dot products: each of its logits is exactly 0, so it adds
// exp(-m) * n_keys to the denominator and exp(-m) * sum(v) to the numerator.
// The share map (output row gather) stays in the Python wrapper.
//
// Bound: on the predictor's path (B <= 4096, N = 30, D = 12, float32) the
// work is ~4*N*N*D = 43 kFLOP per row against 4*N*D*4 + N*4 = 5.9 kB moved,
// about 7 FLOP/byte, below the card's float32 ridge (67 TFLOP/s over
// 3.35 TB/s, about 20 FLOP/byte), so it is bound by bytes moved.  One block
// per (batch row, query tile of 32) stages its tiles in shared memory; at
// N = 30 one block holds the whole row, so each input is read once and the
// output written once.  No tensor cores (D = 12 is below a wgmma tile's
// depth) -- speed is later work.
//
// Any N, any D up to 128; the ragged last tile is masked.
#include <cuda_runtime.h>
#include <math.h>

#define TQ 32        // query rows per block
#define TK 32        // keys per tile
#define THREADS 128  // >= TK: one thread per key for the tile's kept count
#define MAX_D 128

__global__ void hlsh_attention_kernel(const float* __restrict__ q,
                                      const float* __restrict__ k,
                                      const float* __restrict__ v,
                                      const float* __restrict__ keep,
                                      float* __restrict__ out,
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
  const float* qb = q + row0 * d;
  const float* kb = k + row0 * d;
  const float* vb = v + row0 * d;
  const float* keepb = keep + row0;

  for (int e = tid; e < TQ * d; e += THREADS) {
    const int i = e / d, qi = q0 + i;
    sQ[e] = qi < n ? qb[(size_t)qi * d + e % d] * keepb[qi] : 0.f;
    sAcc[e] = 0.f;
  }
  if (tid < TQ) {
    sM[tid] = 0.f;   // zero logits always exist (every erased key is one)
    sL[tid] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < n; k0 += TK) {
    const int nk = min(TK, n - k0);
    const int kept = __syncthreads_count(tid < nk && keepb[k0 + tid] != 0.f);
    for (int e = tid; e < nk * d; e += THREADS) {
      const int j = e / d;
      const size_t src = (size_t)(k0 + j) * d + e % d;
      sV[e] = vb[src];
      if (kept) sK[e] = kb[src] * keepb[k0 + j];
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
    if (qi < n) out[(row0 + qi) * d + e % d] = sAcc[e] / fmaxf(sL[i], 1e-30f);
  }
}

extern "C" int hlsh_attention_launch(const float* q, const float* k,
                                     const float* v, const float* keep,
                                     float* out, int b, int n, int d,
                                     void* stream) {
  if (b <= 0 || n <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > MAX_D) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(2 * TQ * d + 2 * TK * d + TQ * TK);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        hlsh_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(b, (n + TQ - 1) / TQ);
  hlsh_attention_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, keep, out, n, d, 1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
