// K1: multi-lane UVM replay for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/uvm/backends/pallas_backend.py::
// _lane_replay_fn (inner `kernel`, pl.pallas_call of the lane grid) for the
// demand (none/block) and learned lane families under LRU eviction, with
// shared-capacity tenancy (the tenant-0 hit count).  Tree, oracle, the
// random/hotcold policies, step clocks and tenant quotas are later work.
//
// One thread block per lane (one sweep cell).  One thread replays the lane's
// accesses in order -- hit / late / fault classification, the float64 clock,
// the far-fault window, PCIe queueing, the 16-page block DMA, the learned
// decision stream with its inference-server gate, the MSHR trim -- and the
// whole block joins each eviction's victim search: the lowest LRU stamp
// among resident pages, first index on ties (jnp.argmin's rule).
//
// Bound: latency.  Each access depends on the clock and the page state the
// previous one left, so a lane is one long dependent chain; the bytes moved
// and the operations are tiny next to its length.  Lanes run concurrently
// on separate SMs; the block-wide victim scan is the only parallel work.
//
// Exactness: the reference engines round every float64 product before the
// dependent add.  Every step of the clock chain is written with
// __dadd_rn/__dmul_rn, which nvcc never contracts into an FMA, and the file
// is built with --fmad=false as well.  CPython's float floor division in the
// far-fault window is emulated with fmod exactly as the reference does.
//
// Lane state lives in device memory the wrapper allocates: arrival (f64,
// +inf = not resident), stamp (i32 LRU touch stamp), pfu (u8
// prefetched-and-unused), and the MSHR buffer of buf_len = mshr + 1 f64.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define N_FPARAMS 8   // cpa, page_tx, far_fault, ptw, pcie_lat, pfo, extra, page_size
#define N_IPARAMS 9   // n, device_pages (-1 = uncapped), mshr, has_block, n_ft,
                      // lane lo mod 2^32, tenant boundary, q0, q1
#define N_STATS 10    // STAT_FIELDS + hits_t0
#define THREADS 512
#define BLK_PAGES 16
#define IMAX 0x7fffffff

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

__global__ void __launch_bounds__(THREADS)
lane_replay_kernel(const int* __restrict__ pages, const int* __restrict__ preds,
                   const double* __restrict__ fparams,
                   const int* __restrict__ iparams, double* arrival_all,
                   int* stamp_all, unsigned char* pfu_all, double* buf_all,
                   double* __restrict__ out, int t_max, int span, int buf_len,
                   int learned) {
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const double INF = __longlong_as_double(0x7ff0000000000000LL);
  double* arrival = arrival_all + (size_t)lane * span;
  int* stamp = stamp_all + (size_t)lane * span;
  unsigned char* pfu = pfu_all + (size_t)lane * span;
  double* buf = buf_all + (size_t)lane * buf_len;
  const int* lp = pages + (size_t)lane * t_max;
  const int* lpred = learned ? preds + (size_t)lane * t_max : nullptr;
  const double* fp = fparams + (size_t)lane * N_FPARAMS;
  const int* ip = iparams + (size_t)lane * N_IPARAMS;

  for (int i = tid; i < span; i += THREADS) {
    arrival[i] = INF;
    stamp[i] = 0;
    pfu[i] = 0;
  }
  for (int i = tid; i < buf_len; i += THREADS) buf[i] = INF;
  __syncthreads();

  const double cpa = fp[0], page_tx = fp[1], ff = fp[2], ptw = fp[3];
  const double pcie_lat = fp[4], pfo = fp[5], extra_lat = fp[6];
  const double page_size = fp[7];
  const int n = ip[0], cap = ip[1], mshr = ip[2];
  const bool has_block = ip[3] > 0;
  const int bnd = ip[6];

  __shared__ unsigned long long s_red[THREADS / 32];

  // the scalar carries live in thread 0's registers
  double clock = 0.0, pcie_free = 0.0, next_free = 0.0;
  int counter = 0, resident = 0, nbuf = 0, hits = 0, late = 0, faults = 0;
  int issued = 0, used = 0, migrated = 0, evicted = 0, wbacks = 0, th0 = 0;

  for (int t = 0; t < n; ++t) {
    bool need_victim = false;
    if (tid == 0) {
      const int p = lp[t];
      clock = add_rn(clock, cpa);
      const double a = arrival[p];
      const bool is_res = a < INF;
      const bool is_hit = is_res && a <= clock;
      const bool is_late = is_res && !is_hit;
      const bool is_fault = !is_res;
      hits += is_hit;
      late += is_late;
      faults += is_fault;
      th0 += is_hit && p < bnd;
      used += pfu[p];
      pfu[p] = 0;

      double arr_v = 0.0;
      if (is_fault) {
        // far-fault service window: CPython's float floor division
        const double mod = fmod(clock, ff);
        const double div = __ddiv_rn(sub_rn(clock, mod), ff);
        double fd = floor(div);
        if (sub_rn(div, fd) > 0.5) fd = add_rn(fd, 1.0);
        const double ready = add_rn(mul_rn(add_rn(fd, 2.0), ff), ptw);
        const double start = fmax(ready, pcie_free);
        arr_v = add_rn(add_rn(start, pcie_lat), page_tx);
        arrival[p] = arr_v;
        resident += 1;
        migrated += 1;
        pcie_free = add_rn(start, page_tx);
      }
      stamp[p] = counter;   // demand insert or LRU retouch
      counter += 1;

      if (is_fault || is_late) {
        // outstanding-stall push into the first empty (+inf) slot
        int slot = 0;
        double best = buf[0];
        for (int j = 1; j < buf_len; ++j)
          if (buf[j] > best) { best = buf[j]; slot = j; }
        buf[slot] = is_fault ? arr_v : a;
        nbuf += 1;
      }

      if (is_fault && has_block) {
        // block DMA of the faulting 64 KB block's non-resident pages,
        // completing as one transfer
        const int blk = (p / BLK_PAGES) * BLK_PAGES;
        int k = 0;
        for (int j = 0; j < BLK_PAGES; ++j) k += arrival[blk + j] == INF;
        if (k > 0) {
          const double ex_ready = add_rn(add_rn(clock, pfo), extra_lat);
          const double ex_start = fmax(pcie_free, ex_ready);
          const double end = add_rn(ex_start, mul_rn((double)k, page_tx));
          const double ex_arr = add_rn(end, pcie_lat);
          int rank = 0;
          for (int j = 0; j < BLK_PAGES; ++j) {
            if (arrival[blk + j] == INF) {
              arrival[blk + j] = ex_arr;
              pfu[blk + j] = 1;
              stamp[blk + j] = counter + rank;
              rank += 1;
            }
          }
          counter += k;
          resident += k;
          migrated += k;
          issued += k;
          pcie_free = end;
        }
      }

      if (learned && clock >= next_free) {
        // serialized inference server: the access consumes the gate; a
        // valid, non-demand, non-resident top-1 prediction migrates
        next_free = add_rn(clock, extra_lat);
        const int pred = lpred[t];
        if (pred >= 0 && pred != p && arrival[pred] == INF) {
          const double ex_ready = add_rn(add_rn(clock, pfo), extra_lat);
          const double ex_start = fmax(pcie_free, ex_ready);
          const double end = add_rn(ex_start, page_tx);
          arrival[pred] = add_rn(end, pcie_lat);
          stamp[pred] = counter;
          pfu[pred] = 1;
          counter += 1;
          resident += 1;
          migrated += 1;
          issued += 1;
          pcie_free = end;
        }
      }

      // MSHR pressure: beyond mshr outstanding stalls the clock jumps to
      // the oldest completion (one pop suffices: <= 1 push per access)
      if (nbuf > mshr) {
        int mi = 0;
        double mv = buf[0];
        for (int j = 1; j < buf_len; ++j)
          if (buf[j] < mv) { mv = buf[j]; mi = j; }
        clock = fmax(clock, mv);
        buf[mi] = INF;
        nbuf -= 1;
      }
      need_victim = cap >= 0 && resident > cap;
    }

    // eviction under oversubscription: the whole block searches the LRU
    // victim; an in-flight victim is retouched at MRU and ends the loop
    while (__syncthreads_or(need_victim)) {
      unsigned long long best = ~0ULL;
      for (int i = tid; i < span; i += THREADS) {
        const unsigned int s = arrival[i] < INF ? (unsigned int)stamp[i] : IMAX;
        const unsigned long long key =
            ((unsigned long long)s << 32) | (unsigned int)i;
        best = key < best ? key : best;
      }
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_down_sync(0xffffffffu, best, off);
        best = o < best ? o : best;
      }
      if ((tid & 31) == 0) s_red[tid >> 5] = best;
      __syncthreads();
      if (tid == 0) {
        for (int w = 1; w < THREADS / 32; ++w) best = s_red[w] < best ? s_red[w] : best;
        const int vi = (int)(best & 0xffffffffULL);
        const double v_arr = arrival[vi];
        if (v_arr > clock) {
          stamp[vi] = counter;
          counter += 1;
          need_victim = false;
        } else {
          arrival[vi] = INF;
          pfu[vi] = 0;
          resident -= 1;
          evicted += 1;
          if (evicted % 2 == 0) {   // writeback: half the evictions dirty
            wbacks += 1;
            pcie_free = add_rn(pcie_free, page_tx);
          }
          need_victim = resident > cap;
        }
      }
    }
  }

  if (tid == 0) {
    // drain: every outstanding stall resolves
    if (nbuf > 0) {
      double tail = -INF;
      for (int j = 0; j < buf_len; ++j)
        if (buf[j] < INF) tail = fmax(tail, buf[j]);
      clock = fmax(clock, tail);
    }
    double* o = out + (size_t)lane * N_STATS;
    o[0] = clock;
    o[1] = hits;
    o[2] = late;
    o[3] = faults;
    o[4] = issued;
    o[5] = used;
    o[6] = migrated;
    o[7] = evicted;
    o[8] = mul_rn((double)(migrated + wbacks), page_size);
    o[9] = th0;
  }
}

extern "C" int lane_replay_launch(const int* pages, const int* preds,
                                  const double* fparams, const int* iparams,
                                  double* arrival, int* stamp,
                                  unsigned char* pfu, double* buf,
                                  double* out, int n_lanes, int t_max,
                                  int span, int buf_len, int learned,
                                  void* stream) {
  if (n_lanes <= 0) return (int)cudaSuccess;
  lane_replay_kernel<<<n_lanes, THREADS, 0, (cudaStream_t)stream>>>(
      pages, preds, fparams, iparams, arrival, stamp, pfu, buf, out, t_max,
      span, buf_len, learned);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
