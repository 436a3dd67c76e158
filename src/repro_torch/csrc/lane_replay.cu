// K1: multi-lane UVM replay for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/uvm/backends/pallas_backend.py::
// _lane_replay_fn (inner `kernel`, pl.pallas_call of the lane grid) for every
// single-tenant lane family -- demand (none/block), tree (the UVMSmart
// baseline), learned and oracle -- under the lru, random and hotcold
// eviction policies, with shared-capacity tenancy (the tenant-0 hit count).
// Step clocks and tenant quotas are later work.
//
// One thread block per lane (one sweep cell).  Thread 0 replays the lane's
// accesses in order -- hit / late / fault classification, the float64 clock,
// the far-fault window, PCIe queueing, the 16-page block DMA, the learned
// decision stream with its inference-server gate, the MSHR trim.  The whole
// block (THREADS = 512 = one 2 MB root window) joins the work that is wide:
//   * a tree fault: one thread per page of the root window classifies it,
//     __syncthreads_count gives each level's node occupancy, and block prefix
//     counts rank the extras of each level in ascending page order (the
//     legacy emission order, which sets the LRU stamps);
//   * an oracle access: one thread per entry of the lookahead window of the
//     first-touch stream; a block prefix count keeps the first 16 non-resident
//     pages in stream order.  A fault scans twice (batch DMA, then the
//     continuous scan with the sequential t += page_tx arrival chain), the
//     second scan after the first's insertions;
//   * each eviction's victim search: the minimum policy key among resident
//     pages, first index on ties (jnp.argmin's rule) -- lru the touch stamp,
//     random (prio << 21) | slot with prio the insert-time uint32 hash draw,
//     hotcold (freq << 32) | stamp with freq the touches since migration.
//
// Bound: latency.  Each access depends on the clock and the page state the
// previous one left, so a lane is one long dependent chain; the bytes moved
// and the operations are tiny next to its length.  Lanes run concurrently on
// separate SMs; the window classify, the prefix counts and the victim scan
// are the block's parallel work, each a few barriers long.  The victim scan
// is the one piece that grows with the state: it reads every slot of the
// lane's own span (not the batch's padded span) once per eviction.  Family
// and policy are template parameters, so each (family, policy) kernel
// carries only its own branches.
//
// Exactness: the reference engines round every float64 product before the
// dependent add.  Every step of the clock chain is written with
// __dadd_rn/__dmul_rn, which nvcc never contracts into an FMA, and the file
// is built with --fmad=false as well.  CPython's float floor division in the
// far-fault window is emulated with fmod exactly as the reference does.
// Stamps and the touch counter are int32: the host caps tree lanes at 2^21
// accesses (a tree fault can stamp a whole root window) and the others at
// 2^24.
//
// Lane state lives in device memory the wrapper allocates: arrival (f64,
// +inf = not resident), stamp (i32 touch stamp), pfu (u8
// prefetched-and-unused), freq (i32, hotcold), prio (u32, random), the tree's
// per-level node counts (span >> (4 + lv) i32 for lv = 0..5), and the MSHR
// buffer of buf_len = mshr + 1 f64.  Oracle lanes carry one more state slot,
// the trash slot at index span: padded first-touch entries point there, it
// reads resident and is never a victim.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define N_FPARAMS 8   // cpa, page_tx, far_fault, ptw, pcie_lat, pfo, extra, page_size
#define N_IPARAMS 9   // n, device_pages (-1 = uncapped), mshr, has_block, n_ft,
                      // lane lo mod 2^32, tenant boundary, q0, q1
#define N_STATS 10    // STAT_FIELDS + hits_t0
#define THREADS 512
#define NWARPS (THREADS / 32)
#define BLK_PAGES 16
#define ROOT_PAGES 512
#define TREE_LEVELS 5
#define ORACLE_MAX_EXTRAS 16
#define IMAX 0x7fffffff
#define FULL 0xffffffffu

enum { FAM_DEMAND = 0, FAM_TREE = 1, FAM_LEARNED = 2, FAM_ORACLE = 3 };
enum { POL_LRU = 0, POL_RANDOM = 1, POL_HOTCOLD = 2 };

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// repro.uvm.eviction.eviction_scores: the uint32 wraparound hash chain
__device__ __forceinline__ unsigned rand_score(unsigned page, unsigned draw) {
  unsigned x = page ^ (draw * 0x9E3779B9u);
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0x735A2D97u;
  x ^= x >> 15;
  return x;
}

// Inclusive prefix count of `flag` over the block in thread order; every
// thread gets the block total in *total.  Contains two barriers.
__device__ __forceinline__ int block_prefix(bool flag, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(FULL, flag);
  const int incl = __popc(b & ((2u << lane) - 1u));
  if (lane == 0) s_warp[warp] = __popc(b);
  __syncthreads();
  int before = 0, tot = 0;
  for (int w = 0; w < NWARPS; ++w) {
    const int c = s_warp[w];
    before += w < warp ? c : 0;
    tot += c;
  }
  __syncthreads();
  *total = tot;
  return before + incl;
}

struct Shared {
  double clock, pcie_free;
  int counter, p, fault;
};

template <int FAMILY, int POLICY>
__global__ void __launch_bounds__(THREADS)
lane_replay_kernel(const int* __restrict__ pages, const int* __restrict__ preds,
                   const int* __restrict__ ft_all, const int* __restrict__ pos_all,
                   const double* __restrict__ fparams,
                   const int* __restrict__ iparams, double* arrival_all,
                   int* stamp_all, unsigned char* pfu_all, int* freq_all,
                   unsigned* prio_all, int* counts_all, double* buf_all,
                   double* __restrict__ out, int t_max, int span, int buf_len,
                   int ft_len, int lookahead) {
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const double INF = __longlong_as_double(0x7ff0000000000000LL);
  constexpr int family = FAMILY;
  constexpr bool oracle = FAMILY == FAM_ORACLE, tree = FAMILY == FAM_TREE;
  constexpr bool randomp = POLICY == POL_RANDOM, hotcold = POLICY == POL_HOTCOLD;
  const int state_len = oracle ? span + 1 : span;
  double* arrival = arrival_all + (size_t)lane * state_len;
  int* stamp = stamp_all + (size_t)lane * state_len;
  unsigned char* pfu = pfu_all + (size_t)lane * state_len;
  int* freq = hotcold ? freq_all + (size_t)lane * state_len : nullptr;
  unsigned* prio = randomp ? prio_all + (size_t)lane * state_len : nullptr;
  double* buf = buf_all + (size_t)lane * buf_len;
  const int* lp = pages + (size_t)lane * t_max;
  const int* lpred = family == FAM_LEARNED ? preds + (size_t)lane * t_max : nullptr;
  const int* lft = oracle ? ft_all + (size_t)lane * ft_len : nullptr;
  const int* lpos = oracle ? pos_all + (size_t)lane * t_max : nullptr;
  const double* fp = fparams + (size_t)lane * N_FPARAMS;
  const int* ip = iparams + (size_t)lane * N_IPARAMS;

  // tree: level lv's node counts start at counts + lv_off[lv]
  int* counts = nullptr;
  int lv_off[TREE_LEVELS + 1];
  if (tree) {
    int n_nodes = 0;
    for (int lv = 0; lv <= TREE_LEVELS; ++lv) {
      lv_off[lv] = n_nodes;
      n_nodes += span >> (4 + lv);
    }
    counts = counts_all + (size_t)lane * n_nodes;
    for (int i = tid; i < n_nodes; i += THREADS) counts[i] = 0;
  }
  for (int i = tid; i < state_len; i += THREADS) {
    const bool trash = i == span;
    arrival[i] = trash ? 0.0 : INF;
    stamp[i] = trash ? IMAX : 0;
    pfu[i] = 0;
    if (hotcold) freq[i] = 0;
    if (randomp) prio[i] = 0;
  }
  for (int i = tid; i < buf_len; i += THREADS) buf[i] = INF;
  __syncthreads();

  const double cpa = fp[0], page_tx = fp[1], ff = fp[2], ptw = fp[3];
  const double pcie_lat = fp[4], pfo = fp[5], extra_lat = fp[6];
  const double page_size = fp[7];
  const int n = ip[0], cap = ip[1], mshr = ip[2];
  const bool has_block = ip[3] > 0;
  const int n_ft = ip[4];
  const unsigned lane_lo = (unsigned)ip[5];
  const int bnd = ip[6];

  __shared__ unsigned long long s_key[NWARPS];
  __shared__ int s_idx[NWARPS];
  __shared__ int s_warp[NWARPS];
  __shared__ int s_hi;
  __shared__ Shared sh;

  // the lane's own span: every slot it can make resident lies in a root
  // window of its pages, predictions or first touches (block and tree
  // extras stay in the faulting page's root window), so victim scans stop
  // there instead of at the batch's padded span
  int hi = -1;
  for (int t = tid; t < n; t += THREADS) {
    hi = max(hi, lp[t]);
    if (family == FAM_LEARNED) hi = max(hi, lpred[t]);
  }
  if (oracle)
    for (int j = tid; j < n_ft; j += THREADS) hi = max(hi, lft[j]);
  if (tid == 0) s_hi = -1;
  __syncthreads();
  atomicMax(&s_hi, hi);
  __syncthreads();
  const int scan_end = min(span, (s_hi / ROOT_PAGES + 1) * ROOT_PAGES);

  // the scalar carries live in thread 0's registers; thread 0 publishes the
  // ones a block phase reads in `sh` before it
  double clock = 0.0, pcie_free = 0.0, next_free = 0.0;
  int counter = 0, resident = 0, nbuf = 0, hits = 0, late = 0, faults = 0;
  int issued = 0, used = 0, migrated = 0, evicted = 0, wbacks = 0, th0 = 0;

  for (int t = 0; t < n; ++t) {
    bool need_victim = false, faulted = false;
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
        if (hotcold) freq[p] = 0;     // touches since migration
        if (randomp) prio[p] = rand_score(lane_lo + (unsigned)p, (unsigned)counter);
        resident += 1;
        migrated += 1;
        pcie_free = add_rn(start, page_tx);
        if (tree) {
          // on_migrate([demand]) runs before on_fault
          for (int lv = 0; lv <= TREE_LEVELS; ++lv) counts[lv_off[lv] + (p >> (4 + lv))] += 1;
        }
      } else if (hotcold) {
        freq[p] += 1;
      }
      stamp[p] = counter;   // demand insert or retouch
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

      if ((family == FAM_DEMAND || family == FAM_LEARNED) && is_fault && has_block) {
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
            const int q = blk + j;
            if (arrival[q] == INF) {
              arrival[q] = ex_arr;
              pfu[q] = 1;
              stamp[q] = counter + rank;
              if (hotcold) freq[q] = 0;
              if (randomp) prio[q] = rand_score(lane_lo + (unsigned)q, (unsigned)(counter + rank));
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

      if (family == FAM_LEARNED && clock >= next_free) {
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
          if (hotcold) freq[pred] = 0;
          if (randomp) prio[pred] = rand_score(lane_lo + (unsigned)pred, (unsigned)counter);
          counter += 1;
          resident += 1;
          migrated += 1;
          issued += 1;
          pcie_free = end;
        }
      }
      faulted = is_fault;
      if (tree || oracle) {
        sh.p = p;
        sh.fault = is_fault;
        sh.clock = clock;
        sh.pcie_free = pcie_free;
        sh.counter = counter;
      }
    }

    if (tree && __syncthreads_or(faulted)) {
      // tree on_fault: classify the 2 MB root window (one thread per page),
      // then the >50% escalation walk level by level
      const int p = sh.p;
      const int root = (p / ROOT_PAGES) * ROOT_PAGES;
      const int rel = p - root, off = tid, g = root + off;
      const bool nonres = arrival[g] == INF;
      const bool m0 = (off >> 4) == (rel >> 4) && nonres;
      int total;
      const int pre0 = block_prefix(m0, s_warp, &total);
      int rank = m0 ? pre0 - 1 : 0;
      int k = total;
      bool pend = m0 || off == rel, emit = m0;
      for (int lv = 1; lv <= TREE_LEVELS; ++lv) {
        const int sh_lv = 4 + lv;
        const bool in_node = (off >> sh_lv) == (rel >> sh_lv);
        const int cnt = counts[lv_off[lv] + (root >> sh_lv) + (rel >> sh_lv)] +
                        __syncthreads_count(in_node && pend);
        if (cnt * 2 <= (BLK_PAGES << lv)) break;   // uniform over the block
        const bool ex = in_node && nonres && !pend;
        const int pre = block_prefix(ex, s_warp, &total);
        if (ex) rank = k + pre - 1;
        k += total;
        pend = pend || ex;
        emit = emit || ex;
      }
      if (k > 0) {   // uniform over the block
        const double ex_ready = add_rn(add_rn(sh.clock, pfo), extra_lat);
        const double ex_start = fmax(sh.pcie_free, ex_ready);
        const double end = add_rn(ex_start, mul_rn((double)k, page_tx));
        if (emit) {
          const int s = sh.counter + rank;
          arrival[g] = add_rn(end, pcie_lat);
          pfu[g] = 1;
          stamp[g] = s;
          if (hotcold) freq[g] = 0;
          if (randomp) prio[g] = rand_score(lane_lo + (unsigned)g, (unsigned)s);
        }
        // on_migrate of the batch: per-level node counts, warp-aggregated
        // (a warp's 32 pages share one node at every level >= 1)
        const unsigned b = __ballot_sync(FULL, emit);
        const int wl = tid & 31;
        if (wl == 0 || wl == 16) {
          const int c = __popc(wl == 0 ? (b & 0xffffu) : (b >> 16));
          if (c) atomicAdd(&counts[lv_off[0] + (g >> 4)], c);
        }
        if (wl == 0 && b) {
          for (int lv = 1; lv <= TREE_LEVELS; ++lv)
            atomicAdd(&counts[lv_off[lv] + (g >> (4 + lv))], __popc(b));
        }
        __syncthreads();
        if (tid == 0) {
          counter += k;
          resident += k;
          migrated += k;
          issued += k;
          pcie_free = end;
        }
      }
    }

    if (oracle) {
      // OraclePrefetcher: scan the lookahead window of the first-touch
      // stream; a fault scans twice, batch DMA first
      __syncthreads();
      const int pos_t = lpos[t];
      const bool is_fault = sh.fault;
      for (int pass = is_fault ? 0 : 1; pass < 2; ++pass) {
        const bool batch = pass == 0;
        bool nonres = false;
        int idx = span;
        if (tid < lookahead && pos_t + tid < n_ft) {
          idx = lft[pos_t + tid];
          nonres = arrival[idx] == INF;
        }
        int total;
        const int pre = block_prefix(nonres, s_warp, &total);
        const int k = total < ORACLE_MAX_EXTRAS ? total : ORACLE_MAX_EXTRAS;
        if (k == 0) continue;   // uniform over the block
        const double ex_ready = add_rn(add_rn(sh.clock, pfo), extra_lat);
        const double ex_start = fmax(sh.pcie_free, ex_ready);
        const double end = add_rn(ex_start, mul_rn((double)k, page_tx));
        if (nonres && pre <= ORACLE_MAX_EXTRAS) {
          const int rank = pre - 1;
          double arr;
          if (batch) {
            arr = add_rn(end, pcie_lat);
          } else {
            // the legacy t += page_tx chain, one add per earlier page
            double tv = ex_start;
            for (int r = 0; r <= rank; ++r) tv = add_rn(tv, page_tx);
            arr = add_rn(tv, pcie_lat);
          }
          const int s = sh.counter + rank;
          arrival[idx] = arr;
          stamp[idx] = s;
          pfu[idx] = 1;
          if (hotcold) freq[idx] = 0;
          if (randomp) prio[idx] = rand_score(lane_lo + (unsigned)idx, (unsigned)s);
        }
        __syncthreads();
        if (tid == 0) {
          counter += k;
          resident += k;
          migrated += k;
          issued += k;
          pcie_free = end;
          sh.counter = counter;
          sh.pcie_free = pcie_free;
        }
        __syncthreads();
      }
    }

    if (tid == 0) {
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

    // eviction under oversubscription: the whole block searches the
    // victim; an in-flight victim is retouched at MRU and ends the loop
    while (__syncthreads_or(need_victim)) {
      // lru keys (stamp << 32) | slot and random keys (prio << 21) | slot
      // carry the slot, so their minimum is the first index on ties; the
      // hotcold key (freq << 32) | stamp carries none, and its slot rides
      // beside it.  The scan stops at the lane's own span, so never at the
      // trash slot.
      unsigned long long best = ~0ULL;
      int bi = IMAX;
      for (int i = tid; i < scan_end; i += THREADS) {
        if (hotcold) {
          if (arrival[i] < INF) {
            const unsigned long long key =
                ((unsigned long long)(unsigned)freq[i] << 32) | (unsigned)stamp[i];
            if (key < best) { best = key; bi = i; }
          }
        } else {
          const unsigned long long key =
              !(arrival[i] < INF) ? ~0ULL
              : randomp ? ((unsigned long long)prio[i] << 21) | (unsigned)i
                        : ((unsigned long long)(unsigned)stamp[i] << 32) | (unsigned)i;
          best = key < best ? key : best;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long ok = __shfl_down_sync(FULL, best, off);
        if (hotcold) {
          const int oi = __shfl_down_sync(FULL, bi, off);
          if (ok < best || (ok == best && oi < bi)) { best = ok; bi = oi; }
        } else {
          best = ok < best ? ok : best;
        }
      }
      if ((tid & 31) == 0) {
        s_key[tid >> 5] = best;
        s_idx[tid >> 5] = bi;
      }
      __syncthreads();
      if (tid == 0) {
        for (int w = 1; w < NWARPS; ++w) {
          if (s_key[w] < best || (s_key[w] == best && s_idx[w] < bi)) {
            best = s_key[w];
            bi = s_idx[w];
          }
        }
        const int vi = hotcold ? bi
                       : (int)(best & (randomp ? 0x1fffffULL : 0xffffffffULL));
        const double v_arr = arrival[vi];
        if (v_arr > clock) {
          stamp[vi] = counter;
          if (hotcold) freq[vi] += 1;
          counter += 1;
          need_victim = false;
        } else {
          arrival[vi] = INF;
          pfu[vi] = 0;
          resident -= 1;
          evicted += 1;
          if (tree) {
            for (int lv = 0; lv <= TREE_LEVELS; ++lv) counts[lv_off[lv] + (vi >> (4 + lv))] -= 1;
          }
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
                                  const int* ft, const int* pos,
                                  const double* fparams, const int* iparams,
                                  double* arrival, int* stamp,
                                  unsigned char* pfu, int* freq,
                                  unsigned* prio, int* counts, double* buf,
                                  double* out, int n_lanes, int t_max,
                                  int span, int buf_len, int family,
                                  int policy, int ft_len, int lookahead,
                                  void* stream) {
  if (n_lanes <= 0) return (int)cudaSuccess;
  if (family < 0 || family > FAM_ORACLE || policy < 0 || policy > POL_HOTCOLD)
    return (int)cudaErrorInvalidValue;
  // one specialisation per (family, policy): the branches of the other
  // families and policies are compiled out
  typedef void (*Kernel)(const int*, const int*, const int*, const int*,
                         const double*, const int*, double*, int*,
                         unsigned char*, int*, unsigned*, int*, double*,
                         double*, int, int, int, int, int);
#define K1_ROW(F) {lane_replay_kernel<F, POL_LRU>, \
                   lane_replay_kernel<F, POL_RANDOM>, \
                   lane_replay_kernel<F, POL_HOTCOLD>}
  static const Kernel kernels[4][3] = {K1_ROW(FAM_DEMAND), K1_ROW(FAM_TREE),
                                       K1_ROW(FAM_LEARNED), K1_ROW(FAM_ORACLE)};
#undef K1_ROW
  kernels[family][policy]<<<n_lanes, THREADS, 0, (cudaStream_t)stream>>>(
      pages, preds, ft, pos, fparams, iparams, arrival, stamp, pfu, freq,
      prio, counts, buf, out, t_max, span, buf_len, ft_len, lookahead);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
