// K1: multi-lane UVM replay for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/uvm/backends/pallas_backend.py::
// _lane_replay_fn (inner `kernel`, pl.pallas_call of the lane grid): every
// lane family -- demand (none/block), tree (the UVMSmart baseline), learned
// and oracle -- under the lru, random and hotcold eviction policies, with
// the kernel's two optional branches: step-clock capture (the replay clock
// after the last access of each step window) and two-tenant tenancy, shared
// (the tenant-0 hit count) or split by hard per-tenant quotas.
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
//   * each eviction's victim search (warp 0 alone): the minimum policy key
//     among resident pages, first index on ties (jnp.argmin's rule) -- lru
//     the touch stamp, random (prio << 21) | slot with prio the insert-time
//     uint32 hash draw, hotcold (freq << 32) | stamp with freq the touches
//     since migration.
//
// The victim search reads a summary, not the span.  The span is cut into
// chunks of 512 slots (a root window each), and the block keeps in shared
// memory a lower bound of each chunk's least key over its resident slots.
// Three facts make the bounds cheap and exact:
//   * a resident page's key only grows until it is evicted: an lru retouch
//     takes the monotone counter, hotcold adds to freq and takes a new
//     stamp, random's prio is drawn once at insertion; so only an insertion
//     can set a lower key, and every insertion site lowers its chunk's
//     bound (thread 0 for demand, block DMA and learned pages, atomicMin in
//     the tree emission and the oracle takes), while a retouch or an
//     eviction leaves the bound valid as it is;
//   * stamps are unique among resident pages (each is the counter, or the
//     counter plus a rank below the k it then advances by), and the lru and
//     random keys carry the slot, so two resident pages never tie;
//   * a tenant's slot range [0, bnd) or [bnd, span) is a whole number of
//     chunks: the tenant boundary is root-aligned (the wrapper checks it).
// Warp 0 searches, with no block barrier: the other warps wait at the
// next access's block phase.  A search starts at the chunk the last one
// ended in.  One warp reduction scans that chunk exactly (16 slots a lane)
// and finds the least (bound, chunk) among the other chunks of the range;
// the chunk's bound becomes its exact minimum, and the search stops when
// that minimum is below every other bound (ties to the lower chunk), else
// moves to the chunk of the least bound.  The victim is then the exact
// minimum key of the range, as a scan of every slot gives it.  A search
// costs a few warp reductions, whatever the span; a chunk's slots are read
// once more after each retouch burst or eviction in it.
//
// Bound: latency.  Each access depends on the clock and the page state the
// previous one left, so a lane is one long dependent chain; the bytes moved
// and the operations are tiny next to its length.  Lanes run concurrently on
// separate SMs; the window classify and the prefix counts are the block's
// parallel work, each a few barriers long, and the victim search warp 0's.
// Family, policy and the quota eviction are template parameters, so each
// kernel carries only its own branches; step capture is one predicated
// store per access, taken when the wrapper passes a window-clock buffer.
// Where the wrapper passes a lane_info buffer, thread 0 writes each lane's
// chunk scans and its nanoseconds on the global timer there.
//
// Step clocks: each access carries its window id (sids); thread 0 stores the
// clock after the MSHR trim -- final for the access, eviction never moves
// it -- into steps[sid], so a window keeps the clock after its last access
// (the legacy recording point).  Slot steps_len is the trash slot of
// accesses past the last bound.  Empty windows are never written; the host
// forward-fills them.
//
// Tenant quotas: a quota lane (q0 >= 0) keeps rc0, the resident pages of
// tenant 0 (dense slots below the tenant boundary bnd), at every insertion
// and eviction.  Eviction runs while either tenant holds more than its
// allowance (its quota plus the spill pool the co-tenant does not borrow),
// trims tenant 0 first, and scans only the over-allowance tenant's slots,
// the contiguous range [0, bnd) or [bnd, span) clamped to the lane's span
// (bnd may lie outside it when the lane touches one tenant only).
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
// Lane state lives in device memory the wrapper allocates (the chunk bounds,
// (span + 511) / 512 of them, in dynamic shared memory): arrival (f64,
// +inf = not resident), stamp (i32 touch stamp), pfu (u8
// prefetched-and-unused), freq (i32, hotcold), prio (u32, random), the tree's
// per-level node counts (span >> (4 + lv) i32 for lv = 0..5), the MSHR
// buffer of buf_len = mshr + 1 f64, and the steps_len + 1 f64 window clocks.
// Oracle lanes carry one more state slot, the trash slot at index span:
// padded first-touch entries point there, it reads resident and is never a
// victim.
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

typedef unsigned long long u64;

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

// The victim key of a resident slot (the least is evicted): lru
// (stamp << 32) | slot, random (prio << 21) | slot, hotcold
// (freq << 32) | stamp with the slot beside it.
template <int POLICY>
__device__ __forceinline__ u64 victim_key(int slot, int stamp, int freq,
                                          unsigned prio) {
  if (POLICY == POL_RANDOM) return ((u64)prio << 21) | (unsigned)slot;
  if (POLICY == POL_HOTCOLD)
    return ((u64)(unsigned)freq << 32) | (unsigned)stamp;
  return ((u64)(unsigned)stamp << 32) | (unsigned)slot;
}

// (k, i) = the lesser of (k, i) and (ok, oi), key first, then index
__device__ __forceinline__ void min_pair(u64& k, int& i, u64 ok, int oi) {
  if (ok < k || (ok == k && oi < i)) {
    k = ok;
    i = oi;
  }
}

// The warp's least (ka, ia) and least (kb, ib), in every lane
__device__ __forceinline__ void warp_min2(u64& ka, int& ia, u64& kb, int& ib) {
  for (int off = 16; off > 0; off >>= 1) {
    min_pair(ka, ia, __shfl_xor_sync(FULL, ka, off),
             __shfl_xor_sync(FULL, ia, off));
    min_pair(kb, ib, __shfl_xor_sync(FULL, kb, off),
             __shfl_xor_sync(FULL, ib, off));
  }
}

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct Shared {
  double clock, pcie_free;
  int counter, p, fault;
  int ev_lo, ev_hi;   // slot range of the current victim search
};

// Per-tenant quota allowances (repro.uvm.eviction.Tenancy.allowed in int32):
// true while a tenant is over its allowance; *tenant0 = whether tenant 0 is
// (it is trimmed first).
__device__ __forceinline__ bool over_allowance(int resident, int rc0, int cap,
                                               int q0, int q1, bool* tenant0) {
  const int rc1 = resident - rc0;
  const int spill = cap - q0 - q1;
  const int a0 = q0 + max(0, spill - max(0, rc1 - q1));
  const int a1 = q1 + max(0, spill - max(0, rc0 - q0));
  *tenant0 = rc0 > a0;
  return rc0 > a0 || rc1 > a1;
}

template <int FAMILY, int POLICY, bool QUOTAS>
__global__ void __launch_bounds__(THREADS)
lane_replay_kernel(const int* __restrict__ pages, const int* __restrict__ preds,
                   const int* __restrict__ ft_all, const int* __restrict__ pos_all,
                   const int* __restrict__ sids_all,
                   const double* __restrict__ fparams,
                   const int* __restrict__ iparams, double* arrival_all,
                   int* stamp_all, unsigned char* pfu_all, int* freq_all,
                   unsigned* prio_all, int* counts_all, double* buf_all,
                   double* __restrict__ out, double* steps_all,
                   long long* __restrict__ lane_info, int t_max, int span,
                   int buf_len, int ft_len, int lookahead, int steps_len) {
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const u64 t_begin = tid == 0 && lane_info ? global_ns() : 0;
  // lower bounds of each chunk's least victim key (~0: nothing resident)
  extern __shared__ u64 bound[];
  const int n_chunks = (span + ROOT_PAGES - 1) / ROOT_PAGES;
  for (int c = tid; c < n_chunks; c += THREADS) bound[c] = ~0ULL;
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
  // window clocks: null when the batch captures none
  const int* lsid = steps_all ? sids_all + (size_t)lane * t_max : nullptr;
  double* steps = steps_all ? steps_all + (size_t)lane * (steps_len + 1) : nullptr;
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
  if (steps)
    for (int i = tid; i <= steps_len; i += THREADS) steps[i] = 0.0;
  __syncthreads();

  const double cpa = fp[0], page_tx = fp[1], ff = fp[2], ptw = fp[3];
  const double pcie_lat = fp[4], pfo = fp[5], extra_lat = fp[6];
  const double page_size = fp[7];
  const int n = ip[0], cap = ip[1], mshr = ip[2];
  const bool has_block = ip[3] > 0;
  const int n_ft = ip[4];
  const unsigned lane_lo = (unsigned)ip[5];
  const int bnd = ip[6];
  // quota lanes: q0 >= 0 (q0 = -1 is shared capacity)
  const int q0 = ip[7], q1 = ip[8];
  const bool split = QUOTAS && cap >= 0 && q0 >= 0;

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
  // the tenant boundary clamped into the scanned slots
  const int bnd_slot = min(max(bnd, 0), scan_end);
  // thread 0: whether the lane must evict, and for a quota lane the slots
  // of the tenant to trim (published in sh before the search's barrier)
  auto next_victim = [&](int resident_, int rc0_) -> bool {
    if (!split) return cap >= 0 && resident_ > cap;
    bool tenant0;
    if (!over_allowance(resident_, rc0_, cap, q0, q1, &tenant0)) return false;
    sh.ev_lo = tenant0 ? 0 : bnd_slot;
    sh.ev_hi = tenant0 ? bnd_slot : scan_end;
    return true;
  };

  // the scalar carries live in thread 0's registers; thread 0 publishes the
  // ones a block phase reads in `sh` before it
  double clock = 0.0, pcie_free = 0.0, next_free = 0.0;
  int counter = 0, resident = 0, nbuf = 0, hits = 0, late = 0, faults = 0;
  int issued = 0, used = 0, migrated = 0, evicted = 0, wbacks = 0, th0 = 0;
  int rc0 = 0;   // quota lanes: resident pages of tenant 0
  // the victim search (warp 0): the chunk it starts at (the last one's)
  // and (thread 0) the chunks it scanned
  int cur = 0;
  long long scans = 0;

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
        if (QUOTAS) rc0 += p < bnd;
        migrated += 1;
        pcie_free = add_rn(start, page_tx);
        if (tree) {
          // on_migrate([demand]) runs before on_fault
          // (atomic adds: the six updates go out without waiting on each
          // other's read; the block phase reads them after a barrier)
          for (int lv = 0; lv <= TREE_LEVELS; ++lv) atomicAdd(&counts[lv_off[lv] + (p >> (4 + lv))], 1);
        }
      } else if (hotcold) {
        freq[p] += 1;
      }
      stamp[p] = counter;   // demand insert or retouch
      if (is_fault) {
        const u64 key = victim_key<POLICY>(p, counter, 0, randomp ? prio[p] : 0u);
        if (key < bound[p / ROOT_PAGES]) bound[p / ROOT_PAGES] = key;
      }
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
              const u64 key = victim_key<POLICY>(q, counter + rank, 0, randomp ? prio[q] : 0u);
              if (key < bound[q / ROOT_PAGES]) bound[q / ROOT_PAGES] = key;
              rank += 1;
            }
          }
          counter += k;
          resident += k;
          // the 64 KB block lies on the faulting page's side of the
          // (root-aligned) tenant boundary
          if (QUOTAS && p < bnd) rc0 += k;
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
          const u64 key = victim_key<POLICY>(pred, counter, 0, randomp ? prio[pred] : 0u);
          if (key < bound[pred / ROOT_PAGES]) bound[pred / ROOT_PAGES] = key;
          counter += 1;
          resident += 1;
          if (QUOTAS) rc0 += pred < bnd;
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
        u64 key = ~0ULL;
        if (emit) {
          const int s = sh.counter + rank;
          arrival[g] = add_rn(end, pcie_lat);
          pfu[g] = 1;
          stamp[g] = s;
          if (hotcold) freq[g] = 0;
          if (randomp) prio[g] = rand_score(lane_lo + (unsigned)g, (unsigned)s);
          key = victim_key<POLICY>(g, s, 0, randomp ? prio[g] : 0u);
        }
        // the root window is one chunk: its bound takes the least new key
        for (int off = 16; off > 0; off >>= 1) {
          const u64 ok = __shfl_xor_sync(FULL, key, off);
          key = ok < key ? ok : key;
        }
        if ((tid & 31) == 0 && key != ~0ULL) atomicMin(&bound[root / ROOT_PAGES], key);
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
          // the 2 MB root window lies on the faulting page's side
          if (QUOTAS && p < bnd) rc0 += k;
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
        const bool take = nonres && pre <= ORACLE_MAX_EXTRAS;
        // a lookahead window can straddle the tenant boundary: count the
        // tenant-0 insertions entry by entry
        const int k0 = QUOTAS ? __syncthreads_count(take && idx < bnd) : 0;
        if (take) {
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
          atomicMin(&bound[idx / ROOT_PAGES],
                    victim_key<POLICY>(idx, s, 0, randomp ? prio[idx] : 0u));
        }
        __syncthreads();
        if (tid == 0) {
          counter += k;
          resident += k;
          rc0 += k0;
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
      if (steps) steps[lsid[t]] = clock;
      need_victim = next_victim(resident, rc0);
    }

    // eviction under oversubscription: warp 0 searches the victim over
    // the chunk bounds and thread 0 evicts it, with no block barrier (the
    // other warps wait at the next access's block phase, or the end); an
    // in-flight victim is retouched at MRU and ends the loop
    if (tid < 32) {
      __syncwarp();   // thread 0's insertions and range are visible
      while (__shfl_sync(FULL, need_victim, 0)) {
        const int ev_lo = split ? sh.ev_lo : 0;
        const int ev_hi = split ? sh.ev_hi : scan_end;
        const int c_lo = ev_lo / ROOT_PAGES;
        const int c_hi = ev_hi > ev_lo ? (ev_hi + ROOT_PAGES - 1) / ROOT_PAGES : c_lo;
        if (cur < c_lo || cur >= c_hi) cur = c_lo;
        int vi;
        for (;;) {
          // chunk `cur` exactly, 16 slots a lane, every load in flight at
          // once (the scan stops at the lane's own span, so never at the
          // oracle's trash slot); a lane's slots rise, so the first index
          // wins its ties
          u64 ka = ~0ULL;
          int ia = IMAX;
#pragma unroll 8
          for (int r = 0; r < ROOT_PAGES / 32; ++r) {
            const int i = cur * ROOT_PAGES + r * 32 + tid;
            if (i < ev_hi) {
              const double a = arrival[i];
              const u64 key = victim_key<POLICY>(
                  i, stamp[i], hotcold ? freq[i] : 0, randomp ? prio[i] : 0u);
              if (a < INF && key < ka) {
                ka = key;
                ia = i;
              }
            }
          }
          // the least bound of the other chunks; chunk c is lane c % 32's,
          // which alone reads and writes it in a search (four reads in
          // flight at once, each lane's chunks in rising order)
          u64 kb = ~0ULL;
          int ib = IMAX;
          for (int c0 = tid; c0 < c_hi; c0 += 4 * 32) {
            u64 bv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              bv[j] = c0 + 32 * j < c_hi ? bound[c0 + 32 * j] : ~0ULL;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = c0 + 32 * j;
              if (c >= c_lo && c != cur && bv[j] < kb) {
                kb = bv[j];
                ib = c;
              }
            }
          }
          warp_min2(ka, ia, kb, ib);
          scans += 1;
          if (tid == cur % 32) bound[cur] = ka;   // exact now
          if (ka < kb || (ka == kb && cur < ib) || ib == IMAX) {
            vi = ia;
            break;
          }
          cur = ib;
        }
        if (tid == 0) {
          // the range holds a resident page: the lane is over its capacity,
          // or the tenant over its allowance
          if (arrival[vi] > clock) {
            stamp[vi] = counter;
            if (hotcold) freq[vi] += 1;
            counter += 1;
            need_victim = false;
          } else {
            arrival[vi] = INF;
            pfu[vi] = 0;
            resident -= 1;
            if (QUOTAS) rc0 -= vi < bnd;
            evicted += 1;
            if (tree) {
              for (int lv = 0; lv <= TREE_LEVELS; ++lv) atomicSub(&counts[lv_off[lv] + (vi >> (4 + lv))], 1);
            }
            if (evicted % 2 == 0) {   // writeback: half the evictions dirty
              wbacks += 1;
              pcie_free = add_rn(pcie_free, page_tx);
            }
            need_victim = next_victim(resident, rc0);
          }
        }
        __syncwarp();   // thread 0's stores and range are visible
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
    if (lane_info) {
      lane_info[2 * lane] = scans;
      lane_info[2 * lane + 1] = (long long)(global_ns() - t_begin);
    }
  }
}

extern "C" int lane_replay_launch(const int* pages, const int* preds,
                                  const int* ft, const int* pos,
                                  const int* sids, const double* fparams,
                                  const int* iparams, double* arrival,
                                  int* stamp, unsigned char* pfu, int* freq,
                                  unsigned* prio, int* counts, double* buf,
                                  double* out, double* steps,
                                  long long* lane_info, int n_lanes,
                                  int t_max, int span, int buf_len,
                                  int family, int policy, int ft_len,
                                  int lookahead, int steps_len, int quotas,
                                  void* stream) {
  if (n_lanes <= 0) return (int)cudaSuccess;
  if (family < 0 || family > FAM_ORACLE || policy < 0 || policy > POL_HOTCOLD ||
      span < 1 || span > (1 << 21) || steps_len < 0 ||
      (steps_len > 0) != (steps != nullptr && sids != nullptr))
    return (int)cudaErrorInvalidValue;
  // one specialisation per (family, policy, quotas): the branches of the
  // other families and policies, and the quota eviction where no lane has
  // quotas, are compiled out
  typedef void (*Kernel)(const int*, const int*, const int*, const int*,
                         const int*, const double*, const int*, double*, int*,
                         unsigned char*, int*, unsigned*, int*, double*,
                         double*, double*, long long*, int, int, int, int,
                         int, int);
#define K1_ROW(F, Q) {lane_replay_kernel<F, POL_LRU, Q>, \
                      lane_replay_kernel<F, POL_RANDOM, Q>, \
                      lane_replay_kernel<F, POL_HOTCOLD, Q>}
  static const Kernel kernels[2][4][3] = {
      {K1_ROW(FAM_DEMAND, false), K1_ROW(FAM_TREE, false),
       K1_ROW(FAM_LEARNED, false), K1_ROW(FAM_ORACLE, false)},
      {K1_ROW(FAM_DEMAND, true), K1_ROW(FAM_TREE, true),
       K1_ROW(FAM_LEARNED, true), K1_ROW(FAM_ORACLE, true)}};
#undef K1_ROW
  // the chunk bounds: at most 2^21 / 512 = 4,096 of them, 32 KB
  const size_t smem = sizeof(u64) * ((span + ROOT_PAGES - 1) / ROOT_PAGES);
  kernels[quotas ? 1 : 0][family][policy]<<<n_lanes, THREADS, smem,
                                            (cudaStream_t)stream>>>(
      pages, preds, ft, pos, sids, fparams, iparams, arrival, stamp, pfu,
      freq, prio, counts, buf, out, steps, lane_info, t_max, span, buf_len,
      ft_len, lookahead, steps_len);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
