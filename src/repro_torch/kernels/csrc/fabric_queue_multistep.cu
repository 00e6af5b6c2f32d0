// Multi-step fabric kernel of the slot engine, hand-written for Hopper
// (sm_90a).  Replaces fabric_queue_multistep_pallas
// (src/repro/kernels/fabric_queue.py:238): one launch runs
// n = min(chunk, max_steps - base) whole micro-transactions of the slot
// engine on the packed carry of repro_torch.core.network._pack_slot_state,
// and updates that carry in place.  Semantics are those of
// repro_torch/kernels/ref.py::fabric_queue_multistep over
// core/network.py::_slot_step_body, bit for bit, on any carry.
//
// The TPU kernel takes the step as a traced closure; a CUDA kernel cannot,
// so this one carries the step itself, phase by phase:
//
//   A  queue scan (fabric_queue.cu's tie rule) and the xoff latch;
//   B  flow gate, stall telemetry, next-action bounds and the two
//      minimums of the conservative horizon;
//   C  the link micro-transaction (two-pass FSM settling of
//      protocol_sim.link_step), pop bookkeeping, the pop itself, the
//      switch count and the replication lanes;
//   D  delivery log (slot = log_n + exclusive prefix over links);
//   E  forward-slot assignment, appends and weighted drops;
//   F  n_ins += appends per queue.
//
// What bounds it on an H100.  The work is int32 control on a chain of
// dependent phases, 128 steps a launch, one block an instance, so
// latency does: each step is several hundred dependent instructions,
// shared-memory round trips and warp collectives on one SM.  The
// full-width scan's int32 operations (4·Q·C a step, 0.75 µs a 128-step
// launch at ring-16 full width) and the carry's bytes (0.2 µs) are far
// below it.  The first version spent ~5.8 µs a step at ring-16 full
// width (L = 16, C = 768): a warp a queue row scanned all C columns of
// q_time in L2, 1,024 threads met at six block barriers a step while 16
// of them worked, the link state and the tables sat in memory on the
// dependent chains, and the delivery prefix and the append offsets were
// serial loops.  The design cuts each of those:
//
//   1. A thread a link, holding its link's lane-plane state and its two
//      queues' private counters in registers for the whole launch; only
//      what other links or the scan read each step goes through shared
//      memory (the clock, n_ins, n_pop, xoff, busy_steps and q_drops,
//      and what the log and the appends read of the link).  Where every
//      link fits the first warp (L <= 32: every cell of the main path)
//      the link phases are that warp's alone, with __syncwarp between
//      them; two block barriers a step remain, around the scan.
//   2. The scan on the whole block (at least eight warps): S lanes a
//      row, S the largest power of two with S·Q <= threads, combined by
//      S-wide shuffles.  A row whose slots nothing popped or appended,
//      and whose clock has not gone back or reached its next release,
//      keeps its last results and is not read.
//   3. Live slots only.  Each row keeps a window [lo, hi) outside which
//      every column holds BIG_NS, and, from tier 1, a bitmap of its
//      columns that are not BIG_NS, both built from the data at launch
//      start (a thread a 32-column word) and kept up to date by pops and
//      appends.  The scan reads the window's columns, or the bitmap's
//      set bits where the window is mostly consumed slots, so its cost
//      follows the row's backlog, not the C columns.  With the clock
//      t < BIG_NS a column it skips is an unreleased BIG_NS, so the full
//      scan's results follow: count and minimum over the visited slots,
//      minimum BIG_NS at slot 0 when nothing is released, and BIG_NS as
//      the next release wherever the row has a BIG_NS column.  Where
//      t >= BIG_NS an empty slot counts as released, and the row is
//      scanned in full.  None of this leans on an invariant of the carry
//      (engine carries do keep every column >= n_ins at BIG_NS, as
//      tests/test_torch_fabric_multistep.py checks).
//   4. Shared memory for the launch, by tier, as far as it fits the
//      227 KB a block may opt in to (the wrapper picks the tier): tier 1
//      the read-only tables (route_out, route_wt, route_del) and the
//      bitmap; tier 2 also q_time; tier 3 also q_dest; tier 4 also
//      q_inj.  At ring-16 full width q_time and q_dest fit (tier 3).
//      Resident planes come in by Hopper's bulk copy (cp.async.bulk, one
//      a row, completion on an mbarrier) and go back the same way once,
//      at the end (rows whose bytes are not a multiple of 16 use plain
//      loads).  A plane's row pitch is C rounded up to 4 words and to 4
//      mod 8, so the same column of eight consecutive rows lies in eight
//      banks.
//   5. No serial prefixes: the delivery prefix is a __ballot_sync and
//      __popc a 32-link chunk; the append offsets a __match_any_sync on
//      the target queue and a popcount of the lower lanes, carried from
//      chunk to chunk in a per-queue count in shared memory, so appends
//      into one queue keep their (link, replica) order.  Sums over lanes
//      use shared-memory atomics, whose result does not depend on order;
//      the horizon is a __reduce_min_sync.
//   6. Loads only where a result reads them: q_dest at the popped slot
//      where a row has released slots, q_inj where a side is pending,
//      the replication tables where a link transmitted.
//
// What still binds it (PERF.md §7): about 2.8 µs a step at ring-16 full
// width on an H100 even where no row is rescanned, a chain of a few
// thousand cycles through the link phases of one warp.
//
// Tensor cores have no part here: the work is int32 control.  All
// arithmetic is int32 with wrap-around, as in the reference.  Grid: one
// block per instance (the leading batch axis B).  Plain C entry points
// (loaded with ctypes): pointers to int32 device memory, the CUDA stream,
// and cudaGetLastError() as the return value.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBigNs = 1 << 30;   // empty / consumed slot, "no arrival"
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kScanThreads = 256;   // the block's least threads
constexpr int kRx = 0;
constexpr int kTx = 1;
constexpr int kMaxTier = 4;

// lane plane channels, in core.network._MS_LANES order
enum Lane {
  kT, kLastDir, kBusBusy, kPrevTxL, kPrevTxR,
  kXlMode, kXlAck, kXlRxP, kXlBurst,
  kXrMode, kXrAck, kXrRxP, kXrBurst,
  kPrevModeL, kNSw, kBusyNs, kLanes
};
// side plane channels, in core.network._MS_SIDES order
enum Side {
  kNIns, kSent, kNPop, kXoff, kInStall, kStallSteps, kCreditWaits,
  kBusySteps, kQDrops, kSides
};
// shared scalars; the first four words hold the mbarrier (8-byte aligned)
enum Scalar { kMbar0, kMbar1, kPad0, kPad1, kLogN, kDrops, kHorizon,
              kHorizonCycle, kScalars };
// shared per-queue arrays: the carry's n_ins, q_drops, n_pop, xoff and
// busy_steps (which the scan, the gates, the appends and the drops of
// other links read or change), the live window [lo, hi), this step's
// forwards into the queue, the slots that are not BIG_NS (a count that
// only picks how a row is scanned), the scan's five results, and whether
// and at which clock they were last computed
enum QueueArr { kQaNIns, kQaDrops, kQaNPop, kQaXoff, kQaBusy, kQaLo, kQaHi,
                kQaFwd, kQaLive, kQaPend, kQaRmin, kQaNxt, kQaAmin,
                kQaRoute, kQaDirty, kQaTScan, kQueueArrs };
// shared per-link arrays: the clock, and what the log and the appends
// read of the link
enum LinkArr { kLaT, kLaRoute, kLaInj, kLaRx, kLaDeliver, kLinkArrs };
// shared per-lane (link, replica) arrays
enum LaneArr { kMaFwd, kMaFq, kMaWt, kMaApp, kLaneArrs };

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) -
                          static_cast<unsigned>(b));
}

// --- shared-memory layout (kept in step with kernels/fabric_queue.py) ----
//
// [scalars][per-queue][per-link][per-lane] rounded up to 4 words (tier 0);
// then the resident planes (tier - 1 of them, Q rows of plane_pitch(C)
// words each); then, from tier 1, the slot bitmap (Q rows of
// ceil(C / 32) words) and the tables.

__host__ __device__ constexpr int base_words(int n_links, int k) {
  return (kScalars + kQueueArrs * 2 * n_links + kLinkArrs * n_links +
          kLaneArrs * n_links * k + 3) / 4 * 4;
}

__host__ __device__ constexpr int plane_pitch(int n_cols) {
  return ((n_cols + 3) / 4 * 4) % 8 == 0 ? (n_cols + 3) / 4 * 4 + 4
                                         : (n_cols + 3) / 4 * 4;
}

__host__ __device__ constexpr long long bitmap_words(int n_links,
                                                     int n_cols) {
  return 2LL * n_links * ((n_cols + 31) / 32);
}

__host__ __device__ constexpr long long table_words(int n_chips,
                                                    int n_routes, int k) {
  return static_cast<long long>(n_chips) * n_routes * (2 * k + 1);
}

__host__ __device__ constexpr long long layout_bytes(int n_links, int k,
                                                     int n_cols, int n_chips,
                                                     int n_routes, int tier) {
  return 4 * (base_words(n_links, k) +
              (tier >= 2 ? static_cast<long long>(tier - 1) * 2 * n_links *
                               plane_pitch(n_cols)
                         : 0) +
              (tier >= 1 ? bitmap_words(n_links, n_cols) +
                               table_words(n_chips, n_routes, k)
                         : 0));
}

struct Xcvr {
  int mode, ack, rx_p, burst;
};

// One SW_Control evaluation (core/transceiver.py::step).
__device__ __forceinline__ Xcvr fsm(const Xcvr s, int sw_req,
                                    int tx_pending, int rx_strobe,
                                    int max_burst) {
  const bool is_rx = s.mode == kRx;
  const bool is_tx = !is_rx;
  const bool tx_p = tx_pending > 0;
  int rx_p = (is_rx && rx_strobe == 1) ? 1 : s.rx_p;
  const bool want_request = is_rx && tx_p && rx_p == 1;
  bool drained = !tx_p;
  if (max_burst > 0) drained = drained || s.burst >= max_burst;
  const bool want_grant = is_tx && sw_req == 1 && drained;
  const int ack = is_tx ? !want_grant : want_request;
  const int mode = (ack == 1 && sw_req == 0)   ? kTx
                   : (ack == 0 && sw_req == 1) ? kRx
                                               : s.mode;
  const bool switched = mode != s.mode;
  if (switched && mode == kRx) rx_p = 0;
  return Xcvr{mode, ack, rx_p, switched ? 0 : s.burst};
}

// A lane's share of one row's scan at clock t: released count, first
// minimum of where(released, q, BIG_NS) and its slot, next release, and
// whether a visited bitmap word has a BIG_NS slot.
struct Scan {
  int cnt, vmin, imin, nmin;
  bool hole;
};

__device__ __forceinline__ void scan_slot(Scan& s, int c, int v, int t) {
  const bool rel = v <= t;
  s.cnt += rel;
  const int val = rel ? v : kBigNs;
  if (val < s.vmin || (val == s.vmin && c < s.imin)) {
    s.vmin = val;
    s.imin = c;
  }
  s.nmin = min(s.nmin, rel ? kBigNs : v);
}

// Columns sub, sub + S, ... of the row's window [lo, hi) (the whole row
// where t >= BIG_NS: an empty slot then counts as released), or, with
// `bits`, the set bits of the window's words sub, sub + S, ...
__device__ __forceinline__ Scan scan_part(const int* q, const unsigned* bits,
                                          int nc, int t, int lo, int hi,
                                          int sub, int S) {
  if (t >= kBigNs) {
    Scan s{0, INT_MAX, INT_MAX, INT_MAX, false};
#pragma unroll 1
    for (int c = sub; c < nc; c += S) scan_slot(s, c, q[c], t);
    return s;
  }
  // t < BIG_NS: a slot outside the window, or a clear bit, is an
  // unreleased BIG_NS, so nothing released means minimum BIG_NS at slot
  // 0; the caller adds BIG_NS as a next release where such a slot exists
  Scan s{0, kBigNs, 0, INT_MAX, false};
  if (bits != nullptr) {
    const int last = (nc - 1) >> 5;
    const unsigned tail = (nc & 31) ? (1u << (nc & 31)) - 1u : kFull;
#pragma unroll 1
    for (int w = (lo >> 5) + sub; w <= (hi - 1) >> 5; w += S) {
      unsigned m = bits[w];
      s.hole |= m != (w == last ? tail : kFull);
      while (m) {
        const int c = (w << 5) + __ffs(static_cast<int>(m)) - 1;
        m &= m - 1;
        scan_slot(s, c, q[c], t);
      }
    }
  } else {
#pragma unroll 2
    for (int c = lo + sub; c < hi; c += S) scan_slot(s, c, q[c], t);
  }
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// The barrier between phases: a warp's own where the block is one warp.
__device__ __forceinline__ void phase_sync(bool one_warp) {
  if (one_warp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Resident planes in (to_smem) or out, Q rows of C words, global pitch C,
// shared pitch `pitch`.  Bulk copies where every row is a multiple of 16
// bytes on 16-byte boundaries, else plain loads and stores.
__device__ void move_planes(int* const* gplanes, int* splanes, int n_planes,
                            int nq, int nc, int pitch, bool to_smem,
                            int* mbar) {
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  bool bulk = nc % 4 == 0;
  for (int p = 0; p < n_planes; ++p)
    bulk = bulk && reinterpret_cast<uintptr_t>(gplanes[p]) % 16 == 0;
  if (!bulk) {
    for (int p = 0; p < n_planes; ++p) {
      int* g = gplanes[p];
      int* s = splanes + static_cast<size_t>(p) * nq * pitch;
      for (int i = tid; i < nq * nc; i += nth) {
        const int r = i / nc;
        const int c = i - r * nc;
        if (to_smem) {
          s[r * pitch + c] = g[i];
        } else {
          g[i] = s[r * pitch + c];
        }
      }
    }
    __syncthreads();
    return;
  }
  const uint32_t row_bytes = 4u * nc;
  if (to_smem) {
    const uint32_t bar = smem_addr(mbar);
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(bar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(bar), "r"(row_bytes * nq * n_planes)
                   : "memory");
    }
    __syncthreads();
    for (int i = tid; i < n_planes * nq; i += nth) {
      const int p = i / nq;
      const int r = i - p * nq;
      const int* src = gplanes[p] + static_cast<size_t>(r) * nc;
      int* dst = splanes + (static_cast<size_t>(p) * nq + r) * pitch;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          :: "r"(smem_addr(dst)), "l"(src), "r"(row_bytes), "r"(bar)
          : "memory");
    }
    mbar_wait(bar, 0);
    __syncthreads();
  } else {
    // generic-proxy writes to shared memory, then the async proxy reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    for (int i = tid; i < n_planes * nq; i += nth) {
      const int p = i / nq;
      const int r = i - p * nq;
      int* dst = gplanes[p] + static_cast<size_t>(r) * nc;
      const int* src = splanes + (static_cast<size_t>(p) * nq + r) * pitch;
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group"
                   " [%0], [%1], %2;\n"
                   :: "l"(dst), "r"(smem_addr(src)), "r"(row_bytes)
                   : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// kCap: the block's most threads (kScanThreads: no register cap).
template <int kCap>
__global__ void __launch_bounds__(kCap)
fabric_queue_multistep_kernel(
    // carry (updated in place); the planes are written inside the launch,
    // so they are not marked const or __restrict__ (no non-coherent loads)
    int* q_time_g, int* q_dest_g, int* q_inj_g, int* lanes_g, int* sides_g,
    int* logs_g, int* counters_g,
    // read-only operands
    const int* __restrict__ links_g, const int* __restrict__ route_out_g,
    const int* __restrict__ route_del_g, const int* __restrict__ route_wt_g,
    const int* __restrict__ timing_g, const int* __restrict__ params,
    const int* __restrict__ base_p, int n_links, int n_cols, int n_log,
    int n_chips, int n_routes, int k, int chunk, int max_steps,
    int max_burst, int tier) {
  const int L = n_links;
  const int Q = 2 * L;
  const int M = L * k;
  const int C = n_cols;
  const int R = n_routes;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int warp = tid / kWarp;
  const int lane_id = tid % kWarp;
  const unsigned lower = (1u << lane_id) - 1u;   // lanes below this one
  const bool owner = tid < L;                    // thread l owns link l
  const int l = tid;
  // every owner in the first warp: its phases need no block barrier
  const bool one_warp = L <= kWarp;
  const bool owner_warp = one_warp ? warp == 0 : true;

  // this block's instance
  const size_t inst = blockIdx.x;
  const size_t plane = static_cast<size_t>(Q) * C;
  q_time_g += inst * plane;
  q_dest_g += inst * plane;
  q_inj_g += inst * plane;
  lanes_g += inst * kLanes * L;
  sides_g += inst * kSides * Q;
  const int log_w = n_log + 1;   // log columns, scratch slot included
  logs_g += inst * 3 * static_cast<size_t>(log_w);
  counters_g += inst * 2;
  const size_t table = static_cast<size_t>(n_chips) * R;
  links_g += inst * 2 * L;
  route_out_g += inst * table * k;
  route_del_g += inst * table;
  route_wt_g += inst * table * k;
  timing_g += inst * 3 * L;
  params += inst * 3;

  extern __shared__ __align__(16) int smem[];
  int* scal = smem;                              // [kScalars]
  int* q_nins = scal + kScalars;                 // per queue
  int* q_drops = q_nins + Q;
  int* q_npop = q_drops + Q;
  int* q_xoff = q_npop + Q;
  int* q_busy = q_xoff + Q;
  int* q_lo = q_busy + Q;
  int* q_hi = q_lo + Q;
  int* q_fwd = q_hi + Q;
  int* q_live = q_fwd + Q;
  int* q_pend = q_live + Q;
  int* q_rmin = q_pend + Q;
  int* q_nxt = q_rmin + Q;
  int* q_amin = q_nxt + Q;
  int* q_route = q_amin + Q;
  int* q_dirty = q_route + Q;
  int* q_tscan = q_dirty + Q;
  int* l_t = q_tscan + Q;                        // per link
  int* l_route = l_t + L;
  int* l_inj = l_route + L;
  int* l_rx = l_inj + L;
  int* l_deliver = l_rx + L;
  int* m_fwd = l_deliver + L;                    // per lane
  int* m_fq = m_fwd + M;
  int* m_wt = m_fq + M;
  int* m_app = m_wt + M;
  int* planes_s = smem + base_words(L, k);
  const int pitch_s = plane_pitch(C);
  const int n_res = tier >= 2 ? tier - 1 : 0;   // resident planes
  const int nw = (C + 31) / 32;                 // bitmap words a row
  int* bits_s = planes_s + static_cast<size_t>(n_res) * Q * pitch_s;
  unsigned* bits = tier >= 1 ? reinterpret_cast<unsigned*>(bits_s) : nullptr;
  int* tables_s = bits_s + static_cast<size_t>(Q) * nw;

  // where each operand lives for this launch
  int* qt = n_res >= 1 ? planes_s : q_time_g;
  int* qd = n_res >= 2 ? planes_s + static_cast<size_t>(Q) * pitch_s
                       : q_dest_g;
  int* qi = n_res >= 3 ? planes_s + 2 * static_cast<size_t>(Q) * pitch_s
                       : q_inj_g;
  const int pt = n_res >= 1 ? pitch_s : C;
  const int pd = n_res >= 2 ? pitch_s : C;
  const int pi = n_res >= 3 ? pitch_s : C;
  const int* route_out = route_out_g;
  const int* route_wt = route_wt_g;
  const int* route_del = route_del_g;

  // the owner's link and its queues' private counters, in registers for
  // the whole launch
  int t = 0, last_dir = 0, bus_busy = 0, prev_tx_l = 0, prev_tx_r = 0;
  int prev_mode_l = 0, n_sw = 0, busy_ns = 0;
  Xcvr xl{0, 0, 0, 0}, xr{0, 0, 0, 0};
  int t_cycle = 0, t_rev = 0, t_idle = 0, link_a = 0, link_b = 0;
  int sent[2] = {0, 0}, n_pop[2] = {0, 0}, in_stall[2] = {0, 0};
  int stall_steps[2] = {0, 0}, credit_waits[2] = {0, 0};
  if (owner) {
    t = lanes_g[kT * L + l];
    last_dir = lanes_g[kLastDir * L + l];
    bus_busy = lanes_g[kBusBusy * L + l];
    prev_tx_l = lanes_g[kPrevTxL * L + l];
    prev_tx_r = lanes_g[kPrevTxR * L + l];
    xl = Xcvr{lanes_g[kXlMode * L + l], lanes_g[kXlAck * L + l],
              lanes_g[kXlRxP * L + l], lanes_g[kXlBurst * L + l]};
    xr = Xcvr{lanes_g[kXrMode * L + l], lanes_g[kXrAck * L + l],
              lanes_g[kXrRxP * L + l], lanes_g[kXrBurst * L + l]};
    prev_mode_l = lanes_g[kPrevModeL * L + l];
    n_sw = lanes_g[kNSw * L + l];
    busy_ns = lanes_g[kBusyNs * L + l];
    t_cycle = timing_g[l];
    t_rev = timing_g[L + l];
    t_idle = timing_g[2 * L + l];
    link_a = links_g[2 * l];
    link_b = links_g[2 * l + 1];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int q = 2 * l + s;
      sent[s] = sides_g[kSent * Q + q];
      n_pop[s] = sides_g[kNPop * Q + q];
      in_stall[s] = sides_g[kInStall * Q + q];
      stall_steps[s] = sides_g[kStallSteps * Q + q];
      credit_waits[s] = sides_g[kCreditWaits * Q + q];
    }
    l_t[l] = t;
  }
  for (int q = tid; q < Q; q += nth) {
    q_nins[q] = sides_g[kNIns * Q + q];
    q_drops[q] = sides_g[kQDrops * Q + q];
    q_npop[q] = sides_g[kNPop * Q + q];
    q_xoff[q] = sides_g[kXoff * Q + q];
    q_busy[q] = sides_g[kBusySteps * Q + q];
    q_fwd[q] = 0;
    q_lo[q] = C;
    q_hi[q] = 0;
    q_live[q] = 0;
    q_dirty[q] = 1;
  }
  if (tier >= 1) {
    const size_t tk = table * k;
    int* ro = tables_s;
    int* rw = ro + tk;
    int* rd = rw + tk;
    for (size_t i = tid; i < tk; i += nth) {
      ro[i] = route_out_g[i];
      rw[i] = route_wt_g[i];
    }
    for (size_t i = tid; i < table; i += nth) rd[i] = route_del_g[i];
    route_out = ro;
    route_wt = rw;
    route_del = rd;
  }
  if (tid == 0) {
    scal[kLogN] = counters_g[0];
    scal[kDrops] = counters_g[1];
  }
  const int cap = params[0];
  const int fc_mode = params[1];
  const int xon = params[2];
  const int base = base_p[0];
  const int n_steps = min(chunk, max_steps - base);
  // drop mode enforces the logical budget at append time; the stall
  // modes never discard (the physical width C always fits)
  const int app_cap = fc_mode == 0 ? min(cap, C) : C;
  int* gplanes[3] = {q_time_g, q_dest_g, q_inj_g};
  if (n_res > 0) {
    move_planes(gplanes, planes_s, n_res, Q, C, pitch_s, true,
                scal + kMbar0);
  }
  __syncthreads();

  // live windows (and, from tier 1, the bitmap) from the data: a thread
  // a 32-column word
  for (int p = tid; p < Q * nw; p += nth) {
    const int row = p / nw;
    const int c0 = (p - row * nw) << 5;
    const int* q = qt + row * pt + c0;
    const int n = min(32, C - c0);
    unsigned mask = 0;
#pragma unroll 1
    for (int j = 0; j < n; ++j) mask |= static_cast<unsigned>(q[j] != kBigNs) << j;
    if (bits != nullptr) bits[p] = mask;
    if (mask) {
      atomicMin(&q_lo[row], c0 + __ffs(static_cast<int>(mask)) - 1);
      atomicMax(&q_hi[row], c0 + 32 - __clz(static_cast<int>(mask)));
      atomicAdd(&q_live[row], __popc(mask));
    }
  }
  __syncthreads();

  // a row's lanes: S = the largest power of two with S·Q <= threads
  int S = 1;
  while (S < kWarp && 2 * S * Q <= nth) S *= 2;
  const int sub = tid % S;
  const int rows_per_pass = nth / S;

  for (int i = 0; i < n_steps; ++i) {
    // --- A: queue scan at t_q = t[q / 2]; xoff latch (every thread) -----
    if (tid == 0 && !one_warp) {
      scal[kHorizon] = INT_MAX;
      scal[kHorizonCycle] = INT_MAX;
    }
#pragma unroll 1
    for (int r0 = 0; r0 < Q; r0 += rows_per_pass) {
      const int row = r0 + tid / S;
      // a row's results stand while nothing was popped or appended there
      // and its clock has not gone back or reached its next release
      bool live = false;
      int tq = 0;
      if (row < Q) {
        tq = l_t[row >> 1];
        live = q_dirty[row] || tq < q_tscan[row] || tq >= q_nxt[row] ||
               tq >= kBigNs;
      }
      Scan sc{0, INT_MAX, INT_MAX, INT_MAX, false};
      int lo = 0, hi = C;
      if (live) {
        lo = q_lo[row];
        hi = q_hi[row];
        // the bitmap where the window is mostly consumed slots
        const bool sparse = bits != nullptr && 2 * q_live[row] < hi - lo;
        sc = scan_part(qt + row * pt,
                       sparse ? bits + row * nw : nullptr, C, tq, lo, hi,
                       sub, S);
      }
      // lanes of a row combine their shares, unless no row of the warp
      // was scanned
      const int span = __any_sync(kFull, live) ? S : 1;
#pragma unroll 1
      for (int off = span / 2; off > 0; off >>= 1) {
        sc.cnt += __shfl_xor_sync(kFull, sc.cnt, off, S);
        const int ov = __shfl_xor_sync(kFull, sc.vmin, off, S);
        const int oi = __shfl_xor_sync(kFull, sc.imin, off, S);
        if (ov < sc.vmin || (ov == sc.vmin && oi < sc.imin)) {
          sc.vmin = ov;
          sc.imin = oi;
        }
        sc.nmin = min(sc.nmin, __shfl_xor_sync(kFull, sc.nmin, off, S));
        sc.hole |= __shfl_xor_sync(kFull, static_cast<int>(sc.hole), off,
                                   S) != 0;
      }
      if (live && sub == 0) {
        // a BIG_NS slot anywhere in the row is a next-release candidate
        if (tq < kBigNs && (lo > 0 || hi < C || sc.hole)) {
          sc.nmin = min(sc.nmin, kBigNs);
        }
        q_pend[row] = sc.cnt;
        q_rmin[row] = sc.vmin;
        q_nxt[row] = sc.nmin;
        q_amin[row] = sc.imin;
        // the head route is read only where a slot is released
        q_route[row] = sc.cnt > 0
            ? qd[row * pd + sc.imin] : 0;
        q_dirty[row] = 0;
        q_tscan[row] = tq;
      }
      if (row < Q && sub == 0) {
        q_busy[row] += q_pend[row] > 0;
        // the latch advances for every queue before any gate reads it
        const int occ = wsub(q_nins[row], q_npop[row]);
        const int x = q_xoff[row];
        q_xoff[row] = occ >= cap ? 1 : (occ <= xon ? 0 : x);
      }
    }
    __syncthreads();

    if (owner_warp) {
      // --- B: flow gate, stalls, next-action bounds, horizon ------------
      int pend[2], amin[2], route[2], inj_s[2];
      int blocked[2] = {0, 0};
      int safe[2] = {0, 0};
      int na = INT_MAX;
      int t_next_g = INT_MAX;
      if (owner) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int q = 2 * l + s;
          pend[s] = q_pend[q];
          amin[s] = q_amin[q];
          route[s] = q_route[q];
          // the popped event's injection time, for either side, loaded
          // here so that its latency overlaps the gate and the FSM
          inj_s[s] = pend[s] > 0 ? qi[q * pi + amin[s]]
                                 : 0;
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          // the gate matters only where the side has a released head
          if (pend[s] > 0 && (fc_mode == 1 || fc_mode == 2)) {
            // the chip a pop over this side would deliver into
            const int rx = s == 0 ? link_b : link_a;
            const int r = min(max(route[s], 0), R - 1);
            const int* tgt =
                route_out + (rx * R + r) * k;
#pragma unroll 1
            for (int kk = 0; kk < k; ++kk) {
              const int g = tgt[kk];
              if (g < 0) continue;
              blocked[s] |= fc_mode == 1
                  ? wsub(q_nins[g], q_npop[g]) >= cap : q_xoff[g] > 0;
            }
          }
          const bool stalled = pend[s] > 0 && blocked[s];
          stall_steps[s] += stalled;
          credit_waits[s] += stalled && in_stall[s] == 0;
          in_stall[s] = stalled;
          const int nxt = q_nxt[2 * l + s];
          na = min(na, pend[s] > 0 ? (blocked[s] ? kBigNs : t) : nxt);
          t_next_g = min(t_next_g, pend[s] > 0 ? kBigNs : nxt);
        }
      }
      int horizon = __reduce_min_sync(kFull, na);
      int horizon_cycle =
          __reduce_min_sync(kFull, owner ? wadd(na, t_cycle) : INT_MAX);
      if (!one_warp) {
        if (lane_id == 0) {
          atomicMin(&scal[kHorizon], horizon);
          atomicMin(&scal[kHorizonCycle], horizon_cycle);
        }
        __syncthreads();
        horizon = scal[kHorizon];
        horizon_cycle = scal[kHorizonCycle];
      }

      // --- C: one micro-transaction on every link; pops -----------------
      if (owner) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          safe[s] = q_rmin[2 * l + s] <= horizon_cycle;
        }
        const int t_now = t;
        const int t_next_eff = min(t_next_g, max(horizon, t_now));
        const int pend_l = (safe[0] && !blocked[0]) ? pend[0] : 0;
        const int pend_r = (safe[1] && !blocked[1]) ? pend[1] : 0;

        // FSM with wire settling: both first evaluations read the OLD
        // sw_acks and the receive strobes; the second pass reads the
        // first pass's sw_acks and no strobe
        const Xcvr xl1 = fsm(xl, xr.ack, pend_l, prev_tx_r, max_burst);
        const Xcvr xr1 = fsm(xr, xl.ack, pend_r, prev_tx_l, max_burst);
        Xcvr xl2 = fsm(xl1, xr1.ack, pend_l, 0, max_burst);
        Xcvr xr2 = fsm(xr1, xl1.ack, pend_r, 0, max_burst);

        const bool l_tx = xl2.mode == kTx;
        const bool r_tx = xr2.mode == kTx;
        const bool tx_l = l_tx && !r_tx && pend_l > 0;
        const bool tx_r = r_tx && !l_tx && pend_r > 0;
        const bool do_tx = tx_l || tx_r;
        const int dir_now = tx_l;
        const bool reversal = dir_now != last_dir;
        const bool busy = bus_busy == 1;
        const int cost = wadd(wadd(t_cycle, (reversal && busy) ? t_rev : 0),
                              (reversal && !busy) ? t_idle : 0);
        // settling is judged against the state at the start of the step
        const bool settling = xl2.ack != xl.ack || xr2.ack != xr.ack ||
                              xl2.mode != xl.mode || xr2.mode != xr.mode;
        const bool idle = !do_tx && !settling;
        const int t_new = do_tx ? wadd(t_now, cost)
                          : (idle && t_next_eff < kBigNs) ? t_next_eff
                                                          : t_now;
        xl2.burst = wadd(xl2.burst, tx_l);
        xr2.burst = wadd(xr2.burst, tx_r);

        t = t_new;
        last_dir = do_tx ? dir_now : last_dir;
        bus_busy = do_tx ? 1 : (idle ? 0 : bus_busy);
        prev_tx_l = tx_l;
        prev_tx_r = tx_r;
        // switch count, the reset step excluded
        if (base + i > 0) n_sw += xl2.mode != prev_mode_l;
        prev_mode_l = xl2.mode;
        xl = xl2;
        xr = xr2;

        // pop bookkeeping
        const int did = do_tx;
        if (did) busy_ns = wadd(busy_ns, wsub(t_new, t_now));
        const int send = tx_l ? 0 : 1;
        const int qid = 2 * l + send;
        const int pop_slot = send == 0 ? amin[0] : amin[1];
        const int ev_route = send == 0 ? route[0] : route[1];
        const int rx = tx_l ? link_b : link_a;
        const int r = min(max(ev_route, 0), R - 1);
        const bool deliver =
            did && route_del[rx * R + r] > 0;
        if (did) {
          if (send == 0) {
            sent[0] += 1;
            n_pop[0] += 1;
          } else {
            sent[1] += 1;
            n_pop[1] += 1;
          }
          q_npop[qid] = send == 0 ? n_pop[0] : n_pop[1];
          // one-shot slot consumed; a pop at lo moves the window's start
          // to the next slot that is not BIG_NS
          int* q = qt + qid * pt;
          q[pop_slot] = kBigNs;
          q_dirty[qid] = 1;
          unsigned* rb = bits != nullptr ? bits + qid * nw : nullptr;
          if (rb != nullptr) {
            const unsigned bit = 1u << (pop_slot & 31);
            const unsigned word = rb[pop_slot >> 5];
            if (word & bit) {
              rb[pop_slot >> 5] = word & ~bit;
              q_live[qid] -= 1;
            }
          }
          int lo = q_lo[qid];
          if (pop_slot == lo) {
            const int hi = q_hi[qid];
            if (rb != nullptr) {
              int w = lo >> 5;
              const int w_end = hi > 0 ? (hi - 1) >> 5 : -1;
              unsigned m = w <= w_end ? rb[w] & (kFull << (lo & 31)) : 0u;
              while (m == 0 && w < w_end) m = rb[++w];
              lo = m ? (w << 5) + __ffs(static_cast<int>(m)) - 1 : hi;
            } else {
#pragma unroll 1
              while (lo < hi && q[lo] == kBigNs) ++lo;
            }
            q_lo[qid] = lo;
          }
        }
        // what the scan, the delivery log and the appends read of this
        // link
        l_t[l] = t_new;
        l_route[l] = ev_route;
        l_inj[l] = send == 0 ? inj_s[0] : inj_s[1];
        l_rx[l] = rx;
        l_deliver[l] = deliver;
#pragma unroll 1
        for (int kk = 0; kk < k; ++kk) {
          const int m = l * k + kk;
          int fwd = 0;
          if (did) {
            const int at = (rx * R + r) * k + kk;
            const int oq = route_out[at];
            fwd = oq >= 0;
            m_fq[m] = max(oq, 0);
            m_wt[m] = route_wt[at];
          }
          m_fwd[m] = fwd;
        }
      }
      phase_sync(one_warp);

      // --- D, E, F: delivery log, appends, n_ins (the first warp) ------
      if (warp == 0) {
        // the log in link order: an exclusive prefix of deliveries
        const int log_n = scal[kLogN];
        int before = 0;
#pragma unroll 1
        for (int l0 = 0; l0 < L; l0 += kWarp) {
          const int ll = l0 + lane_id;
          const bool d = ll < L && l_deliver[ll];
          const unsigned mask = __ballot_sync(kFull, d);
          if (d) {
            const int slot = wadd(log_n, before + __popc(mask & lower));
            if (slot >= 0 && slot < n_log) {   // JAX's mode="drop"
              logs_g[slot] = l_inj[ll];
              logs_g[log_w + slot] = l_t[ll];
              logs_g[2 * log_w + slot] = l_rx[ll];
            }
          }
          before += __popc(mask);
        }
        if (lane_id == 0) scal[kLogN] = wadd(log_n, before);

        // forward slots: simultaneous appends into one queue go in
        // (link, replica) order, earlier chunks' count plus this chunk's
        // lower lanes
        bool app_one = false;   // this lane's append, where M <= 32
        int fq_one = 0;
#pragma unroll 1
        for (int m0 = 0; m0 < M; m0 += kWarp) {
          const int m = m0 + lane_id;
          const bool f = m < M && m_fwd[m];
          if (__ballot_sync(kFull, f) == 0) continue;
          const int fq = f ? m_fq[m] : -1 - lane_id;
          const unsigned peers = __match_any_sync(kFull, fq);
          const int run = f ? q_fwd[fq] : 0;
          __syncwarp();
          if (f && (peers >> lane_id) == 1u) {
            q_fwd[fq] = run + __popc(peers);
          }
          __syncwarp();
          if (f) {
            const int key = wadd(q_nins[fq], run + __popc(peers & lower));
            int app = 0;
            if (key < app_cap) {
              app = 1;
              if (key >= 0) {
                const int ll = m / k;
                const int tv = l_t[ll];
                qt[fq * pt + key] = tv;
                qd[fq * pd + key] = l_route[ll];
                qi[fq * pi + key] = l_inj[ll];
                q_dirty[fq] = 1;
                atomicMin(&q_lo[fq], key);
                atomicMax(&q_hi[fq], key + 1);
                if (bits != nullptr) {
                  unsigned* wp = bits + fq * nw + (key >> 5);
                  const unsigned bit = 1u << (key & 31);
                  if (tv != kBigNs) {
                    atomicOr(wp, bit);
                    atomicAdd(&q_live[fq], 1);
                  } else {
                    atomicAnd(wp, ~bit);
                  }
                }
              }
            } else {
              atomicAdd(&q_drops[fq], m_wt[m]);
              atomicAdd(&scal[kDrops], m_wt[m]);
            }
            m_app[m] = app;
            app_one = app;
            fq_one = fq;
          }
        }
        __syncwarp();
        // n_ins counts every append (duplicate targets add up)
        if (M <= kWarp) {
          if (lane_id < M && m_fwd[lane_id]) {
            if (app_one) atomicAdd(&q_nins[fq_one], 1);
            q_fwd[fq_one] = 0;
          }
        } else {
#pragma unroll 1
          for (int m = lane_id; m < M; m += kWarp) {
            if (m_fwd[m]) {
              const int fq = m_fq[m];
              if (m_app[m]) atomicAdd(&q_nins[fq], 1);
              q_fwd[fq] = 0;
            }
          }
        }
      }
    }
    __syncthreads();
  }

  if (n_res > 0) {
    move_planes(gplanes, planes_s, n_res, Q, C, pitch_s, false,
                scal + kMbar0);
  }
  if (owner) {
    lanes_g[kT * L + l] = t;
    lanes_g[kLastDir * L + l] = last_dir;
    lanes_g[kBusBusy * L + l] = bus_busy;
    lanes_g[kPrevTxL * L + l] = prev_tx_l;
    lanes_g[kPrevTxR * L + l] = prev_tx_r;
    lanes_g[kXlMode * L + l] = xl.mode;
    lanes_g[kXlAck * L + l] = xl.ack;
    lanes_g[kXlRxP * L + l] = xl.rx_p;
    lanes_g[kXlBurst * L + l] = xl.burst;
    lanes_g[kXrMode * L + l] = xr.mode;
    lanes_g[kXrAck * L + l] = xr.ack;
    lanes_g[kXrRxP * L + l] = xr.rx_p;
    lanes_g[kXrBurst * L + l] = xr.burst;
    lanes_g[kPrevModeL * L + l] = prev_mode_l;
    lanes_g[kNSw * L + l] = n_sw;
    lanes_g[kBusyNs * L + l] = busy_ns;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int q = 2 * l + s;
      sides_g[kSent * Q + q] = sent[s];
      sides_g[kInStall * Q + q] = in_stall[s];
      sides_g[kStallSteps * Q + q] = stall_steps[s];
      sides_g[kCreditWaits * Q + q] = credit_waits[s];
    }
  }
  for (int q = tid; q < Q; q += nth) {
    sides_g[kNIns * Q + q] = q_nins[q];
    sides_g[kQDrops * Q + q] = q_drops[q];
    sides_g[kNPop * Q + q] = q_npop[q];
    sides_g[kXoff * Q + q] = q_xoff[q];
    sides_g[kBusySteps * Q + q] = q_busy[q];
  }
  if (tid == 0) {
    counters_g[0] = scal[kLogN];
    counters_g[1] = scal[kDrops];
  }
}

int round_up(int x, int to) { return (x + to - 1) / to * to; }

}  // namespace

extern "C" {

// The least dynamic shared memory one block (instance) needs, in bytes
// (tier 0: the shared scalars and the per-queue, per-link and per-lane
// arrays).
int fabric_queue_multistep_smem_bytes(int n_links, int k) {
  return 4 * base_words(n_links, k);
}

// Dynamic shared memory of a launch at `tier` (0 to 4), in bytes
// (INT_MAX where that does not fit an int).
int fabric_queue_multistep_layout_bytes(int n_links, int k, int n_cols,
                                        int n_chips, int n_routes, int tier) {
  const long long b = layout_bytes(n_links, k, n_cols, n_chips, n_routes,
                                   tier);
  return b > INT_MAX ? INT_MAX : static_cast<int>(b);
}

// Dynamic shared memory a block may opt in to on the current device, in
// bytes, through *bytes; the return value is the CUDA error code.
int fabric_queue_multistep_smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  }
  return static_cast<int>(e);
}

// The caller has checked the tier's bytes against smem_limit and that
// n_links <= 1024 (a thread a link).
int fabric_queue_multistep_launch(
    int* q_time, int* q_dest, int* q_inj, int* lanes, int* sides, int* logs,
    int* counters, const int* links, const int* route_out,
    const int* route_del, const int* route_wt, const int* timing,
    const int* params, const int* base, int n_inst, int n_links, int n_cols,
    int n_log, int n_chips, int n_routes, int k, int chunk, int max_steps,
    int max_burst, int tier, void* stream) {
  if (tier < 0 || tier > kMaxTier || n_links < 1 || n_links > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(
      layout_bytes(n_links, k, n_cols, n_chips, n_routes, tier));
  // a thread a link, and at least eight warps for the scan
  const int threads = round_up(n_links, kWarp) > kScanThreads
      ? round_up(n_links, kWarp) : kScanThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads == kScanThreads) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fabric_queue_multistep_kernel<kScanThreads>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    fabric_queue_multistep_kernel<kScanThreads>
        <<<n_inst, threads, smem, s>>>(
            q_time, q_dest, q_inj, lanes, sides, logs, counters, links,
            route_out, route_del, route_wt, timing, params, base, n_links,
            n_cols, n_log, n_chips, n_routes, k, chunk, max_steps,
            max_burst, tier);
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fabric_queue_multistep_kernel<kMaxThreads>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    fabric_queue_multistep_kernel<kMaxThreads>
        <<<n_inst, threads, smem, s>>>(
            q_time, q_dest, q_inj, lanes, sides, logs, counters, links,
            route_out, route_del, route_wt, timing, params, base, n_links,
            n_cols, n_log, n_chips, n_routes, k, chunk, max_steps,
            max_burst, tier);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fabric_queue_multistep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
