// Multi-step fabric kernel of the slot engine, hand-written for Hopper
// (sm_90a).  Replaces fabric_queue_multistep_pallas
// (src/repro/kernels/fabric_queue.py:238): one launch runs
// n = min(chunk, max_steps - base) whole micro-transactions of the slot
// engine on the packed carry of repro_torch.core.network._pack_slot_state,
// and updates that carry in place.
//
// The TPU kernel takes the step as a traced closure; a CUDA kernel cannot,
// so this one carries the step of core/network.py::_slot_step_body
// itself, phase by phase, with a barrier between phases:
//
//   A  queue scan (one warp per row, fabric_queue.cu's tie rule) and the
//      xoff latch of every queue;
//   B  flow gate, stall telemetry, next-action bounds and the two
//      block-wide minimums of the conservative horizon (one thread per
//      link);
//   C  the link micro-transaction (two-pass FSM settling of
//      protocol_sim.link_step), pop bookkeeping, the pop itself and the
//      switch count (one thread per link);
//   D  delivery log (slot = log_n + exclusive prefix over links) and the
//      replication lanes (one thread per link, one per lane);
//   E  forward-slot assignment, appends and weighted drops (one thread
//      per lane, link-major and replica-minor);
//   F  n_ins += appends per queue.
//
// Grid: one block per instance (the leading batch axis B).  The (Q, C)
// slot planes and the (3, E + 1) log plane stay in global memory (L2);
// the (16, L) lane plane, the (9, L, 2) side plane, the counters, the
// timing and link tables and every per-step temporary live in shared
// memory for the whole launch and are written back once at its end.
// All arithmetic is int32 with wrap-around, as in the reference; sums
// over lanes use shared-memory integer atomics, whose result does not
// depend on their order.  Semantics are those of
// repro_torch/kernels/ref.py::fabric_queue_multistep over that step, bit
// for bit.  Plain C entry points (loaded with ctypes): pointers to int32
// device memory, the CUDA stream, and cudaGetLastError() as the return
// value.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int kBigNs = 1 << 30;   // empty / consumed slot, "no arrival"
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kRx = 0;
constexpr int kTx = 1;

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
// shared scalars
enum Scalar { kLogN, kDrops, kHorizon, kHorizonCycle, kScalars };

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) -
                          static_cast<unsigned>(b));
}

// The int32 words of shared memory one instance needs: lane and side
// planes, timing (3, L) and links (L, 2), six per-queue and six per-link
// temporaries, four per-lane temporaries, and the scalars.
__host__ __device__ constexpr int smem_words(int n_links, int k) {
  return kLanes * n_links + kSides * 2 * n_links + 3 * n_links +
         2 * n_links + 6 * 2 * n_links + 6 * n_links +
         4 * n_links * k + kScalars;
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

__global__ void __launch_bounds__(kMaxThreads)
fabric_queue_multistep_kernel(
    // carry (updated in place); the planes are written inside the launch,
    // so they are not marked const or __restrict__ (no non-coherent loads)
    int* q_time, int* q_dest, int* q_inj, int* lanes_g, int* sides_g,
    int* logs_g, int* counters_g,
    // read-only operands
    const int* __restrict__ links_g, const int* __restrict__ route_out,
    const int* __restrict__ route_del, const int* __restrict__ route_wt,
    const int* __restrict__ timing_g, const int* __restrict__ params,
    const int* __restrict__ base_p, int n_links, int n_cols, int n_log,
    int n_chips, int n_routes, int k, int chunk, int max_steps,
    int max_burst) {
  const int L = n_links;
  const int Q = 2 * L;
  const int M = L * k;
  const int C = n_cols;
  const int R = n_routes;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int warp = tid / kWarp;
  const int lane_id = tid % kWarp;
  const int n_warps = nth / kWarp;

  // this block's instance
  const size_t inst = blockIdx.x;
  const size_t plane = static_cast<size_t>(Q) * C;
  q_time += inst * plane;
  q_dest += inst * plane;
  q_inj += inst * plane;
  lanes_g += inst * kLanes * L;
  sides_g += inst * kSides * Q;
  const int log_w = n_log + 1;   // log columns, scratch slot included
  logs_g += inst * 3 * static_cast<size_t>(log_w);
  counters_g += inst * 2;
  const size_t table = static_cast<size_t>(n_chips) * R;
  links_g += inst * 2 * L;
  route_out += inst * table * k;
  route_del += inst * table;
  route_wt += inst * table * k;
  timing_g += inst * 3 * L;
  params += inst * 3;

  extern __shared__ int smem[];
  int* lane = smem;                    // [kLanes][L]
  int* side = lane + kLanes * L;       // [kSides][Q]
  int* timing = side + kSides * Q;     // [3][L]: t_cycle, t_rev, t_idle
  int* links = timing + 3 * L;         // [L][2]
  int* q_pend = links + 2 * L;         // per queue
  int* q_rmin = q_pend + Q;
  int* q_nxt = q_rmin + Q;
  int* q_amin = q_nxt + Q;
  int* q_route = q_amin + Q;
  int* q_blocked = q_route + Q;
  int* l_tnext = q_blocked + Q;        // per link
  int* l_did = l_tnext + L;
  int* l_deliver = l_did + L;
  int* l_route = l_deliver + L;
  int* l_inj = l_route + L;
  int* l_rx = l_inj + L;
  int* m_fwd = l_rx + L;               // per lane
  int* m_fq = m_fwd + M;
  int* m_wt = m_fq + M;
  int* m_app = m_wt + M;
  int* scal = m_app + M;               // [kScalars]

  for (int i = tid; i < kLanes * L; i += nth) lane[i] = lanes_g[i];
  for (int i = tid; i < kSides * Q; i += nth) side[i] = sides_g[i];
  for (int i = tid; i < 3 * L; i += nth) timing[i] = timing_g[i];
  for (int i = tid; i < 2 * L; i += nth) links[i] = links_g[i];
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
  __syncthreads();

  for (int i = 0; i < n_steps; ++i) {
    // --- A: queue scan at t_q = t[q / 2]; xoff latch --------------------
    if (tid == 0) {
      scal[kHorizon] = INT_MAX;
      scal[kHorizonCycle] = INT_MAX;
    }
    for (int row = warp; row < Q; row += n_warps) {
      const int* q = q_time + static_cast<size_t>(row) * C;
      const int t = lane[kT * L + row / 2];
      int cnt = 0;
      int vmin = INT_MAX;
      int imin = INT_MAX;
      int nmin = INT_MAX;
#pragma unroll 4
      for (int c = lane_id; c < C; c += kWarp) {
        const int v = q[c];
        const bool rel = v <= t;
        cnt += rel;
        const int val = rel ? v : kBigNs;
        if (val < vmin || c == lane_id) {
          vmin = val;
          imin = c;
        }
        nmin = min(nmin, rel ? kBigNs : v);
      }
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        cnt += __shfl_down_sync(kFull, cnt, off);
        const int ov = __shfl_down_sync(kFull, vmin, off);
        const int oi = __shfl_down_sync(kFull, imin, off);
        if (ov < vmin || (ov == vmin && oi < imin)) {
          vmin = ov;
          imin = oi;
        }
        nmin = min(nmin, __shfl_down_sync(kFull, nmin, off));
      }
      if (lane_id == 0) {
        q_pend[row] = cnt;
        q_rmin[row] = vmin;
        q_nxt[row] = nmin;
        q_amin[row] = imin;
        q_route[row] = q_dest[static_cast<size_t>(row) * C + imin];
        side[kBusySteps * Q + row] += cnt > 0;
      }
    }
    // the latch advances for every queue before any gate reads it
    for (int q = tid; q < Q; q += nth) {
      const int occ = wsub(side[kNIns * Q + q], side[kNPop * Q + q]);
      int& x = side[kXoff * Q + q];
      x = occ >= cap ? 1 : (occ <= xon ? 0 : x);
    }
    __syncthreads();

    // --- B: flow gate, stalls, next-action bounds, horizon --------------
    for (int l = tid; l < L; l += nth) {
      const int t_now = lane[kT * L + l];
      int na = INT_MAX;
      int t_next_g = INT_MAX;
      for (int s = 0; s < 2; ++s) {
        const int q = 2 * l + s;
        const int pend = q_pend[q];
        bool blocked = false;
        if (fc_mode == 1 || fc_mode == 2) {
          // the chip a pop over this side would deliver into
          const int rx = links[2 * l + 1 - s];
          const int r = min(max(q_route[q], 0), R - 1);
          const int* tgt = route_out + (static_cast<size_t>(rx) * R + r) * k;
          for (int kk = 0; kk < k; ++kk) {
            const int g = tgt[kk];
            if (g < 0) continue;
            blocked |= fc_mode == 1
                ? wsub(side[kNIns * Q + g], side[kNPop * Q + g]) >= cap
                : side[kXoff * Q + g] > 0;
          }
        }
        q_blocked[q] = blocked;
        const bool stalled = pend > 0 && blocked;
        side[kStallSteps * Q + q] += stalled;
        side[kCreditWaits * Q + q] +=
            stalled && side[kInStall * Q + q] == 0;
        side[kInStall * Q + q] = stalled;
        const int nxt = q_nxt[q];
        na = min(na, pend > 0 ? (blocked ? kBigNs : t_now) : nxt);
        t_next_g = min(t_next_g, pend > 0 ? kBigNs : nxt);
      }
      l_tnext[l] = t_next_g;
      atomicMin(&scal[kHorizon], na);
      atomicMin(&scal[kHorizonCycle], wadd(na, timing[l]));
    }
    __syncthreads();

    // --- C: one micro-transaction on every link; pops -------------------
    for (int l = tid; l < L; l += nth) {
      int* ln = lane + l;   // ln[ch * L] is channel ch of link l
      const int t_now = ln[kT * L];
      const int t_next_eff =
          min(l_tnext[l], max(scal[kHorizon], t_now));
      int pend_s[2];
      for (int s = 0; s < 2; ++s) {
        const int q = 2 * l + s;
        const bool safe = q_rmin[q] <= scal[kHorizonCycle];
        pend_s[s] = (safe && !q_blocked[q]) ? q_pend[q] : 0;
      }
      const int pend_l = pend_s[0];
      const int pend_r = pend_s[1];

      // FSM with wire settling: both first evaluations read the OLD
      // sw_acks and the receive strobes; the second pass reads the
      // first pass's sw_acks and no strobe
      const Xcvr xl{ln[kXlMode * L], ln[kXlAck * L], ln[kXlRxP * L],
                    ln[kXlBurst * L]};
      const Xcvr xr{ln[kXrMode * L], ln[kXrAck * L], ln[kXrRxP * L],
                    ln[kXrBurst * L]};
      const Xcvr xl1 = fsm(xl, xr.ack, pend_l, ln[kPrevTxR * L], max_burst);
      const Xcvr xr1 = fsm(xr, xl.ack, pend_r, ln[kPrevTxL * L], max_burst);
      Xcvr xl2 = fsm(xl1, xr1.ack, pend_l, 0, max_burst);
      Xcvr xr2 = fsm(xr1, xl1.ack, pend_r, 0, max_burst);

      const bool l_tx = xl2.mode == kTx;
      const bool r_tx = xr2.mode == kTx;
      const bool tx_l = l_tx && !r_tx && pend_l > 0;
      const bool tx_r = r_tx && !l_tx && pend_r > 0;
      const bool do_tx = tx_l || tx_r;
      const int dir_now = tx_l;
      const int last_dir = ln[kLastDir * L];
      const int bus_busy = ln[kBusBusy * L];
      const bool reversal = dir_now != last_dir;
      const bool busy = bus_busy == 1;
      const int cost = wadd(wadd(timing[l], (reversal && busy)
                                                ? timing[L + l] : 0),
                            (reversal && !busy) ? timing[2 * L + l] : 0);
      // settling is judged against the state at the start of the step
      const bool settling = xl2.ack != xl.ack || xr2.ack != xr.ack ||
                            xl2.mode != xl.mode || xr2.mode != xr.mode;
      const bool idle = !do_tx && !settling;
      const int t_new = do_tx ? wadd(t_now, cost)
                        : (idle && t_next_eff < kBigNs) ? t_next_eff
                                                        : t_now;
      xl2.burst = wadd(xl2.burst, tx_l);
      xr2.burst = wadd(xr2.burst, tx_r);

      ln[kT * L] = t_new;
      ln[kLastDir * L] = do_tx ? dir_now : last_dir;
      ln[kBusBusy * L] = do_tx ? 1 : (idle ? 0 : bus_busy);
      ln[kPrevTxL * L] = tx_l;
      ln[kPrevTxR * L] = tx_r;
      ln[kXlMode * L] = xl2.mode;
      ln[kXlAck * L] = xl2.ack;
      ln[kXlRxP * L] = xl2.rx_p;
      ln[kXlBurst * L] = xl2.burst;
      ln[kXrMode * L] = xr2.mode;
      ln[kXrAck * L] = xr2.ack;
      ln[kXrRxP * L] = xr2.rx_p;
      ln[kXrBurst * L] = xr2.burst;

      // pop bookkeeping; q_inj is read here, before any append writes
      const int did = do_tx;
      if (did) ln[kBusyNs * L] = wadd(ln[kBusyNs * L], wsub(t_new, t_now));
      const int qid = 2 * l + (tx_l ? 0 : 1);
      const int pop_slot = q_amin[qid];
      const int ev_route = q_route[qid];
      const size_t pop_at = static_cast<size_t>(qid) * C + pop_slot;
      const int ev_inj = q_inj[pop_at];
      side[kSent * Q + qid] += did;
      side[kNPop * Q + qid] += did;
      const int rx = links[2 * l + (tx_l ? 1 : 0)];
      const int r = min(max(ev_route, 0), R - 1);
      const bool deliver =
          did && route_del[static_cast<size_t>(rx) * R + r] > 0;
      if (did) q_time[pop_at] = kBigNs;   // one-shot slot consumed
      l_did[l] = did;
      l_deliver[l] = deliver;
      l_route[l] = ev_route;
      l_inj[l] = ev_inj;
      l_rx[l] = rx;

      // switch count, the reset step excluded
      if (base + i > 0) ln[kNSw * L] += xl2.mode != ln[kPrevModeL * L];
      ln[kPrevModeL * L] = xl2.mode;
    }
    __syncthreads();

    // --- D: delivery log (link order) and replication lanes -------------
    for (int l = tid; l < L; l += nth) {
      if (!l_deliver[l]) continue;
      int before = 0;
      for (int j = 0; j < l; ++j) before += l_deliver[j];
      const int slot = wadd(scal[kLogN], before);
      if (slot >= 0 && slot < n_log) {   // JAX's mode="drop"
        logs_g[slot] = l_inj[l];
        logs_g[log_w + slot] = lane[kT * L + l];
        logs_g[2 * log_w + slot] = l_rx[l];
      }
    }
    for (int m = tid; m < M; m += nth) {
      const int l = m / k;
      const int r = min(max(l_route[l], 0), R - 1);
      const size_t at =
          (static_cast<size_t>(l_rx[l]) * R + r) * k + (m - l * k);
      const int oq = route_out[at];
      m_fwd[m] = l_did[l] && oq >= 0;
      m_fq[m] = max(oq, 0);
      m_wt[m] = route_wt[at];
    }
    __syncthreads();

    // --- E: forward slots, appends, weighted drops ----------------------
    for (int m = tid; m < M; m += nth) {
      int app = 0;
      if (m_fwd[m]) {
        const int fq = m_fq[m];
        // simultaneous appends into one queue go in (link, replica) order
        int offs = 0;
        for (int j = 0; j < m; ++j) offs += m_fwd[j] && m_fq[j] == fq;
        const int key = wadd(side[kNIns * Q + fq], offs);
        if (key < app_cap) {
          app = 1;
          if (key >= 0) {
            const int l = m / k;
            const size_t at = static_cast<size_t>(fq) * C + key;
            q_time[at] = lane[kT * L + l];
            q_dest[at] = l_route[l];
            q_inj[at] = l_inj[l];
          }
        } else {
          atomicAdd(&side[kQDrops * Q + fq], m_wt[m]);
          atomicAdd(&scal[kDrops], m_wt[m]);
        }
      }
      m_app[m] = app;
    }
    if (tid == 0) {
      int delivered = 0;
      for (int l = 0; l < L; ++l) delivered += l_deliver[l];
      scal[kLogN] = wadd(scal[kLogN], delivered);
    }
    __syncthreads();

    // --- F: n_ins counts every append (duplicate targets add up) --------
    for (int m = tid; m < M; m += nth) {
      if (m_app[m]) atomicAdd(&side[kNIns * Q + m_fq[m]], 1);
    }
    __syncthreads();
  }

  for (int i = tid; i < kLanes * L; i += nth) lanes_g[i] = lane[i];
  for (int i = tid; i < kSides * Q; i += nth) sides_g[i] = side[i];
  if (tid == 0) {
    counters_g[0] = scal[kLogN];
    counters_g[1] = scal[kDrops];
  }
}

int round_up(int x, int to) { return (x + to - 1) / to * to; }

}  // namespace

extern "C" {

// Dynamic shared memory one block (instance) needs, in bytes.
int fabric_queue_multistep_smem_bytes(int n_links, int k) {
  return 4 * smem_words(n_links, k);
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

// The caller has checked smem_bytes against smem_limit.
int fabric_queue_multistep_launch(
    int* q_time, int* q_dest, int* q_inj, int* lanes, int* sides, int* logs,
    int* counters, const int* links, const int* route_out,
    const int* route_del, const int* route_wt, const int* timing,
    const int* params, const int* base, int n_inst, int n_links, int n_cols,
    int n_log, int n_chips, int n_routes, int k, int chunk, int max_steps,
    int max_burst, void* stream) {
  const int smem = fabric_queue_multistep_smem_bytes(n_links, k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fabric_queue_multistep_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // a warp per queue row in the scan, up to the block's limit; the
  // other phases stride over links and lanes
  int widest = 2 * n_links * kWarp;
  if (n_links * k > widest) widest = n_links * k;
  const int threads = widest < kMaxThreads ? round_up(widest, kWarp)
                                           : kMaxThreads;
  fabric_queue_multistep_kernel<<<n_inst, threads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      q_time, q_dest, q_inj, lanes, sides, logs, counters, links, route_out,
      route_del, route_wt, timing, params, base, n_links, n_cols, n_log,
      n_chips, n_routes, k, chunk, max_steps, max_burst);
  return static_cast<int>(cudaGetLastError());
}

const char* fabric_queue_multistep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
