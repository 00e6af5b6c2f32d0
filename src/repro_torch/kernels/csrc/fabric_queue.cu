// Fabric event-queue step of the slot engine, hand-written for Hopper
// (sm_90a).  Two kernels, launched once each per micro-transaction:
//
//   fabric_queue_step    (replaces fabric_queue_step_pallas,
//                         src/repro/kernels/fabric_queue.py:109)
//     Per queue row of the (Q, C) int32 slot planes: released count,
//     minimum released time, minimum unreleased time, first index of the
//     released minimum, backlog bit, and the route riding that slot.
//
//   fabric_queue_update  (replaces fabric_queue_update_pallas,
//                         src/repro/kernels/fabric_queue.py:195)
//     Pop lanes set q_time[pop_q, pop_slot] = BIG_NS; append lanes write
//     (t, dest, inj) at (app_q, app_slot); a lane whose queue id is not
//     in [0, Q) (or whose slot is not in [0, C)) writes nothing.
//
// Semantics are those of repro_torch/kernels/ref.py, bit for bit.
// Plain C entry points (loaded with ctypes): pointers to int32 device
// memory, the CUDA stream, and cudaGetLastError() as the return value.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBigNs = 1 << 30;   // empty / consumed slot sentinel
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kUpdateThreads = 256;
// 16-byte vectors a thread loads per pass over a row, for each plane
constexpr int kVecs = 8;

// fabric_queue_step: one block per queue row, so Q = 32 rows keep 32
// SMs busy.  Bound: bytes (q_time once, 7 words a row besides), far
// below a launch at every main-path shape, so the design cuts the
// kernel's own latency to one memory round trip:
//  * every load of a row is made before any reduction: the aligned
//    middle of the row as 16-byte int4 loads, kVecs a thread, unrolled
//    and independent, the 0-3 columns before the first 16-byte boundary
//    and after the last as scalar loads in the same pass (a second,
//    strided pass only for rows wider than kVecs * threads vectors, and
//    a scalar pass when q_time and q_dest differ in 16-byte alignment);
//  * q_dest is read in that pass too, and each thread carries (value,
//    column, dest) of its minimum, so head_route needs no dependent
//    gather of q_dest[row, amin].  That doubles the bytes read, but the
//    planes are updated in place every step and stay in the 50 MB L2
//    at every main-path shape, where a second, dependent trip would
//    cost more than the extra bytes;
//  * warp reductions (redux.sync), then one shared-memory exchange
//    across the block's warps.
// The argmin rule is torch.argmin's (and jnp's): (value, column) pairs
// compare lexicographically, so the lowest column wins a tie.  Every
// column takes part (unreleased ones as BIG_NS), so a row with nothing
// released gives amin = 0 and head_route = q_dest[row, 0]; a row whose
// clock is at or past BIG_NS releases its empty slots, as in
// ref.fabric_queue_scan.
struct RowAcc {
  int cnt;    // released count
  int vmin;   // minimum of val = released ? q : BIG_NS ...
  int imin;   // ... at this column
  int dmin;   // ... with this q_dest
  int nmin;   // minimum unreleased time
};

__device__ __forceinline__ void take(RowAcc& a, int v, int c, int d,
                                     int t) {
  const bool rel = v <= t;
  a.cnt += rel;
  const int val = rel ? v : kBigNs;
  if (val < a.vmin || (val == a.vmin && c < a.imin)) {
    a.vmin = val;
    a.imin = c;
    a.dmin = d;
  }
  a.nmin = min(a.nmin, rel ? kBigNs : v);
}

__device__ __forceinline__ void merge(RowAcc& a, const RowAcc& o) {
  a.cnt += o.cnt;
  if (o.vmin < a.vmin || (o.vmin == a.vmin && o.imin < a.imin)) {
    a.vmin = o.vmin;
    a.imin = o.imin;
    a.dmin = o.dmin;
  }
  a.nmin = min(a.nmin, o.nmin);
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
fabric_queue_step_kernel(const int* __restrict__ q_time,
                         const int* __restrict__ q_dest,
                         const int* __restrict__ t_q, int n_c,
                         int* __restrict__ pend, int* __restrict__ r_min,
                         int* __restrict__ nxt, int* __restrict__ amin,
                         int* __restrict__ busy,
                         int* __restrict__ head_route) {
  constexpr int kWarps = kThreads / kWarp;
  __shared__ RowAcc part[kWarps];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int* q = q_time + static_cast<size_t>(row) * n_c;
  const int* d = q_dest + static_cast<size_t>(row) * n_c;
  const int t = __ldg(t_q + row);

  // columns [0, head) and [head + 4 * n_vec, n_c) are scalar, the rest
  // int4 vectors; both planes share the split when their bases agree
  // modulo 16 bytes, else the whole row is scalar
  const auto qa = reinterpret_cast<uintptr_t>(q);
  const bool vec = ((qa ^ reinterpret_cast<uintptr_t>(d)) & 15u) == 0;
  const int head = vec ? min(static_cast<int>(((16u - (qa & 15u)) & 15u)
                                              >> 2), n_c) : 0;
  const int n_vec = vec ? (n_c - head) >> 2 : 0;
  const int tail = head + 4 * n_vec;
  const int4* q4 = reinterpret_cast<const int4*>(q + head);
  const int4* d4 = reinterpret_cast<const int4*>(d + head);

  // one pass: every load first ...
  int4 tv[kVecs], dv[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int j = tid + k * kThreads;
    if (j < n_vec) {
      tv[k] = __ldg(q4 + j);
      dv[k] = __ldg(d4 + j);
    }
  }
  int hq = 0, hd = 0, sq = 0, sd = 0;
  const bool has_head = tid < head;
  const bool has_tail = vec && tid < n_c - tail;
  if (has_head) {
    hq = __ldg(q + tid);
    hd = __ldg(d + tid);
  }
  if (has_tail) {
    sq = __ldg(q + tail + tid);
    sd = __ldg(d + tail + tid);
  }
  // ... then the reduction of what arrived
  RowAcc a{0, INT_MAX, INT_MAX, 0, INT_MAX};
  if (has_head) take(a, hq, tid, hd, t);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int j = tid + k * kThreads;
    if (j < n_vec) {
      const int c = head + 4 * j;
      take(a, tv[k].x, c, dv[k].x, t);
      take(a, tv[k].y, c + 1, dv[k].y, t);
      take(a, tv[k].z, c + 2, dv[k].z, t);
      take(a, tv[k].w, c + 3, dv[k].w, t);
    }
  }
  if (has_tail) take(a, sq, tail + tid, sd, t);
  // rows wider than one pass, and rows that could not be vectorised
  for (int j = tid + kVecs * kThreads; j < n_vec; j += kThreads) {
    const int4 v = __ldg(q4 + j);
    const int4 w = __ldg(d4 + j);
    const int c = head + 4 * j;
    take(a, v.x, c, w.x, t);
    take(a, v.y, c + 1, w.y, t);
    take(a, v.z, c + 2, w.z, t);
    take(a, v.w, c + 3, w.w, t);
  }
  if (!vec) {
    for (int c = tid; c < n_c; c += kThreads) {
      take(a, __ldg(q + c), c, __ldg(d + c), t);
    }
  }

  // the warp's (value, column) minimum: the least value, then the
  // least column among the lanes holding it, then that lane's dest
  RowAcc r;
  r.cnt = __reduce_add_sync(kFull, a.cnt);
  r.nmin = __reduce_min_sync(kFull, a.nmin);
  r.vmin = __reduce_min_sync(kFull, a.vmin);
  r.imin = __reduce_min_sync(kFull, a.vmin == r.vmin ? a.imin : INT_MAX);
  const unsigned who = __ballot_sync(kFull, a.vmin == r.vmin &&
                                                a.imin == r.imin);
  r.dmin = __shfl_sync(kFull, a.dmin, __ffs(who) - 1);
  a = r;
  if (tid % kWarp == 0) part[tid / kWarp] = a;
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) merge(a, part[w]);
    pend[row] = a.cnt;
    r_min[row] = a.vmin;
    nxt[row] = a.nmin;
    amin[row] = a.imin;
    busy[row] = a.cnt > 0;
    head_route[row] = a.dmin;
  }
}

// One thread per lane: the first n_pop threads pop, the next n_app
// append.  Writes go straight into the planes (in place); no atomics are
// needed because append targets are unique and disjoint from pop slots.
__global__ void __launch_bounds__(kUpdateThreads)
fabric_queue_update_kernel(int* __restrict__ q_time,
                           int* __restrict__ q_dest,
                           int* __restrict__ q_inj, int n_q, int n_c,
                           const int* __restrict__ pop_q,
                           const int* __restrict__ pop_slot, int n_pop,
                           const int* __restrict__ app_q,
                           const int* __restrict__ app_slot,
                           const int* __restrict__ app_t,
                           const int* __restrict__ app_dest,
                           const int* __restrict__ app_inj, int n_app) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_pop) {
    const int qq = pop_q[i];
    const int s = pop_slot[i];
    if (qq >= 0 && qq < n_q && s >= 0 && s < n_c) {
      q_time[static_cast<size_t>(qq) * n_c + s] = kBigNs;
    }
  } else if (i < n_pop + n_app) {
    const int j = i - n_pop;
    const int qq = app_q[j];
    const int s = app_slot[j];
    if (qq >= 0 && qq < n_q && s >= 0 && s < n_c) {
      const size_t k = static_cast<size_t>(qq) * n_c + s;
      q_time[k] = app_t[j];
      q_dest[k] = app_dest[j];
      q_inj[k] = app_inj[j];
    }
  }
}

}  // namespace

extern "C" {

// A row per block of 2 warps up to C = 1024 columns, of 4 above: the
// faster of 32-256 threads a row at (32, 768) and (224, 3072) on an
// H100 (PERF.md, Findings).
int fabric_queue_step_launch(const int* q_time, const int* q_dest,
                             const int* t_q, int n_q, int n_c, int* pend,
                             int* r_min, int* nxt, int* amin, int* busy,
                             int* head_route, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_c <= 1024) {
    fabric_queue_step_kernel<64><<<n_q, 64, 0, s>>>(
        q_time, q_dest, t_q, n_c, pend, r_min, nxt, amin, busy, head_route);
  } else {
    fabric_queue_step_kernel<128><<<n_q, 128, 0, s>>>(
        q_time, q_dest, t_q, n_c, pend, r_min, nxt, amin, busy, head_route);
  }
  return static_cast<int>(cudaGetLastError());
}

int fabric_queue_update_launch(int* q_time, int* q_dest, int* q_inj,
                               int n_q, int n_c, const int* pop_q,
                               const int* pop_slot, int n_pop,
                               const int* app_q, const int* app_slot,
                               const int* app_t, const int* app_dest,
                               const int* app_inj, int n_app,
                               void* stream) {
  const int lanes = n_pop + n_app;
  const int blocks = (lanes + kUpdateThreads - 1) / kUpdateThreads;
  fabric_queue_update_kernel<<<blocks, kUpdateThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      q_time, q_dest, q_inj, n_q, n_c, pop_q, pop_slot, n_pop, app_q,
      app_slot, app_t, app_dest, app_inj, n_app);
  return static_cast<int>(cudaGetLastError());
}

const char* fabric_queue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
