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

namespace {

constexpr int kBigNs = 1 << 30;   // empty / consumed slot sentinel
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kStepThreads = 256;   // 8 rows (warps) per block
constexpr int kUpdateThreads = 256;

// One warp per queue row; lanes stride over the C columns (neighbouring
// lanes read neighbouring words).  Each lane keeps its released count,
// its (minimum value, lowest column) of val = released ? q : BIG_NS and
// its minimum unreleased time; a shuffle reduction then combines lanes,
// breaking value ties toward the lower column — the first-minimum rule
// of jnp.argmin / torch.argmin.  Every column takes part in the argmin
// (unreleased ones as BIG_NS), so a row with nothing released gives
// amin = 0 and head_route = q_dest[row, 0], as the oracle does.
__global__ void __launch_bounds__(kStepThreads)
fabric_queue_step_kernel(const int* __restrict__ q_time,
                         const int* __restrict__ q_dest,
                         const int* __restrict__ t_q, int n_q, int n_c,
                         int* __restrict__ pend, int* __restrict__ r_min,
                         int* __restrict__ nxt, int* __restrict__ amin,
                         int* __restrict__ busy,
                         int* __restrict__ head_route) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_q) return;   // uniform across the warp
  const int* q = q_time + static_cast<size_t>(row) * n_c;
  const int t = t_q[row];

  int cnt = 0;
  int vmin = INT_MAX;
  int imin = INT_MAX;
  int nmin = INT_MAX;
  for (int c = lane; c < n_c; c += kWarp) {
    const int v = q[c];
    const bool rel = v <= t;
    cnt += rel;
    const int val = rel ? v : kBigNs;
    // ascending c: the lane keeps its first minimum; its first column
    // always seeds the pair (so a val of INT_MAX still has an index)
    if (val < vmin || c == lane) {
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
  if (lane == 0) {
    pend[row] = cnt;
    r_min[row] = vmin;
    nxt[row] = nmin;
    amin[row] = imin;
    busy[row] = cnt > 0;
    head_route[row] = q_dest[static_cast<size_t>(row) * n_c + imin];
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

int fabric_queue_step_launch(const int* q_time, const int* q_dest,
                             const int* t_q, int n_q, int n_c, int* pend,
                             int* r_min, int* nxt, int* amin, int* busy,
                             int* head_route, void* stream) {
  const int rows_per_block = kStepThreads / kWarp;
  const int blocks = (n_q + rows_per_block - 1) / rows_per_block;
  fabric_queue_step_kernel<<<blocks, kStepThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      q_time, q_dest, t_q, n_q, n_c, pend, r_min, nxt, amin, busy,
      head_route);
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
