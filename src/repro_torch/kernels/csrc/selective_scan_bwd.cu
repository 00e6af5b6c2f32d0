// Backward of the Mamba selective scan (the S6 recurrence), hand-written
// for Hopper (sm_90a).  It replaces no TPU kernel: the reference gets
// its Mamba gradient by differentiating its chunked jnp scan
// (src/repro/models/mamba.py:76-112), and the port runs that scan as B7
// (csrc/selective_scan.cu), so its gradient needs a kernel of its own.
//
// Forward, with a_t = exp(dt_t * A):
//   h_t = a_t * h_{t-1} + (dt_t * x_t) * B_t     (h_{-1} = 0)
//   y_t = sum_n h_t[n] * C_t[n]
// Given dy (batch, seq, d_in) and dh_final (batch, d_in, N) (null: zeros),
// the carry G seeded by dh_final, for t = seq-1 down to 0:
//   g_t   = dy_t * C_t + G                      (dL/dh_t)
//   dC_t  = sum_d dy_t * h_t
//   dB_t  = sum_d g_t * dt_t * x_t
//   dx_t  = sum_n g_t * dt_t * B_t
//   ddt_t = sum_n g_t * (x_t * B_t + A * a_t * h_{t-1})
//   dA   += sum_{b,t} g_t * dt_t * a_t * h_{t-1}
//   G     = a_t * g_t
// kernels/ref.py::selective_scan_bwd is the plain version, term by term.
//
// What bounds it on an H100.  At falcon-mamba-7b's training shape (4,
// 2048, 8192, 16) the bytes it must move are x, dt and dy in and dx and
// ddt out (268.4 MB each), B, C, dB, dC (0.5 MB each), A, dA (0.5 MB) and
// dh_final (2.1 MB): 1.345 GB, 0.401 ms at 3.35 TB/s; the 1.07e9
// exponentials a_t take 0.257 ms on the special function units.  So
// bytes bound it.
//
// Design (a simple kernel that is right; wgmma and TMA have no part in an
// elementwise recurrence, and tuning is later work):
//
//   1. As in the forward, a channel (b, d) belongs to TPC threads (two,
//      one where N = 1), each holding K = L / TPC of its states (L = N
//      rounded up to a power of two; thread sub holds n = sub + TPC*j) in
//      registers, and a block of 128 threads takes 128 / TPC channels of
//      one sequence.
//   2. The trajectory h (B, S, d_in, N) is never stored.  The kernel
//      first runs the forward recurrence once and writes the state that
//      enters each tile of kTile = 8 steps to a scratch buffer (B,
//      S/kTile, L, d_in): 537 MB at the training shape, against 4.3 GB
//      for every h_t.  Dividing h_t by a_t to walk back is no option: a_t
//      underflows to a subnormal or 0.
//   3. The reverse pass walks the tiles from last to first.  In each it
//      rebuilds the tile's h_t from the tile's entry state into shared
//      memory (kTile steps x K states a thread), then runs the reverse
//      recurrence step by step, reading h_{t-1} from there (h_t is the
//      previous step's) and recomputing a_t.
//   3a. Every pass reads its operands from shared memory: each tile's
//      dt, x and dy of the block's channels and its B and C rows are
//      staged by the whole block, neighbouring threads on neighbouring
//      addresses, so a tile's loads are in flight at once.  The first
//      version read dt, x and dy from device memory step by step in
//      16-step tiles: 8.96 ms a launch at the training shape on an H100
//      SXM (chip_smoke.py, PERF.md §6), 22x its bound; this one takes
//      96 registers a thread and 44 KB of shared memory a block (5
//      blocks an SM), and its time is in PERF.md §6.
//   4. dx and ddt are sums over a channel's states: in registers, then
//      across the TPC threads by shuffles.  dB and dC are sums over every
//      channel: a reduce-scatter across a warp's channel lanes (each round
//      swaps half the remaining values, so K values take K - 1 + the
//      leftover rounds shuffles, not K * rounds), per-warp rows in shared
//      memory summed over the block's warps in a fixed order, and each
//      block's (tile, N) row written to a partial buffer (B, blocks, S,
//      N); a second kernel sums the partials over blocks, and dA's
//      per-sequence partials over the batch, in a fixed order.
//   5. No float atomic anywhere: every sum has one order, so a run gives
//      the same bits every time (a restarted training run must end
//      bit-identical to an uninterrupted one).
//   6. The recurrence is rounded as in the forward kernel (accurate expf,
//      products and sums rounded apart), so the rebuilt states are the
//      forward's bit for bit.
//
// Plain C entry points (loaded with ctypes): device pointers, the sizes,
// the CUDA stream, and cudaGetLastError() as the return value.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;       // steps a tile
constexpr int kThreadsPerChannel = 2;
constexpr int kReduceThreads = 256;

// Shared memory of a block, in floats: the tile's trajectory (kTile x K x
// kThreads), the tile's dt, x and dy (kTile x kCh each), its B and C rows
// (kTile x L each), and the per-warp dB and dC rows (kWarps x kTile x L
// each).
__host__ __device__ constexpr int bwd_smem_floats(int K, int L, int kCh) {
  return kTile * K * kThreads + 3 * kTile * kCh + 2 * kTile * L +
         2 * kWarps * kTile * L;
}

// Sum v over the warp's channel lanes (lane offsets 16 .. TPC), leaving
// in each lane the sum of one of its K values: the one at index `keep`
// (returned).  Rounds while more than one value is left swap half of them
// with the partner lane; the rounds after that add the one value left.
// `writer` is set in one lane of each group that ends with the same sum.
template <int K, int TPC>
__device__ __forceinline__ float reduce_scatter(float (&v)[K], int lane,
                                                int& keep, bool& writer) {
  int base = 0;
  int len = K;
  int bfly_mask = 0;   // lane bits of the rounds that add one value
#pragma unroll
  for (int o = 16; o >= TPC; o >>= 1) {
    if (len > 1) {
      const int half = len / 2;
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int j = 0; j < K / 2; ++j) {
        if (j < half) {
          const float mine = up ? v[j + half] : v[j];
          const float send = up ? v[j] : v[j + half];
          v[j] = __fadd_rn(mine, __shfl_xor_sync(0xffffffffu, send, o));
        }
      }
      if (up) base += half;
      len = half;
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], o));
      bfly_mask |= o;
    }
  }
  keep = base;
  writer = (lane & bfly_mask) == 0;
  return v[0];
}

// kFull: n_state == L, so no state of a thread is padding.
template <int L, int TPC, bool kFull>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ a,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh_final,
                          int seq, int d_in, int n_state, int n_tiles,
                          float* __restrict__ hb,
                          float* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ pb, float* __restrict__ pc,
                          float* __restrict__ pa) {
  constexpr int kCh = kThreads / TPC;   // channels a block
  constexpr int K = L / TPC;            // states a thread
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int d0 = blk * kCh;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int cl = tid / TPC;
  const int sub = tid % TPC;
  const int d = d0 + cl;
  const bool live = d < d_in;

  extern __shared__ __align__(16) float sm[];
  float* s_h = sm;                              // [tt][j][tid]
  float* s_dt = s_h + kTile * K * kThreads;     // [tt][ch]
  float* s_x = s_dt + kTile * kCh;              // [tt][ch]
  float* s_dy = s_x + kTile * kCh;              // [tt][ch]
  float* s_b = s_dy + kTile * kCh;              // [tt][L]
  float* s_c = s_b + kTile * L;                 // [tt][L]
  float* s_pb = s_c + kTile * L;                // [warp][tt][L]
  float* s_pc = s_pb + kWarps * kTile * L;      // [warp][tt][L]

  const long long row0 = static_cast<long long>(b) * seq;
  // the scratch slot of (tile k, state j) of this thread
  auto hb_at = [&](int k, int j) {
    return ((static_cast<long long>(b) * n_tiles + k) * K + j) *
               static_cast<long long>(d_in) * TPC +
           static_cast<long long>(d) * TPC + sub;
  };
  // the tile's dt, x (and dy) of the block's channels and its B (and C)
  // rows into shared memory, neighbouring threads on neighbouring
  // addresses, zero past the sequence, d_in and n_state: the loads of a
  // whole tile are in flight at once, not one step's at a time
  auto stage = [&](int t0, int nt, bool reverse) {
    for (int i = tid; i < kTile * kCh; i += kThreads) {
      const int tt = i / kCh;
      const int c = i - tt * kCh;
      const bool in = tt < nt && d0 + c < d_in;
      const long long g = (row0 + t0 + tt) * d_in + d0 + c;
      s_dt[i] = in ? dt[g] : 0.0f;
      s_x[i] = in ? x[g] : 0.0f;
      if (reverse) s_dy[i] = in ? dy[g] : 0.0f;
    }
    for (int i = tid; i < kTile * L; i += kThreads) {
      const int tt = i / L;
      const int n = i - tt * L;
      const bool in = tt < nt && n < n_state;
      const long long g = (row0 + t0 + tt) * n_state + n;
      s_b[i] = in ? bm[g] : 0.0f;
      if (reverse) s_c[i] = in ? cm[g] : 0.0f;
    }
  };

  float an[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int n = sub + TPC * j;
    an[j] = (live && (kFull || n < n_state))
        ? a[static_cast<long long>(d) * n_state + n] : 0.0f;
  }

  // --- 1. the forward recurrence, keeping each tile's entry state ----
  float h[K];
#pragma unroll
  for (int j = 0; j < K; ++j) h[j] = 0.0f;
  for (int k = 0; k < n_tiles; ++k) {
    const int t0 = k * kTile;
    const int nt = min(kTile, seq - t0);
    if (live && k > 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) hb[hb_at(k, j)] = h[j];
    }
    if (k == n_tiles - 1) break;   // the last tile's steps are not needed
    __syncthreads();
    stage(t0, nt, false);
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float dtv = s_dt[tt * kCh + cl];
      const float dtx = __fmul_rn(dtv, s_x[tt * kCh + cl]);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float abar = expf(__fmul_rn(dtv, an[j]));
        const float bx = __fmul_rn(dtx, s_b[tt * L + sub + TPC * j]);
        h[j] = __fadd_rn(__fmul_rn(abar, h[j]), bx);
      }
    }
  }

  // --- 2. the reverse pass, tile by tile ------------------------------
  float gc[K];    // the carry G
  float da[K];    // dA of this channel, summed over its steps
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int n = sub + TPC * j;
    gc[j] = (dh_final != nullptr && live && (kFull || n < n_state))
        ? dh_final[(static_cast<long long>(b) * d_in + d) * n_state + n]
        : 0.0f;
    da[j] = 0.0f;
  }
  for (int k = n_tiles - 1; k >= 0; --k) {
    const int t0 = k * kTile;
    const int nt = min(kTile, seq - t0);
    float hp[K];    // h_{t0-1}, the tile's entry state
#pragma unroll
    for (int j = 0; j < K; ++j)
      hp[j] = (live && k > 0) ? hb[hb_at(k, j)] : 0.0f;
    __syncthreads();             // the previous tile's shared rows are read
    stage(t0, nt, true);
    __syncthreads();
    // rebuild the tile's h_t
#pragma unroll
    for (int j = 0; j < K; ++j) h[j] = hp[j];
    for (int tt = 0; tt < nt; ++tt) {
      const float dtv = s_dt[tt * kCh + cl];
      const float dtx = __fmul_rn(dtv, s_x[tt * kCh + cl]);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float abar = expf(__fmul_rn(dtv, an[j]));
        const float bx = __fmul_rn(dtx, s_b[tt * L + sub + TPC * j]);
        h[j] = __fadd_rn(__fmul_rn(abar, h[j]), bx);
        s_h[(tt * K + j) * kThreads + tid] = h[j];
      }
    }
    // walk it back; h holds h_t, the last step's state to start with
    for (int tt = nt - 1; tt >= 0; --tt) {
      const long long g = (row0 + t0 + tt) * d_in + d;
      const float dtv = s_dt[tt * kCh + cl];
      const float xv = s_x[tt * kCh + cl];
      const float dyv = s_dy[tt * kCh + cl];
      const float dtx = __fmul_rn(dtv, xv);
      float vc[K];
      float vb[K];
      float sx = 0.0f;
      float sdt = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float bv = s_b[tt * L + sub + TPC * j];
        const float cv = s_c[tt * L + sub + TPC * j];
        const float hm = tt > 0 ? s_h[((tt - 1) * K + j) * kThreads + tid]
                                : hp[j];
        const float abar = expf(__fmul_rn(dtv, an[j]));
        const float gj = dyv * cv + gc[j];
        const float ah = abar * hm;
        vc[j] = dyv * h[j];
        h[j] = hm;
        vb[j] = gj * dtx;
        sx += gj * bv;
        sdt += gj * (xv * bv + an[j] * ah);
        da[j] += gj * dtv * ah;
        gc[j] = abar * gj;
      }
#pragma unroll
      for (int o = TPC / 2; o > 0; o >>= 1) {
        sx += __shfl_xor_sync(0xffffffffu, sx, o, TPC);
        sdt += __shfl_xor_sync(0xffffffffu, sdt, o, TPC);
      }
      if (live && sub == 0) {
        dx[g] = sx * dtv;
        ddt[g] = sdt;
      }
      int jc, jb;
      bool wc, wb;
      const float rc = reduce_scatter<K, TPC>(vc, lane, jc, wc);
      const float rb = reduce_scatter<K, TPC>(vb, lane, jb, wb);
      if (wc) s_pc[(warp * kTile + tt) * L + sub + TPC * jc] = rc;
      if (wb) s_pb[(warp * kTile + tt) * L + sub + TPC * jb] = rb;
    }
    __syncthreads();             // every warp's rows are in
    for (int i = tid; i < nt * n_state; i += kThreads) {
      const int tt = i / n_state;
      const int n = i - tt * n_state;
      float sb = s_pb[tt * L + n];
      float sc = s_pc[tt * L + n];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        sb += s_pb[(w * kTile + tt) * L + n];
        sc += s_pc[(w * kTile + tt) * L + n];
      }
      const long long o =
          ((static_cast<long long>(b) * nblk + blk) * seq + t0 + tt) *
              n_state + n;
      pb[o] = sb;
      pc[o] = sc;
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int n = sub + TPC * j;
      if (kFull || n < n_state)
        pa[(static_cast<long long>(b) * d_in + d) * n_state + n] = da[j];
    }
  }
}

// dB, dC: the blocks' partials summed in block order; dA: the sequences'
// partials summed in batch order.
__global__ void __launch_bounds__(kReduceThreads)
selective_scan_bwd_reduce(const float* __restrict__ pb,
                          const float* __restrict__ pc,
                          const float* __restrict__ pa, int batch, int seq,
                          int n_state, int nblk, int d_in,
                          float* __restrict__ db, float* __restrict__ dc,
                          float* __restrict__ da) {
  const long long row = static_cast<long long>(seq) * n_state;
  const long long n_bc = batch * row;
  const long long n_a = static_cast<long long>(d_in) * n_state;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_bc + n_a; i += stride) {
    if (i < n_bc) {
      const long long bb = i / row;
      const long long r = i - bb * row;
      const float* qb = pb + bb * nblk * row + r;
      const float* qc = pc + bb * nblk * row + r;
      float sb = qb[0];
      float sc = qc[0];
      for (int k = 1; k < nblk; ++k) {
        sb += qb[k * row];
        sc += qc[k * row];
      }
      db[i] = sb;
      dc[i] = sc;
    } else {
      const long long e = i - n_bc;
      float s = pa[e];
      for (int bb = 1; bb < batch; ++bb) s += pa[bb * n_a + e];
      da[e] = s;
    }
  }
}

template <int L, int TPC, bool kFull>
cudaError_t launch_one(const float* x, const float* dt, const float* bm,
                       const float* cm, const float* a, const float* dy,
                       const float* dh_final, int batch, int seq, int d_in,
                       int n_state, float* hb, float* dx, float* ddt,
                       float* pb, float* pc, float* pa,
                       cudaStream_t stream) {
  constexpr int kCh = kThreads / TPC;
  const int smem = 4 * bwd_smem_floats(L / TPC, L, kCh);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        selective_scan_bwd_kernel<L, TPC, kFull>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int n_tiles = (seq + kTile - 1) / kTile;
  const dim3 grid((d_in + kCh - 1) / kCh, batch);
  selective_scan_bwd_kernel<L, TPC, kFull><<<grid, kThreads, smem, stream>>>(
      x, dt, bm, cm, a, dy, dh_final, seq, d_in, n_state, n_tiles, hb, dx,
      ddt, pb, pc, pa);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_l(const float* x, const float* dt, const float* bm,
                     const float* cm, const float* a, const float* dy,
                     const float* dh_final, int batch, int seq, int d_in,
                     int n_state, float* hb, float* dx, float* ddt,
                     float* pb, float* pc, float* pa, cudaStream_t s) {
  constexpr int kTpc = L < kThreadsPerChannel ? L : kThreadsPerChannel;
  if (n_state == L)
    return launch_one<L, kTpc, true>(x, dt, bm, cm, a, dy, dh_final, batch,
                                     seq, d_in, n_state, hb, dx, ddt, pb, pc,
                                     pa, s);
  return launch_one<L, kTpc, false>(x, dt, bm, cm, a, dy, dh_final, batch,
                                    seq, d_in, n_state, hb, dx, ddt, pb, pc,
                                    pa, s);
}

int pow2_states(int n_state) {
  int l = 1;
  while (l < n_state) l *= 2;
  return l;
}

}  // namespace

extern "C" {

// The launch's layout for n_state states: out[0] = channels a block (the
// partials' block count is ceil(d_in / out[0])), out[1] = steps a tile
// (the scratch holds batch x ceil(seq / out[1]) x L x d_in floats), out[2]
// = L, N rounded up to a power of two.
int selective_scan_bwd_plan(int n_state, int* out) {
  if (n_state < 1 || n_state > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int l = pow2_states(n_state);
  out[0] = kThreads / (l < kThreadsPerChannel ? l : kThreadsPerChannel);
  out[1] = kTile;
  out[2] = l;
  return 0;
}

int selective_scan_bwd_launch(const float* x, const float* dt,
                              const float* bm, const float* cm,
                              const float* a, const float* dy,
                              const float* dh_final, int batch, int seq,
                              int d_in, int n_state, float* hb, float* pb,
                              float* pc, float* pa, float* dx, float* ddt,
                              float* db, float* dc, float* da,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || batch > 65535 || seq <= 0 || d_in <= 0 ||
      n_state < 1 || n_state > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (pow2_states(n_state)) {
    case 1:
      err = launch_l<1>(x, dt, bm, cm, a, dy, dh_final, batch, seq, d_in,
                        n_state, hb, dx, ddt, pb, pc, pa, s);
      break;
    case 2:
      err = launch_l<2>(x, dt, bm, cm, a, dy, dh_final, batch, seq, d_in,
                        n_state, hb, dx, ddt, pb, pc, pa, s);
      break;
    case 4:
      err = launch_l<4>(x, dt, bm, cm, a, dy, dh_final, batch, seq, d_in,
                        n_state, hb, dx, ddt, pb, pc, pa, s);
      break;
    case 8:
      err = launch_l<8>(x, dt, bm, cm, a, dy, dh_final, batch, seq, d_in,
                        n_state, hb, dx, ddt, pb, pc, pa, s);
      break;
    case 16:
      err = launch_l<16>(x, dt, bm, cm, a, dy, dh_final, batch, seq, d_in,
                         n_state, hb, dx, ddt, pb, pc, pa, s);
      break;
    default:
      err = launch_l<32>(x, dt, bm, cm, a, dy, dh_final, batch, seq, d_in,
                         n_state, hb, dx, ddt, pb, pc, pa, s);
      break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int plan[3];
  selective_scan_bwd_plan(n_state, plan);
  const int nblk = (d_in + plan[0] - 1) / plan[0];
  const long long total = static_cast<long long>(batch) * seq * n_state +
                          static_cast<long long>(d_in) * n_state;
  long long blocks = (total + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  selective_scan_bwd_reduce<<<static_cast<int>(blocks), kReduceThreads, 0,
                              s>>>(pb, pc, pa, batch, seq, n_state, nblk,
                                   d_in, db, dc, da);
  return static_cast<int>(cudaGetLastError());
}

const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
