// Mamba selective scan (the S6 recurrence), hand-written for Hopper
// (sm_90a).  Replaces selective_scan_pallas
// (src/repro/kernels/selective_scan.py:51, body _scan_kernel at :29):
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t     (h_0 = 0)
//   y_t = sum_n h_t[n] * C_t[n]
//
// x, dt: (batch, seq, d_in) float32; B, C: (batch, seq, N); A: (d_in, N);
// out y (batch, seq, d_in) and h_final (batch, d_in, N), all contiguous.
// N runs from 1 to 32, d_in is any width, seq >= 0.
//
// What bounds it on an H100.  At the serve shape (4, 2048, 8192, 16) the
// 1.07e9 exponentials take 0.257 ms on the special function units (16 a
// clock per SM, 132 SMs, 1.98 GHz); the bytes come close: x, dt and y
// are 268.4 MB each, B, C, A and h_final 3.3 MB, 809.0 MB in all, 0.241
// ms at 3.35 TB/s.  The accurate expf is some ten instructions beside its
// one special-function op, so the instruction count comes next: about
// 15 an element-step is ~0.5 ms at four warp instructions a clock per SM.
// Tensor cores have no part here: Mamba-1's A is per (channel, state),
// so the recurrence is elementwise, not a matrix product.
//
// Design.  The first version gave each state element a thread, summed
// h * C with a 4-round warp butterfly every step (a latency chain on h),
// computed dt * x once a state, read dt and x 4 bytes a lane at stride
// d_in, and prefetched 8 steps in registers (122-128 a thread, 25 %
// occupancy): 3.42 ms a launch, 13x the bound.  Here:
//
//   1. A channel (b, d) belongs to two threads (one where N = 1), each
//      holding L / 2 of its states' h in registers (L = N rounded up to
//      a power of two), with dt * x formed once a channel-step and h * C
//      summed in registers, then one shuffle round.  At the serve shape
//      that gives 65,536 threads, 16 warps an SM at 56 registers; of 1,
//      2 and 4 threads a channel, timed in one chip call at that shape,
//      two were the fastest (PERF.md).
//   2. A block of 128 threads walks the sequence in tiles of kSteps steps
//      through a two-stage ring in shared memory: its channels' (kSteps,
//      channels) tiles of dt and x and the batch row's (kSteps, N) tiles
//      of B and C arrive by cp.async, 16 bytes a thread with neighbouring
//      channels at neighbouring addresses (4 bytes where d_in or N is not
//      a multiple of 4), and the next tile's copy overlaps this tile's
//      work.  y goes out the same way, staged as a (kSteps, channels)
//      tile.  No register prefetch is left.
//   3. Rounding: the accurate expf (no --use_fast_math, no __expf), and
//      each state's update a product and a sum rounded apart (__fmul_rn,
//      __fadd_rn: nvcc may not contract them into an FMA), in the plain
//      version's order, so h follows kernels/ref.py step for step.  A
//      thread's states are n = sub + TPC * j, so the register tree over j
//      and then the shuffles over sub add h * C in the first version's
//      butterfly order (offsets L/2 down to 1); y is held to a stated
//      tolerance all the same, as the plain version's .sum(-1) need not
//      share that order.  exp(dt * A) underflows to a subnormal or 0 for
//      large dt * |A|, as in the plain version.
//
// This design takes ~0.76 ms a launch at the serve shape on an H100 SXM
// at 700 W, ~3x the bound, with 56 registers a thread; what binds it
// now (the special function units, instruction slots or the tile
// barriers) is not measured.
//
// Plain C entry points (loaded with ctypes): device pointers, the sizes,
// the CUDA stream, and cudaGetLastError() as the return value.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kSteps = 32;    // steps a tile
constexpr int kThreadsPerChannel = 2;
constexpr int kStages = 2;    // tiles in flight

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A B or C tile row holds a thread's states side by side where a thread
// has four or more of them and shares its channel (state n at
// (n % TPC) * (L / TPC) + n / TPC, so that the thread reads its states
// 16 bytes at a time); else in order, n at n.
template <int L, int TPC>
struct BcLayout {
  static constexpr bool kPermuted = TPC > 1 && L / TPC >= 4;
  __host__ __device__ static int pitch(int n_state) {
    return kPermuted ? L : (n_state + 3) / 4 * 4;
  }
  __device__ static int pos(int n) {
    return kPermuted ? (n % TPC) * (L / TPC) + n / TPC : n;
  }
};

// Shared memory of a block, in floats: dt and x tiles of `channels` and
// B and C tiles of `bc_pitch` words a row, kStages each, then the y tile.
__host__ __device__ constexpr int smem_floats(int channels, int bc_pitch) {
  return kStages * kSteps * (2 * channels + 2 * bc_pitch) +
         kSteps * channels;
}

// kFull: n_state == L, so no state of a thread is padding.
template <int L, int TPC, bool kFull>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a, int seq, int d_in,
                      int n_state, bool vec_dx, bool vec_bc, bool vec_y,
                      float* __restrict__ y, float* __restrict__ h_final) {
  using Bc = BcLayout<L, TPC>;
  constexpr int kCh = kThreads / TPC;   // channels a block
  constexpr int kNpt = L / TPC;         // states a thread
  const int bp = Bc::pitch(n_state);
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int tid = threadIdx.x;
  const int cl = tid / TPC;
  const int sub = tid % TPC;
  const int d = d0 + cl;
  const bool live = d < d_in;
  const int nch = min(kCh, d_in - d0);  // live channels of the block

  extern __shared__ __align__(16) float sm[];
  float* s_dt = sm;                                 // [stage][step][ch]
  float* s_x = s_dt + kStages * kSteps * kCh;
  float* s_b = s_x + kStages * kSteps * kCh;        // [stage][step][bp]
  float* s_c = s_b + kStages * kSteps * bp;
  float* s_y = s_c + kStages * kSteps * bp;         // [step][ch]

  const long long row0 = static_cast<long long>(b) * seq;

  // one tile's copies (this thread's share), committed as one group
  auto load_tile = [&](int stage, int t0) {
    const int nt = min(kSteps, seq - t0);
    const long long r = row0 + t0;
    float* ddt = s_dt + stage * kSteps * kCh;
    float* dx = s_x + stage * kSteps * kCh;
    if (vec_dx) {
      const int cpr = nch / 4;   // 16-byte chunks a row
      for (int i = tid; i < nt * cpr; i += kThreads) {
        const int rr = i / cpr;
        const int c = 4 * (i - rr * cpr);
        const long long g = (r + rr) * d_in + d0 + c;
        cp16(ddt + rr * kCh + c, dt + g);
        cp16(dx + rr * kCh + c, x + g);
      }
    } else {
      for (int i = tid; i < nt * nch; i += kThreads) {
        const int rr = i / nch;
        const int c = i - rr * nch;
        const long long g = (r + rr) * d_in + d0 + c;
        cp4(ddt + rr * kCh + c, dt + g);
        cp4(dx + rr * kCh + c, x + g);
      }
    }
    float* db = s_b + stage * kSteps * bp;
    float* dc = s_c + stage * kSteps * bp;
    const long long g0 = r * n_state;
    if (!Bc::kPermuted && vec_bc) {   // bp == n_state: one contiguous block
      for (int i = 4 * tid; i < nt * n_state; i += 4 * kThreads) {
        cp16(db + i, bm + g0 + i);
        cp16(dc + i, cm + g0 + i);
      }
    } else {
      for (int i = tid; i < nt * n_state; i += kThreads) {
        const int rr = i / n_state;
        const int at = rr * bp + Bc::pos(i - rr * n_state);
        cp4(db + at, bm + g0 + i);
        cp4(dc + at, cm + g0 + i);
      }
    }
  };

  float h[kNpt];
  float an[kNpt];
#pragma unroll
  for (int j = 0; j < kNpt; ++j) {
    const int n = sub + TPC * j;
    h[j] = 0.0f;
    an[j] = (live && (kFull || n < n_state))
        ? a[static_cast<long long>(d) * n_state + n] : 0.0f;
  }

  const int n_tiles = (seq + kSteps - 1) / kSteps;
  if (n_tiles > 0) load_tile(0, 0);
  cp_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kSteps;
    const int nt = min(kSteps, seq - t0);
    if (tile + 1 < n_tiles) load_tile((tile + 1) % kStages, t0 + kSteps);
    cp_commit();
    cp_wait_one();               // this tile's group has landed
    __syncthreads();
    const int stage = tile % kStages;
    const float* tdt = s_dt + stage * kSteps * kCh;
    const float* tx = s_x + stage * kSteps * kCh;
    const float* tb = s_b + stage * kSteps * bp;
    const float* tc = s_c + stage * kSteps * bp;
    for (int tt = 0; tt < nt; ++tt) {
      const float dtv = tdt[tt * kCh + cl];
      const float dtx = __fmul_rn(dtv, tx[tt * kCh + cl]);
      float bv[kNpt];
      float cv[kNpt];
      if constexpr (kNpt >= 4 && (TPC == 1 || Bc::kPermuted)) {
        // 16-byte loads of this thread's states; past n_state they read
        // words of the tile that the update below ignores
        const float4* b4 = reinterpret_cast<const float4*>(
            tb + tt * bp + (Bc::kPermuted ? sub * kNpt : 0));
        const float4* c4 = reinterpret_cast<const float4*>(
            tc + tt * bp + (Bc::kPermuted ? sub * kNpt : 0));
#pragma unroll
        for (int q = 0; q < kNpt / 4; ++q) {
          const float4 u = b4[q];
          const float4 w = c4[q];
          bv[4 * q] = u.x;
          bv[4 * q + 1] = u.y;
          bv[4 * q + 2] = u.z;
          bv[4 * q + 3] = u.w;
          cv[4 * q] = w.x;
          cv[4 * q + 1] = w.y;
          cv[4 * q + 2] = w.z;
          cv[4 * q + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNpt; ++j) {
          const int n = sub + TPC * j;
          bv[j] = (kFull || n < n_state) ? tb[tt * bp + n] : 0.0f;
          cv[j] = (kFull || n < n_state) ? tc[tt * bp + n] : 0.0f;
        }
      }
      float v[kNpt];
#pragma unroll
      for (int j = 0; j < kNpt; ++j) {
        const int n = sub + TPC * j;
        if (kFull || n < n_state) {
          const float abar = expf(__fmul_rn(dtv, an[j]));
          const float bx = __fmul_rn(dtx, bv[j]);
          h[j] = __fadd_rn(__fmul_rn(abar, h[j]), bx);
          v[j] = __fmul_rn(h[j], cv[j]);
        } else {
          v[j] = 0.0f;
        }
      }
      // the first version's butterfly order: offsets L/2 .. TPC in
      // registers, then TPC/2 .. 1 across the channel's threads
#pragma unroll
      for (int off = kNpt / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < off; ++j) v[j] = __fadd_rn(v[j], v[j + off]);
      }
      float s = v[0];
#pragma unroll
      for (int off = TPC / 2; off > 0; off >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off, TPC));
      if (sub == 0) s_y[tt * kCh + cl] = s;
    }
    __syncthreads();             // y tile complete; this stage is read
    const long long r = row0 + t0;
    if (vec_y) {
      const int cpr = nch / 4;
      for (int i = tid; i < nt * cpr; i += kThreads) {
        const int rr = i / cpr;
        const int c = 4 * (i - rr * cpr);
        *reinterpret_cast<float4*>(y + (r + rr) * d_in + d0 + c) =
            *reinterpret_cast<const float4*>(s_y + rr * kCh + c);
      }
    } else {
      for (int i = tid; i < nt * nch; i += kThreads) {
        const int rr = i / nch;
        const int c = i - rr * nch;
        y[(r + rr) * d_in + d0 + c] = s_y[rr * kCh + c];
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (live) {
    float* hp = h_final + (static_cast<long long>(b) * d_in + d) * n_state;
#pragma unroll
    for (int j = 0; j < kNpt; ++j) {
      const int n = sub + TPC * j;
      if (kFull || n < n_state) hp[n] = h[j];
    }
  }
}

template <int L, int TPC, bool kFull>
cudaError_t launch_one(const float* x, const float* dt, const float* bm,
                       const float* cm, const float* a, int batch, int seq,
                       int d_in, int n_state, float* y, float* h_final,
                       cudaStream_t stream) {
  constexpr int kCh = kThreads / TPC;
  const int smem =
      4 * smem_floats(kCh, BcLayout<L, TPC>::pitch(n_state));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        selective_scan_kernel<L, TPC, kFull>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec_dx = d_in % 4 == 0 && aligned(x) && aligned(dt);
  const bool vec_bc = n_state % 4 == 0 && aligned(bm) && aligned(cm);
  const bool vec_y = d_in % 4 == 0 && aligned(y);
  const dim3 grid((d_in + kCh - 1) / kCh, batch);
  selective_scan_kernel<L, TPC, kFull><<<grid, kThreads, smem, stream>>>(
      x, dt, bm, cm, a, seq, d_in, n_state, vec_dx, vec_bc, vec_y, y,
      h_final);
  return cudaGetLastError();
}

template <int L, int TPC>
cudaError_t launch(const float* x, const float* dt, const float* bm,
                   const float* cm, const float* a, int batch, int seq,
                   int d_in, int n_state, float* y, float* h_final,
                   cudaStream_t stream) {
  if (n_state == L)
    return launch_one<L, TPC, true>(x, dt, bm, cm, a, batch, seq, d_in,
                                    n_state, y, h_final, stream);
  return launch_one<L, TPC, false>(x, dt, bm, cm, a, batch, seq, d_in,
                                   n_state, y, h_final, stream);
}

// TPC threads a channel: kThreadsPerChannel, at most L.
template <int L>
cudaError_t launch_l(const float* x, const float* dt, const float* bm,
                     const float* cm, const float* a, int batch, int seq,
                     int d_in, int n_state, float* y, float* h_final,
                     cudaStream_t s) {
  constexpr int kTpc = L < kThreadsPerChannel ? L : kThreadsPerChannel;
  return launch<L, kTpc>(x, dt, bm, cm, a, batch, seq, d_in, n_state, y,
                         h_final, s);
}

}  // namespace

extern "C" {

int selective_scan_launch(const float* x, const float* dt, const float* bm,
                          const float* cm, const float* a, int batch,
                          int seq, int d_in, int n_state, float* y,
                          float* h_final, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || batch > 65535 || seq < 0 || d_in <= 0 || n_state < 1 ||
      n_state > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (n_state == 1)
    err = launch_l<1>(x, dt, bm, cm, a, batch, seq, d_in, n_state, y,
                      h_final, s);
  else if (n_state == 2)
    err = launch_l<2>(x, dt, bm, cm, a, batch, seq, d_in, n_state, y,
                      h_final, s);
  else if (n_state <= 4)
    err = launch_l<4>(x, dt, bm, cm, a, batch, seq, d_in, n_state, y,
                      h_final, s);
  else if (n_state <= 8)
    err = launch_l<8>(x, dt, bm, cm, a, batch, seq, d_in, n_state, y,
                      h_final, s);
  else if (n_state <= 16)
    err = launch_l<16>(x, dt, bm, cm, a, batch, seq, d_in, n_state, y,
                       h_final, s);
  else
    err = launch_l<32>(x, dt, bm, cm, a, batch, seq, d_in, n_state, y,
                       h_final, s);
  return static_cast<int>(err);
}

const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
