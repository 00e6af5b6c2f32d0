// Mamba selective scan (the S6 recurrence), hand-written for Hopper
// (sm_90a).  Replaces selective_scan_pallas
// (src/repro/kernels/selective_scan.py:51, body _scan_kernel at :29):
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t     (h_0 = 0)
//   y_t = sum_n h_t[n] * C_t[n]
//
// x, dt: (batch, seq, d_in) float32; B, C: (batch, seq, N); A: (d_in, N);
// out y (batch, seq, d_in) and h_final (batch, d_in, N), all contiguous.
//
// Design: one thread per state element (b, d, n), holding h in a register
// for the whole sequence.  A channel (b, d) owns L lanes of one warp, L the
// least power of two >= N (16 lanes at N = 16, so two channels a warp);
// lanes n >= N carry zeros.  Each step a lane reads dt[b,t,d] and
// x[b,t,d] (the same word for the channel's lanes, one transaction) and
// B[b,t,n], C[b,t,n] (L neighbouring words), updates h, and a width-L
// __shfl_xor_sync butterfly sums h * C into y[b,t,d], which lane 0
// writes.  Blocks of 128 threads hold 128 / L channels; a block may
// straddle two batch rows.  The TPU kernel's (d_block, N) VMEM tile is a
// TPU tiling choice and is not carried over.
//
// Rounding: expf is the accurate one (no --use_fast_math, no __expf),
// and the update is written as a product and a sum rounded separately
// (__fmul_rn, __fadd_rn: nvcc may not contract them into an FMA), as
// the plain version in kernels/ref.py computes them, so h follows the
// plain version step for step.  y's N-term sum is a warp butterfly whose
// order the plain version's .sum(-1) need not share, so the two are held
// to a stated tolerance (on an H100 they agreed bit for bit on every
// case of tests/_torch_cases.py::scan_cases).  exp(dt * A) underflows
// to a subnormal or 0 for large dt * |A|, as in the plain version.
//
// Bound on an H100 at the serve shape (4, 2048, 8192, 16): x, dt and y
// are 268.4 MB each, B, C, A and h_final 3.3 MB, 809.0 MB in all,
// 0.241 ms at 3.35 TB/s; the 1.07e9 exponentials take 0.257 ms at the
// special function units' 16 a clock per SM (132 SMs, 1.98 GHz).  The
// exponentials bind.  Each thread walks seq dependent steps; the loads
// of kUnroll steps (which do not depend on h) are issued together
// before their updates.  A simple first version: 3.42 ms a launch at
// the serve shape on an H100 SXM at 700 W, 13x the bound; making it
// fast is later work.
//
// Plain C entry points (loaded with ctypes): device pointers, the sizes,
// the CUDA stream, and cudaGetLastError() as the return value.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

template <int L>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a, int batch, int seq,
                      int d_in, int n_state, float* __restrict__ y,
                      float* __restrict__ h_final) {
  constexpr int kChannels = kThreads / L;
  const int lane = threadIdx.x % L;
  const long long ch =
      static_cast<long long>(blockIdx.x) * kChannels + threadIdx.x / L;
  const bool live_ch = ch < static_cast<long long>(batch) * d_in;
  const bool live = live_ch && lane < n_state;
  const long long b = live_ch ? ch / d_in : 0;
  const long long d = live_ch ? ch % d_in : 0;
  const int n = live ? lane : 0;
  const float an = live ? a[d * n_state + n] : 0.0f;
  const long long row = b * seq;
  const float* xp = x + row * d_in + d;
  const float* dtp = dt + row * d_in + d;
  const float* bp = bm + row * n_state + n;
  const float* cp = cm + row * n_state + n;
  float* yp = y + row * d_in + d;

  float h = 0.0f;
  for (int t0 = 0; t0 < seq; t0 += kUnroll) {
    float xv[kUnroll], dv[kUnroll], bv[kUnroll], cv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = live && t0 + u < seq;
      const long long t = t0 + u;
      xv[u] = ok ? __ldg(xp + t * d_in) : 0.0f;
      dv[u] = ok ? __ldg(dtp + t * d_in) : 0.0f;
      bv[u] = ok ? __ldg(bp + t * n_state) : 0.0f;
      cv[u] = ok ? __ldg(cp + t * n_state) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < seq) {              // the same for every lane of a warp
        const float abar = expf(__fmul_rn(dv[u], an));
        const float bx = __fmul_rn(__fmul_rn(dv[u], xv[u]), bv[u]);
        h = __fadd_rn(__fmul_rn(abar, h), bx);
        float s = __fmul_rn(h, cv[u]);
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off, L);
        if (live && lane == 0) yp[static_cast<long long>(t0 + u) * d_in] = s;
      }
    }
  }
  if (live) h_final[ch * n_state + n] = h;
}

template <int L>
cudaError_t launch(const float* x, const float* dt, const float* bm,
                   const float* cm, const float* a, int batch, int seq,
                   int d_in, int n_state, float* y, float* h_final,
                   cudaStream_t stream) {
  constexpr int kChannels = kThreads / L;
  const long long blocks =
      (static_cast<long long>(batch) * d_in + kChannels - 1) / kChannels;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  selective_scan_kernel<L><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(x, dt, bm, cm, a, batch, seq, d_in,
                                       n_state, y, h_final);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int selective_scan_launch(const float* x, const float* dt, const float* bm,
                          const float* cm, const float* a, int batch,
                          int seq, int d_in, int n_state, float* y,
                          float* h_final, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || seq < 0 || d_in <= 0 || n_state < 1 || n_state > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (n_state == 1)
    err = launch<1>(x, dt, bm, cm, a, batch, seq, d_in, n_state, y,
                    h_final, s);
  else if (n_state == 2)
    err = launch<2>(x, dt, bm, cm, a, batch, seq, d_in, n_state, y,
                    h_final, s);
  else if (n_state <= 4)
    err = launch<4>(x, dt, bm, cm, a, batch, seq, d_in, n_state, y,
                    h_final, s);
  else if (n_state <= 8)
    err = launch<8>(x, dt, bm, cm, a, batch, seq, d_in, n_state, y,
                    h_final, s);
  else if (n_state <= 16)
    err = launch<16>(x, dt, bm, cm, a, batch, seq, d_in, n_state, y,
                     h_final, s);
  else
    err = launch<32>(x, dt, bm, cm, a, batch, seq, d_in, n_state, y,
                     h_final, s);
  return static_cast<int>(err);
}

const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
