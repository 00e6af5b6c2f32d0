// Fused leaky integrate-and-fire membrane update, hand-written for Hopper
// (sm_90a).  Replaces lif_step_pallas (src/repro/kernels/lif_step.py:29,
// body _lif_kernel at :20):
//
//   v2      = fma(v, decay, i_syn)        one rounding, as XLA contracts it
//   spike   = v2 >= v_th
//   v_next  = spike ? v_reset : v2
//   spikes  = spike ? 1 : 0
//
// over contiguous float32 (rows, lanes) state, elementwise.  The reference
// runs this update under jax.jit, where XLA fuses v * decay + i into one
// fused multiply-add; fmaf is written out here so the rounding does not
// depend on nvcc's -fmad contraction.  decay, v_th and v_reset arrive
// already rounded to float32 (the reference's jnp.asarray(x, v.dtype)).
//
// Bound on an H100: bytes.  Each neuron reads v and i_syn and writes v_next
// and spikes, 16 bytes for four floating-point operations, far below the
// ~20 operations a byte at which the card's fp32 units would bind.  One
// thread per element in a grid-stride loop; neighbouring threads touch
// neighbouring words, so every warp's loads and stores coalesce.  A
// simple first version: no vector loads yet.
//
// Plain C entry points (loaded with ctypes): device pointers, the element
// count, the three parameters, the CUDA stream, and cudaGetLastError() as
// the return value.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // 16 blocks per SM, then stride

__global__ void __launch_bounds__(kThreads)
lif_step_kernel(const float* __restrict__ v, const float* __restrict__ i_syn,
                long long n, float decay, float v_th, float v_reset,
                float* __restrict__ v_next, float* __restrict__ spikes) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       k < n; k += stride) {
    const float v2 = fmaf(v[k], decay, i_syn[k]);
    const bool spike = v2 >= v_th;   // false for NaN, as in the reference
    v_next[k] = spike ? v_reset : v2;
    spikes[k] = spike ? 1.0f : 0.0f;
  }
}

}  // namespace

extern "C" {

int lif_step_launch(const float* v, const float* i_syn, long long n,
                    float decay, float v_th, float v_reset, float* v_next,
                    float* spikes, void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  lif_step_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      v, i_syn, n, decay, v_th, v_reset, v_next, spikes);
  return static_cast<int>(cudaGetLastError());
}

const char* lif_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
