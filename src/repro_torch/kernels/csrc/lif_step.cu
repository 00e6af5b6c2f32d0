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
// ~20 operations a byte at which the card's fp32 units would bind.  So the
// design keeps as many bytes in flight as the memory needs:
//  * 16-byte vectors: when all four arrays start on a 16-byte boundary, a
//    thread loads a float4 of v and of i_syn and stores a float4 of each
//    output, four neurons a trip; the 0-3 neurons past the last whole
//    vector, and the whole array when any pointer is misaligned, take the
//    scalar loop of the same kernel;
//  * streaming loads and stores (ld/st.global.cs): each word is touched
//    once, so it is marked to leave the caches first;
//  * a grid sized from the card's SMs: at most as many blocks as fit on
//    every SM at once (8 of 256 threads, 2,048 threads an SM), each
//    thread striding over the rest, so a large array streams with every
//    SM full and no second wave of blocks; a small one takes one block
//    per 256 vectors.
// At the co-simulation's (16, 128) the whole update is 32 KB, far below
// a launch: there the kernel is one load round trip and one store.  On an
// H100 (PERF.md, Findings) it runs within 0.1 µs of torch.add on the same
// shape at (16, 128) and (32, 128), and at 83 % of its bytes bound at
// (65536, 128), where two quads a trip did no better.
//
// Plain C entry points (loaded with ctypes): device pointers, the element
// count, the three parameters, the CUDA stream, and cudaGetLastError() as
// the return value.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2048 / kThreads;   // full occupancy, 1 wave

__device__ __forceinline__ void lif_one(float v, float i, float decay,
                                        float v_th, float v_reset,
                                        float& v_next, float& spike) {
  const float v2 = fmaf(v, decay, i);
  const bool s = v2 >= v_th;   // false for NaN, as in the reference
  v_next = s ? v_reset : v2;
  spike = s ? 1.0f : 0.0f;
}

// vec: all four pointers are 16-byte aligned.  Then quads [0, n / 4) go
// as float4 and the scalar loop takes [4 * (n / 4), n); else the scalar
// loop takes [0, n).
__global__ void __launch_bounds__(kThreads)
lif_step_kernel(const float* __restrict__ v, const float* __restrict__ i_syn,
                long long n, float decay, float v_th, float v_reset,
                float* __restrict__ v_next, float* __restrict__ spikes,
                bool vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  long long head = 0;
  if (vec) {
    const long long quads = n >> 2;
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const float4* i4 = reinterpret_cast<const float4*>(i_syn);
    float4* o4 = reinterpret_cast<float4*>(v_next);
    float4* s4 = reinterpret_cast<float4*>(spikes);
    for (long long k = tid; k < quads; k += stride) {
      const float4 a = __ldcs(v4 + k);
      const float4 b = __ldcs(i4 + k);
      float4 o, s;
      lif_one(a.x, b.x, decay, v_th, v_reset, o.x, s.x);
      lif_one(a.y, b.y, decay, v_th, v_reset, o.y, s.y);
      lif_one(a.z, b.z, decay, v_th, v_reset, o.z, s.z);
      lif_one(a.w, b.w, decay, v_th, v_reset, o.w, s.w);
      __stcs(o4 + k, o);
      __stcs(s4 + k, s);
    }
    head = quads << 2;
  }
  for (long long k = head + tid; k < n; k += stride) {
    lif_one(v[k], i_syn[k], decay, v_th, v_reset, v_next[k], spikes[k]);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms < 1) {
      sms = 132;   // an H100 SXM's count; the launch's own error reports
    }
  }
  return sms;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

int lif_step_launch(const float* v, const float* i_syn, long long n,
                    float decay, float v_th, float v_reset, float* v_next,
                    float* spikes, void* stream) {
  const bool vec = aligned16(v) && aligned16(i_syn) && aligned16(v_next) &&
                   aligned16(spikes);
  // one thread a vector (or an element on the scalar route)
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sm_count()) * kBlocksPerSm;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  lif_step_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      v, i_syn, n, decay, v_th, v_reset, v_next, spikes, vec);
  return static_cast<int>(cudaGetLastError());
}

const char* lif_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
