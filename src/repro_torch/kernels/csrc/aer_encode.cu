// AER event encoder (the TX path of the transceiver), hand-written for
// Hopper (sm_90a).  Replaces aer_encode_pallas
// (src/repro/kernels/aer_encode.py:67, body _encode_kernel at :33):
//
//   mask[b]  = |x[b]| >= tau  &&  x[b] != 0          (zeros never ship)
//   csum[b]  = inclusive prefix sum of mask over the row
//   slot csum[b] - 1 takes (b, x[b]) where mask[b] && csum[b] <= budget
//   idx = -1 in the void slots; count = min(wanted, budget); wanted = csum
//   of the row's last entry
//
// over (nb, block) tiles of float32 or bfloat16, one (nb,) threshold in
// the same type.  The TPU kernel writes the compaction as two one-hot
// matrix products because its vector memory has no scatter; on Hopper it
// is plain stream compaction: a block-wide prefix sum, then each selected
// entry writes its own slot.
//
// The reference's contraction also spreads non-finite values: slot e
// receives x[b_e] + sum over b != b_e of 0 * x[b], and 0 * inf and 0 * NaN
// are NaN.  The kernel reproduces that rule from a per-row count of
// non-finite entries: after the compaction, a slot is NaN when the row
// holds a non-finite entry at another position than its own, and a void
// slot is NaN when the row holds any (else 0).
//
// Design: one thread block per row, one thread per entry of a tile of
// blockDim.x (a multiple of 32, at most 1024) entries; longer rows loop
// over tiles with the count selected so far carried.  The scan is a warp
// scan with __shfl_up_sync, then one warp scans the warp totals in shared
// memory.  No atomics: every slot has exactly one writer.
//
// Bound on an H100: bytes.  The row is read once (4 bytes an entry in
// float32) and budget slots of 8 bytes are written, with a handful of
// integer operations an entry — far below the card's integer rate.  At
// (16384, 1024), budget 128, that is 84 MB, ~25 us at 3.35 TB/s.  A
// simple first version: one row a block (at block 128 only 128 threads
// are busy in a block), scalar loads.
//
// Plain C entry points (loaded with ctypes): device pointers, sizes, a
// dtype flag (0 float32, 1 bfloat16), the CUDA stream, and
// cudaGetLastError() as the return value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxBlock = 1 << 16;   // EVENT_MAX_BLOCK: 16-bit addresses

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T nan_of();
template <>
__device__ __forceinline__ float nan_of<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ __nv_bfloat16 nan_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(static_cast<unsigned short>(0x7fc0));
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(static_cast<unsigned short>(0));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
aer_encode_kernel(const T* __restrict__ x, const T* __restrict__ tau,
                  int block, int budget, int* __restrict__ idx,
                  T* __restrict__ val, int* __restrict__ count,
                  int* __restrict__ wanted) {
  __shared__ int warp_tot[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * block;
  int* ir = idx + row * budget;
  T* vr = val + row * budget;
  const float t = to_f(tau[row]);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  int carry = 0;   // entries selected in earlier tiles (same in every thread)
  int nf = 0;      // non-finite entries this thread has seen
  for (int base = 0; base < block; base += blockDim.x) {
    const int b = base + threadIdx.x;
    T xv = zero_of<T>();
    int m = 0;
    if (b < block) {
      xv = xr[b];
      const float f = to_f(xv);
      m = (fabsf(f) >= t) && (f != 0.0f);   // false for NaN and tau NaN
      nf += !isfinite(f);
    }
    // inclusive block scan of m: warp scan, then a scan of warp totals
    int s = m;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane == 31) warp_tot[warp] = s;
    __syncthreads();
    if (warp == 0) {
      int w = lane < nwarps ? warp_tot[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      if (lane < nwarps) warp_tot[lane] = w;
    }
    __syncthreads();
    const int csum = carry + s + (warp ? warp_tot[warp - 1] : 0);
    if (m && csum <= budget) {
      ir[csum - 1] = b;
      vr[csum - 1] = xv;
    }
    carry += warp_tot[nwarps - 1];
    __syncthreads();   // warp_tot is rewritten by the next tile
  }

  // the row's count of non-finite entries
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) nf += __shfl_xor_sync(0xffffffffu, nf, d);
  if (lane == 0) warp_tot[warp] = nf;
  __syncthreads();
  int nf_row = 0;
  for (int w = 0; w < nwarps; ++w) nf_row += warp_tot[w];

  const int cnt = carry < budget ? carry : budget;
  if (threadIdx.x == 0) {
    count[row] = cnt;
    wanted[row] = carry;
  }
  const T fill = nf_row ? nan_of<T>() : zero_of<T>();
  for (int e = cnt + threadIdx.x; e < budget; e += blockDim.x) {
    ir[e] = -1;
    vr[e] = fill;
  }
  if (nf_row) {
    // the slots were written before the barriers above, so every thread
    // of the block reads them back; a slot keeps its value only when it
    // holds the row's one non-finite entry
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      const int own_bad = !isfinite(to_f(xr[ir[e]]));
      if (nf_row - own_bad > 0) vr[e] = nan_of<T>();
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* tau, int nb, int block,
                   int budget, int* idx, void* val, int* count, int* wanted,
                   cudaStream_t stream) {
  int threads = (block + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  aer_encode_kernel<T><<<nb, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(tau), block, budget,
      idx, static_cast<T*>(val), count, wanted);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int aer_encode_launch(const void* x, const void* tau, int nb, int block,
                      int budget, int is_bf16, int* idx, void* val,
                      int* count, int* wanted, void* stream) {
  if (nb < 0 || block < 1 || block > kMaxBlock || budget < 1 ||
      budget > block)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, tau, nb, block, budget, idx, val,
                                      count, wanted, s)
              : launch<float>(x, tau, nb, block, budget, idx, val, count,
                              wanted, s);
  return static_cast<int>(err);
}

const char* aer_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
