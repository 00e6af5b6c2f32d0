// AER event decoder (the RX path of the transceiver), hand-written for
// Hopper (sm_90a).  Replaces aer_decode_pallas
// (src/repro/kernels/aer_decode.py:39, body _decode_kernel at :22):
//
//   dense[r, b] = sum of val[r, e] over the slots e with idx[r, e] == b
//
// over (nb, budget) event slots (idx int32, val float32 or bfloat16) into
// (nb, block) in val's type.  A slot whose idx is < 0 (void) or >= block
// addresses nothing.  The TPU kernel writes this as a one-hot matrix
// product because its vector memory has no scatter; on Hopper each slot
// adds straight into its address.
//
// Sums run in float32 from +0 and are rounded once to val's type, as the
// reference's float32 contraction is.  Duplicate addresses add in slot
// order, so a row gives the same bits on every run and equals the plain
// version (kernels/ref.py::aer_decode) bit for bit: one warp walks the
// slots 32 at a time, __match_any_sync groups the lanes of a chunk that
// share an address, and the group's lowest lane adds the group's values
// in lane order.  No atomics, within a row or across rows.
//
// The reference's contraction also spreads non-finite values: dense[b]
// receives 0 * val[e] from every slot not addressed to b, and 0 * inf and
// 0 * NaN are NaN.  The kernel applies that rule explicitly: when a row
// holds non-finite values, every address is NaN except the one address
// (if there is one) that all of them are addressed to, which keeps its
// own sum.
//
// Design: one thread block per row.  The row's float32 accumulator sits
// in shared memory while block * 4 bytes fit the device's opt-in limit
// (227 KB on an H100, so up to ~58,000 addresses); past that it is the
// output row itself (float32) or a float32 scratch row that the caller
// allocates (bfloat16), in global memory — a layout choice inside the
// kernel, the same arithmetic in the same order.  The block zeroes the
// accumulator, warp 0 adds the slots, and the block writes the row once.
//
// Bound on an H100: bytes.  Each row reads budget slots of 8 bytes and
// writes block values; at (16384, 1024), budget 128, float32, 84 MB,
// ~25 us at 3.35 TB/s.  A simple first version: one warp walks the slots
// while the others wait.
//
// Plain C entry points (loaded with ctypes): device pointers, sizes, a
// dtype flag (0 float32, 1 bfloat16), the CUDA stream, and
// cudaGetLastError() as the return value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStaticSmem = 1024;   // the reduction scratch, rounded up

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
aer_decode_kernel(const int* __restrict__ idx, const T* __restrict__ val,
                  int budget, int block, T* out, float* scratch) {
  extern __shared__ float smem[];
  __shared__ int red[3][32];
  const long long row = blockIdx.x;
  const int* ir = idx + row * budget;
  const T* vr = val + row * budget;
  // out and scratch may be one buffer (float32 past the shared limit)
  float* acc = kShared ? smem : scratch + row * block;
  T* orow = out + row * block;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int nwarps = kThreads / 32;

  for (int b = threadIdx.x; b < block; b += kThreads) acc[b] = 0.0f;

  // non-finite slots of the row: how many, and the lowest and highest
  // address they go to (block stands for "no address")
  int nf = 0, lo = block + 1, hi = -1;
  for (int e = threadIdx.x; e < budget; e += kThreads) {
    if (!isfinite(to_f(vr[e]))) {
      const int i = ir[e];
      const int c = (i >= 0 && i < block) ? i : block;
      ++nf;
      lo = min(lo, c);
      hi = max(hi, c);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    nf += __shfl_xor_sync(0xffffffffu, nf, d);
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
  }
  if (lane == 0) {
    red[0][warp] = nf;
    red[1][warp] = lo;
    red[2][warp] = hi;
  }
  __syncthreads();   // also: the zeroed accumulator before the adds

  if (warp == 0) {
    for (int base = 0; base < budget; base += 32) {
      const int e = base + lane;
      int c = block;
      if (e < budget) {
        const int i = ir[e];
        c = (i >= 0 && i < block) ? i : block;
      }
      const unsigned grp = __match_any_sync(0xffffffffu, c);
      if (c < block && lane == __ffs(grp) - 1) {
        float a = acc[c];
        for (unsigned g = grp; g; g &= g - 1)
          a += to_f(vr[base + __ffs(g) - 1]);
        acc[c] = a;
      }
      __syncwarp();   // the next chunk may add to the same address
    }
  }
  __syncthreads();

  int nf_row = 0, lo_row = block + 1, hi_row = -1;
  for (int w = 0; w < nwarps; ++w) {
    nf_row += red[0][w];
    lo_row = min(lo_row, red[1][w]);
    hi_row = max(hi_row, red[2][w]);
  }
  const int keep = (lo_row == hi_row && lo_row < block) ? lo_row : -1;
  const float nan = __int_as_float(0x7fc00000);
  for (int b = threadIdx.x; b < block; b += kThreads) {
    const float a = (nf_row && b != keep) ? nan : acc[b];
    store(orow + b, a);
  }
}

int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

bool fits_shared(int block) {
  return static_cast<long long>(block) * 4 + kStaticSmem <= smem_optin();
}

template <typename T>
cudaError_t launch(const int* idx, const void* val, int nb, int budget,
                   int block, void* out, float* scratch,
                   cudaStream_t stream) {
  const T* v = static_cast<const T*>(val);
  T* o = static_cast<T*>(out);
  if (fits_shared(block)) {
    const int bytes = block * 4;
    // the 48 KB default covers dynamic and static shared memory together
    if (bytes + kStaticSmem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          aer_decode_kernel<T, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
    }
    aer_decode_kernel<T, true><<<nb, kThreads, bytes, stream>>>(
        idx, v, budget, block, o, nullptr);
  } else {
    aer_decode_kernel<T, false><<<nb, kThreads, 0, stream>>>(
        idx, v, budget, block, o, scratch);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when a float32 accumulator row of `block` addresses fits shared
// memory (no scratch needed), else 0; the return value is the CUDA error
int aer_decode_fits_shared(int block, int* fits) {
  *fits = fits_shared(block) ? 1 : 0;
  return static_cast<int>(cudaGetLastError());
}

// scratch: (nb, block) float32 when val is bfloat16 and the row does not
// fit shared memory; otherwise unused (a float32 row accumulates in out)
int aer_decode_launch(const int* idx, const void* val, int nb, int budget,
                      int block, int is_bf16, void* out, float* scratch,
                      void* stream) {
  if (nb < 0 || budget < 0 || block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (!fits_shared(block) && scratch == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch<__nv_bfloat16>(idx, val, nb, budget,
                                                   block, out, scratch, s));
  }
  return static_cast<int>(launch<float>(idx, val, nb, budget, block, out,
                                        static_cast<float*>(out), s));
}

const char* aer_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
