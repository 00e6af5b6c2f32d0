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
// Sums run in float32 from +0 in slot order and are rounded once to val's
// type, as the plain version (kernels/ref.py::aer_decode) does, so a row
// gives the same bits on every run and equals it bit for bit.  No
// atomics, within a row or across rows.
//
// The reference's contraction also spreads non-finite values: dense[b]
// receives 0 * val[e] from every slot not addressed to b, and 0 * inf and
// 0 * NaN are NaN.  The kernel applies that rule explicitly: when a row
// holds non-finite values, every address is NaN except the one address
// (if there is one) that all of them are addressed to, which keeps its
// own sum.
//
// Design: a warp a row, up to eight rows (warps) a block, no
// __syncthreads.  Each warp owns a float32 accumulator row in shared
// memory (4 KB at block 1024) and 32 floats of staging beside it.  A lane
// loads its slots up front, 128 at a time (lane l holds slot 32k + l of
// chunk k, so chunk order is slot order): 4 idx and 4 val a lane at
// budget 128.  The row's non-finite count and the lowest and highest
// address they go to come from warp reductions (__reduce_add/min/max_sync)
// over those registers.  The warp zeroes its row with 16-byte shared
// stores, then adds chunk by chunk: __match_any_sync groups the lanes of a
// chunk that share an address; when every group is a single lane (the
// encoder's output, whose addresses are distinct), each lane adds its own
// value; otherwise the chunk's values are staged in shared memory and each
// group's lowest lane adds its group in lane order, with no reload from
// global memory.  __syncwarp between chunks.  Then the NaN rule, and the
// row goes out with 16-byte stores (scalar stores when block is not a
// multiple of 4 in float32 or 8 in bfloat16).
//
// Routes (aer_decode_plan reports which one a call takes), by a warp's
// shared memory, 4 * (roundup(block, 4) + 32) bytes:
//   warp        within the 48 KB default: min(8, 48 KB / that) warps a
//               block (8 at block 1024: 33,792 B), block <= 12,256;
//   warp_optin  past the default, within the card's opt-in limit (227 KB
//               on an H100): one warp a block, block <= 58,080;
//   global      past that (a row of more than 58,080 addresses): a block
//               of 256 threads a row accumulates in global memory — the
//               output row itself in float32, a float32 scratch row that
//               the caller allocates in bfloat16 — one warp adds the
//               slots as above, then the block applies the rule and
//               writes the row.  The same arithmetic in the same order.
//
// Bound on an H100: bytes.  Each row reads budget slots of 8 bytes and
// writes block values; at (16384, 1024), budget 128, float32, 84 MB,
// ~25 us at 3.35 TB/s, 80 % of it the dense rows written.  On sm_90a the
// warp kernel takes 30 registers a thread (32 on the global route), and a
// block of 8 warps 33,792 B of shared memory at block 1024, so six blocks
// (48 warps) share an SM; aer_decode_plan and chip_smoke.py report them.
//
// Plain C entry points (loaded with ctypes): device pointers, sizes, a
// dtype flag (0 float32, 1 bfloat16), the CUDA stream, and
// cudaGetLastError() as the return value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;           // rows (warps) a block, warp routes
constexpr int kChunks = 4;             // 32-slot chunks a lane loads at once
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kGlobalThreads = 256;    // the global route's block

enum Route { kWarp = 0, kWarpOptin = 1, kGlobal = 2 };

// values travel as raw bits: float32 as uint32_t, bfloat16 as uint16_t
__device__ __forceinline__ float to_f(uint32_t b) { return __uint_as_float(b); }
__device__ __forceinline__ float to_f(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}
// rounded once to the value type (round to nearest even)
__device__ __forceinline__ void from_f(float a, uint32_t* b) {
  *b = __float_as_uint(a);
}
__device__ __forceinline__ void from_f(float a, uint16_t* b) {
  *b = __bfloat16_as_ushort(__float2bfloat16_rn(a));
}

// floats of one warp's shared memory: the accumulator row, padded to 16
// bytes, then 32 floats of staging
__host__ __device__ __forceinline__ int warp_floats(int block) {
  return (block + 3) / 4 * 4 + 32;
}

// one slot: its address (block for "none") and its value in float32
template <typename B>
__device__ __forceinline__ void slot(const int* ir, const B* vr, int e,
                                     int budget, int block, int* c,
                                     float* v) {
  *c = block;
  *v = 0.0f;
  if (e < budget) {
    const int i = __ldg(ir + e);
    *c = (i >= 0 && i < block) ? i : block;
    *v = to_f(__ldg(vr + e));
  }
}

template <typename B>
__global__ void __launch_bounds__(kMaxWarps * 32)
aer_decode_kernel(const int* __restrict__ idx, const B* __restrict__ val,
                  int nb, int budget, int block, B* __restrict__ out) {
  extern __shared__ float4 smem[];
  constexpr int E = 16 / sizeof(B);   // values a 16-byte store
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= nb) return;   // the whole warp: no barrier below spans warps
  const int stride = warp_floats(block);
  float* acc = reinterpret_cast<float*>(smem) + warp * stride;
  float* stage = acc + stride - 32;
  const int* ir = idx + row * budget;
  const B* vr = val + row * budget;
  B* orow = out + row * block;

  const int n4 = (block + 3) / 4;
  for (int i = lane; i < n4; i += 32)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // non-finite slots of the row: how many, and the lowest and highest
  // address they go to (block stands for "no address")
  int nf = 0, lo = block + 1, hi = -1;
  for (int p = 0; p < budget; p += kChunks * 32) {
    int c[kChunks];
    float v[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
      slot(ir, vr, p + k * 32 + lane, budget, block, &c[k], &v[k]);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (!isfinite(v[k])) {
        ++nf;
        lo = min(lo, c[k]);
        hi = max(hi, c[k]);
      }
    }
    __syncwarp();   // the zeroed row, or the last pass's adds
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const unsigned grp = __match_any_sync(kFull, c[k]);
      const bool live = c[k] < block;
      if (__any_sync(kFull, live && (grp & (grp - 1)))) {
        // an address holds several slots of this chunk: its lowest lane
        // adds them in lane (slot) order from the staged values
        stage[lane] = v[k];
        __syncwarp();
        if (live && lane == __ffs(grp) - 1) {
          float a = acc[c[k]];
          for (unsigned g = grp; g; g &= g - 1) a += stage[__ffs(g) - 1];
          acc[c[k]] = a;
        }
      } else if (live) {
        acc[c[k]] += v[k];   // addresses of the chunk are distinct
      }
      __syncwarp();   // the next chunk may add to the same address
    }
  }
  __syncwarp();   // budget 0: the zeroed row
  nf = __reduce_add_sync(kFull, nf);
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  const int keep = (lo == hi && lo < block) ? lo : -1;
  const float nan = __int_as_float(0x7fc00000);

  if (block % E == 0) {
    // 16-byte stores: E values from 16-byte-aligned shared memory
    for (int i = lane; i < block / E; i += 32) {
      float a[E];
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const float4 f = reinterpret_cast<const float4*>(acc)[i * (E / 4) + q];
        a[4 * q] = f.x;
        a[4 * q + 1] = f.y;
        a[4 * q + 2] = f.z;
        a[4 * q + 3] = f.w;
      }
      B b[E];
#pragma unroll
      for (int j = 0; j < E; ++j)
        from_f((nf && i * E + j != keep) ? nan : a[j], &b[j]);
      uint4 u;
      if constexpr (E == 4) {
        u = make_uint4(b[0], b[1], b[2], b[3]);
      } else {
        u = make_uint4(b[0] | static_cast<uint32_t>(b[1]) << 16,
                       b[2] | static_cast<uint32_t>(b[3]) << 16,
                       b[4] | static_cast<uint32_t>(b[5]) << 16,
                       b[6] | static_cast<uint32_t>(b[7]) << 16);
      }
      reinterpret_cast<uint4*>(orow)[i] = u;
    }
  } else {
    for (int b = lane; b < block; b += 32) {
      B o;
      from_f((nf && b != keep) ? nan : acc[b], &o);
      orow[b] = o;
    }
  }
}

// The global route: a block of 256 threads a row, the float32 row in
// global memory (out itself for float32, a scratch row for bfloat16).
template <typename B>
__global__ void __launch_bounds__(kGlobalThreads)
aer_decode_global(const int* __restrict__ idx, const B* __restrict__ val,
                  int budget, int block, B* out, float* scratch) {
  __shared__ int red[3][32];
  const long long row = blockIdx.x;
  const int* ir = idx + row * budget;
  const B* vr = val + row * budget;
  // out and scratch may be one buffer (float32)
  float* acc = scratch + row * block;
  B* orow = out + row * block;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int nwarps = kGlobalThreads / 32;

  for (int b = threadIdx.x; b < block; b += kGlobalThreads) acc[b] = 0.0f;

  int nf = 0, lo = block + 1, hi = -1;
  for (int e = threadIdx.x; e < budget; e += kGlobalThreads) {
    int c;
    float v;
    slot(ir, vr, e, budget, block, &c, &v);
    if (!isfinite(v)) {
      ++nf;
      lo = min(lo, c);
      hi = max(hi, c);
    }
  }
  nf = __reduce_add_sync(kFull, nf);
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0) {
    red[0][warp] = nf;
    red[1][warp] = lo;
    red[2][warp] = hi;
  }
  __syncthreads();   // also: the zeroed accumulator before the adds

  if (warp == 0) {
    for (int base = 0; base < budget; base += 32) {
      int c;
      float v;
      slot(ir, vr, base + lane, budget, block, &c, &v);
      const unsigned grp = __match_any_sync(kFull, c);
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
  for (int b = threadIdx.x; b < block; b += kGlobalThreads) {
    B o;
    from_f((nf_row && b != keep) ? nan : acc[b], &o);
    orow[b] = o;
  }
}

int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

struct Plan {
  Route route;
  int warps;   // warps (rows) a block
  int smem;    // dynamic shared memory a block, bytes
};

Plan plan_of(int block) {
  const long long wb = 4LL * warp_floats(block);
  if (wb <= kDefaultSmem) {
    const int w = static_cast<int>(kDefaultSmem / wb);
    const int warps = w < kMaxWarps ? w : kMaxWarps;
    return {kWarp, warps, static_cast<int>(warps * wb)};
  }
  if (wb <= smem_optin()) return {kWarpOptin, 1, static_cast<int>(wb)};
  return {kGlobal, kGlobalThreads / 32, 0};
}

template <typename B>
const void* kernel_of(Route r) {
  return r == kGlobal
             ? reinterpret_cast<const void*>(aer_decode_global<B>)
             : reinterpret_cast<const void*>(aer_decode_kernel<B>);
}

template <typename B>
cudaError_t launch(const int* idx, const void* val, int nb, int budget,
                   int block, void* out, float* scratch,
                   cudaStream_t stream) {
  const B* v = static_cast<const B*>(val);
  B* o = static_cast<B*>(out);
  const Plan p = plan_of(block);
  if (p.route == kGlobal) {
    aer_decode_global<B><<<nb, kGlobalThreads, 0, stream>>>(
        idx, v, budget, block, o, scratch);
    return cudaGetLastError();
  }
  if (p.route == kWarpOptin) {
    const cudaError_t err = cudaFuncSetAttribute(
        aer_decode_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p.smem);
    if (err != cudaSuccess) return err;
  }
  const int grid = (nb + p.warps - 1) / p.warps;
  aer_decode_kernel<B><<<grid, p.warps * 32, p.smem, stream>>>(
      idx, v, nb, budget, block, o);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch a call with these operands takes: out[0] the route (Route
// above; 2 means a bfloat16 call needs a scratch row), out[1] registers a
// thread, out[2] static shared memory a block (bytes), out[3] dynamic
// shared memory a block, out[4] threads a block, out[5] local memory a
// thread (bytes; spills).
int aer_decode_plan(int block, int is_bf16, int* out) {
  const Plan p = plan_of(block);
  cudaFuncAttributes a{};
  const cudaError_t err = cudaFuncGetAttributes(
      &a, is_bf16 ? kernel_of<uint16_t>(p.route)
                  : kernel_of<uint32_t>(p.route));
  out[0] = p.route;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = p.smem;
  out[4] = p.warps * 32;
  out[5] = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(err);
}

// scratch: (nb, block) float32 when val is bfloat16 on the global route;
// otherwise unused (a float32 row accumulates in out)
int aer_decode_launch(const int* idx, const void* val, int nb, int budget,
                      int block, int is_bf16, void* out, float* scratch,
                      void* stream) {
  if (nb < 0 || budget < 0 || block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (plan_of(block).route == kGlobal && scratch == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch<uint16_t>(idx, val, nb, budget, block,
                                             out, scratch, s));
  }
  return static_cast<int>(launch<uint32_t>(idx, val, nb, budget, block, out,
                                           static_cast<float*>(out), s));
}

const char* aer_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
