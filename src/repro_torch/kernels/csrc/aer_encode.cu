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
// is plain stream compaction: each selected entry writes its own slot.
//
// The reference's contraction also spreads non-finite values: slot e
// receives x[b_e] + sum over b != b_e of 0 * x[b], and 0 * inf and 0 * NaN
// are NaN.  The kernel applies that rule from the row's count of
// non-finite entries, nf: a slot is NaN when nf - own_bad > 0 (the row
// holds a non-finite entry at another position than its own), and a void
// slot is NaN when nf > 0, else 0.
//
// Design: a warp a row, eight rows (warps) a block, no __syncthreads.  A
// warp takes its row in tiles of 1,024 entries and issues every load of a
// tile before any scan: on the vector route, 16-byte loads, lane l holding
// entries 32E·c + E·l + j of chunk c (E = 4 float32 or 8 bfloat16 a load,
// 1024 / 32E chunks a tile); on the scalar route, E = 1 and lane l holds
// entry 32c + l of each of 32 chunks.  The tile's non-finite entries are
// counted first and summed over the warp with __reduce_add_sync, so the
// NaN rule is known before any slot is written.  Then, chunk by chunk, one
// ballot a plane j of the chunk's entries: an entry's slot is the carry of
// the earlier chunks and tiles + sum over j' of popc(ballot_j' &
// lanemask_lt) + the lane's own selected entries before it in the chunk
// (ballots, not a chain of shuffles), and the lane that holds a selected
// entry writes its slot with the rule applied, from its registers.  The
// mask |x| >= tau && x != 0 is one comparison, |x| >= t, where a threshold
// that is not positive (nor NaN) is replaced by the least subnormal.  A
// row of several tiles writes its slots with the count so far; if its
// final count is not 0, the warp then applies the rule again to its own
// slots (read back from val, never from x).  Slots are written straight
// to global memory, one writer each (staging them in shared memory and
// storing 16 bytes at a time was no faster); the void slots get -1 and
// NaN or 0, 32 lanes side by side.
//
// Routes (aer_encode_plan reports which one a call takes):
//   vector        16-byte loads, one tile: block a multiple of 4
//                 (float32) or 8 (bfloat16), x 16-byte aligned, and
//                 block <= 1024;
//   vector_tiles  the same above 1,024 entries: the warp loops over
//                 1,024-entry tiles with the carry;
//   scalar        any other block or an x that is not 16-byte aligned
//                 (a view with an odd storage offset), block <= 1024;
//   scalar_tiles  the same above 1,024 entries.
//
// Bound on an H100: bytes.  The row is read once (4 bytes an entry in
// float32) and budget slots of 8 bytes are written, with a handful of
// integer operations an entry — far below the card's integer rate.  At
// (16384, 1024), budget 128, that is 84 MB, ~25 us at 3.35 TB/s.  A warp
// keeps 4 KB of its row in flight (32 registers of values a lane in
// float32).  What limits it is how many warps an SM holds: on sm_90a the
// vector float32 kernel takes 54 registers a thread (no spills), so four
// 256-thread blocks share an SM (79 in bfloat16, 80 and 119 on the scalar
// routes; aer_encode_plan and chip_smoke.py report them).  No shared
// memory.
//
// Plain C entry points (loaded with ctypes): device pointers, sizes, a
// dtype flag (0 float32, 1 bfloat16), the CUDA stream, and
// cudaGetLastError() as the return value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;            // rows (warps) a block
constexpr int kTile = 1024;          // entries a warp holds at once
constexpr int kMaxBlock = 1 << 16;   // EVENT_MAX_BLOCK: 16-bit addresses

enum Route { kVector = 0, kVectorTiles = 1, kScalar = 2, kScalarTiles = 3 };

// values travel as raw bits: float32 as uint32_t, bfloat16 as uint16_t
__device__ __forceinline__ float to_f(uint32_t b) { return __uint_as_float(b); }
__device__ __forceinline__ float to_f(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}
template <typename B>
__device__ __forceinline__ B nan_bits();
template <>
__device__ __forceinline__ uint32_t nan_bits<uint32_t>() {
  return 0x7fc00000u;
}
template <>
__device__ __forceinline__ uint16_t nan_bits<uint16_t>() {
  return static_cast<uint16_t>(0x7fc0);
}

__device__ __forceinline__ void unpack(const uint4& u, uint32_t (&v)[4]) {
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void unpack(const uint4& u, uint16_t (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = static_cast<uint16_t>(w[k] & 0xffffu);
    v[2 * k + 1] = static_cast<uint16_t>(w[k] >> 16);
  }
}

// E entries from p: one 16-byte load, or (E == 1) one scalar load
template <typename B, int E>
__device__ __forceinline__ void load(const B* p, B (&v)[E]) {
  if constexpr (E == 1) {
    v[0] = __ldg(p);
  } else {
    static_assert(E * sizeof(B) == 16, "vector loads are 16 bytes");
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
}

// E entries a load (16 / sizeof(B), or 1 on the scalar routes)
template <typename B, int E>
__global__ void __launch_bounds__(kWarps * 32)
aer_encode_kernel(const B* __restrict__ x, const B* __restrict__ tau,
                  int nb, int block, int budget, int* __restrict__ idx,
                  B* __restrict__ val, int* __restrict__ count,
                  int* __restrict__ wanted) {
  constexpr int V = kTile / (32 * E);   // loads (chunks) a lane a tile
  static_assert(V * E == 32, "32 entries a lane a tile");
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  if (row >= nb) return;   // the whole warp: no barrier below spans warps
  const B* xr = x + row * block;
  int* ir = idx + row * budget;
  B* vr = val + row * budget;
  // |x| >= tau && x != 0 is |x| >= t, where a threshold that is not
  // positive (and not NaN) becomes the least subnormal: it then admits
  // every entry but zeros and NaNs, as the rule does
  const float t0 = to_f(__ldg(tau + row));
  const float t = (t0 > 0.0f || t0 != t0) ? t0 : __int_as_float(1);
  const unsigned lt = (1u << lane) - 1u;   // lanes below this one

  int carry = 0;   // entries selected so far (the same in every lane)
  int nf = 0;      // non-finite entries so far (the same in every lane)
  for (int base = 0; base < block; base += kTile) {
    // every load of the tile in flight before any scan
    B v[V][E];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int b0 = base + (c * 32 + lane) * E;
      if (b0 < block) {
        load<B, E>(xr + b0, v[c]);   // a vector route's block % E == 0
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) v[c][j] = 0;   // +0: never selected
      }
    }
    // the tile's non-finite entries first, so that the NaN rule is known
    // as each slot is written
    int bad = 0;
#pragma unroll
    for (int c = 0; c < V; ++c) {
#pragma unroll
      for (int j = 0; j < E; ++j)
        bad += !(fabsf(to_f(v[c][j])) <= 3.40282347e38f);   // inf or NaN
    }
    nf += __reduce_add_sync(kFull, bad);
#pragma unroll
    for (int c = 0; c < V; ++c) {
      // a ballot a plane: the chunk's selected entries below this lane
      // and in all, and this lane's own (bit j)
      int before = 0, total = 0;
      unsigned mine = 0;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const bool sel = fabsf(to_f(v[c][j])) >= t;   // false for NaN
        const unsigned bal = __ballot_sync(kFull, sel);
        before += __popc(bal & lt);
        total += __popc(bal);
        mine |= static_cast<unsigned>(sel) << j;
      }
      int s = carry + before;   // this lane's first slot in the chunk
      carry += total;
      if (!mine || s >= budget) continue;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if ((mine >> j) & 1u) {
          if (s < budget) {
            const B b = v[c][j];
            ir[s] = base + (c * 32 + lane) * E + j;
            vr[s] = nf - !isfinite(to_f(b)) > 0 ? nan_bits<B>() : b;
          }
          ++s;
        }
      }
    }
  }

  const int cnt = carry < budget ? carry : budget;
  if (lane == 0) {
    count[row] = cnt;
    wanted[row] = carry;
  }
  const B fill = nf ? nan_bits<B>() : static_cast<B>(0);
  for (int e = cnt + lane; e < budget; e += 32) {
    ir[e] = -1;
    vr[e] = fill;
  }
  if (nf && block > kTile) {
    // a row of several tiles wrote its earlier slots before the later
    // tiles' non-finite entries were counted: apply the rule again to the
    // warp's own slots (a slot written NaN stays NaN)
    __syncwarp();
    for (int e = lane; e < cnt; e += 32) {
      if (nf - !isfinite(to_f(vr[e])) > 0) vr[e] = nan_bits<B>();
    }
  }
}

Route route_of(const void* x, int block, int is_bf16) {
  const int e = is_bf16 ? 8 : 4;
  const bool vec =
      block % e == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  const bool tiles = block > kTile;
  return vec ? (tiles ? kVectorTiles : kVector)
             : (tiles ? kScalarTiles : kScalar);
}

template <typename B>
const void* kernel_of(Route r) {
  constexpr int e = 16 / sizeof(B);
  return (r == kVector || r == kVectorTiles)
             ? reinterpret_cast<const void*>(aer_encode_kernel<B, e>)
             : reinterpret_cast<const void*>(aer_encode_kernel<B, 1>);
}

int warps_of(int nb) { return nb < kWarps ? nb : kWarps; }

template <typename B>
cudaError_t launch(const void* x, const void* tau, int nb, int block,
                   int budget, int* idx, void* val, int* count, int* wanted,
                   cudaStream_t stream) {
  constexpr int e = 16 / sizeof(B);
  const int warps = warps_of(nb);
  const int grid = (nb + warps - 1) / warps;
  const B* xb = static_cast<const B*>(x);
  const B* tb = static_cast<const B*>(tau);
  B* vb = static_cast<B*>(val);
  const Route r = route_of(x, block, sizeof(B) == 2);
  if (r == kVector || r == kVectorTiles) {
    aer_encode_kernel<B, e><<<grid, warps * 32, 0, stream>>>(
        xb, tb, nb, block, budget, idx, vb, count, wanted);
  } else {
    aer_encode_kernel<B, 1><<<grid, warps * 32, 0, stream>>>(
        xb, tb, nb, block, budget, idx, vb, count, wanted);
  }
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
      is_bf16 ? launch<uint16_t>(x, tau, nb, block, budget, idx, val, count,
                                 wanted, s)
              : launch<uint32_t>(x, tau, nb, block, budget, idx, val,
                                 count, wanted, s);
  return static_cast<int>(err);
}

// The launch a call with these operands takes: out[0] the route (Route
// above), out[1] registers a thread, out[2] static shared memory a block
// (bytes), out[3] dynamic shared memory a block, out[4] threads a block,
// out[5] local memory a thread (bytes; spills).
int aer_encode_plan(const void* x, int nb, int block, int is_bf16,
                    int* out) {
  const Route r = route_of(x, block, is_bf16);
  cudaFuncAttributes a{};
  const cudaError_t err = cudaFuncGetAttributes(
      &a, is_bf16 ? kernel_of<uint16_t>(r) : kernel_of<uint32_t>(r));
  out[0] = r;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = 0;
  out[4] = warps_of(nb > 0 ? nb : 1) * 32;
  out[5] = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(err);
}

const char* aer_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
