// Blockwise quantization kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes: the dynamic 8-bit codec of the low-bit
// optimizers (K8a, K8b) and the symmetric int8/fp8 codec of the pipeline's
// activation stash (K7a, K7b, at the end of this file).
//
// Replaces the TPU kernels in src/repro/kernels/blockwise_quant/kernel.py:
//   blockwise_quantize   <- quantize_pallas          (body _quant_kernel)
//   blockwise_dequantize <- dequantize_pallas        (body _dequant_kernel)
//   stash_quantize       <- stash_quantize_pallas    (body _stash_quant_kernel)
//   stash_dequantize     <- stash_dequantize_pallas  (body _stash_dequant_kernel)
//
// K8a / K8b compute (as the Pallas bodies do), per block of 256 f32 values:
//   scale = max |x|                                  (f32, exact in any order)
//   idx   = #(midpoints <= x / (scale > 0 ? scale : 1))        (uint8)
//   out   = map[idx] * scale                          (f32, one rounding)
// where map is the 256-entry dynamic map (repro_torch/kernels/blockwise_quant/
// ref.py::dynamic_map) and the 255 midpoints are (map[1:] + map[:-1]) / 2,
// both computed on the host in f32 and passed in (K8a's as ref.py::
// search_table lays them out), so the kernel sees the very values the plain
// version searches. For finite inputs the count equals searchsorted(mid, v,
// side="right"), and codes, scales and dequantized values are the plain
// version's bits: the quotient is correctly rounded (below), and nothing else
// is contracted into an FMA.
//
// What bounds K8 on the H100: bytes. K8a reads 4 B and writes 1 B per value
// (plus 4 B per block), K8b the reverse. At 3.35 TB/s that leaves K8a ~0.35
// SM-cycles a value (132 SMs at ~1.75 GHz; H100 80GB HBM3, 700 W), while
// shared memory serves one 32-lane wavefront an SM-cycle. The TPU kernel found
// its index with a (tile, 255) compare-sum and its code with a (tile, 256)
// one-hot select-sum, because the VPU has no gather; here K8a searches and
// K8b looks its code up in shared memory.
//
// K8a's search: design (a) of its redesign, the top levels from registers and
// the rest from a bank-aware table.
// The midpoints are symmetric about 0 but for the top one: mid[126 - m] =
// -mid[127 + m] for m < 127 (f32 rounding is symmetric; search_table checks
// it), and mid[254], between the last code and +1, has no mirror. So only the
// 128 positive midpoints P_m = mid[127 + m] are searched, on the bits of |v|
// (the bits of non-negative floats are ordered as their values):
//   sign bit clear: idx = 127 + #(P_m <= v),   m = 0..127;
//   sign bit set:   idx = 127 - #(P_m < |v|),  m = 0..126, where P_m < |v| is
//                   P_m <= (the bits of |v|) - 1: the float just below |v|,
//                   and -1, below every P_m, for -0 (idx 127, as for +0).
// #(P_m <= w) over m < 127 is a binary search of 7 steps. Its first two
// only ever read 3 midpoints (P_63; P_31, P_95): each thread holds them in
// registers and chooses by compare and select, with no memory access. The
// last five (s = 16, 8, 4, 2, 1) read P_(pos + s - 1), pos a multiple of 2s,
// from shared memory, where search_table puts P_m at m + m / 32. With one
// pad word every 32, a step's 4, 8, 16 and 32 candidates lie in distinct
// banks, and the last step's 64 share banks two by two. So the worst warp
// takes 1 + 1 + 1 + 1 + 2 wavefronts for a value a lane, where the old
// search of the 255 midpoints in order took up to 1 + 2 + 4 + 8 x 5 (every
// candidate of a step from s = 16 on lay in one bank, or 2 to 16). A third
// level in registers (P_15, P_47, P_79, P_111) measured slower: it costs
// three selects a value where a conflict-free table step costs one load.
//
// The division (K8a and K7a): x / safe rounded correctly, with one reciprocal
// a block. Where 2^-64 <= safe <= 2^64 (a warp-uniform branch), r =
// __frcp_rn(safe) once, then per value q0 = x * r, the residual e = x -
// q0 * safe (exact, by FMA) and q = q0 + e * r (Markstein): with r correctly
// rounded and the quotient and e normal, q is the correctly rounded x / safe
// (tests/test_torch_lowbit.py emulates it against IEEE division). Where the
// quotient lies below the first code boundary (|q| < P_0 ~ 2.75e-7 for K8a,
// 0.5 for int8, 2^-10 for fp8), its last bits cannot change a code; at and
// above it, |x| >= 2^-86 and e (about |q| 2^-24 safe) stays normal for safe
// >= 2^-64. The residual is taken as -fma(q0, safe, -x), which equals
// x - q0 * safe and keeps the sign of a zero quotient (fp8's -0 is 0x80).
// Outside that range (a subnormal or tiny absmax would overflow r or leave e
// subnormal and inexact; bf16 absmax up to 3.4e38) every value divides with
// __fdiv_rn.
//
// Layout: one warp per 256-value block; lane l handles values 4l..4l+3 and
// 128+4l..128+4l+3, so each of the warp's loads and stores is one
// contiguous run. Blocks of 8 warps walk the quantization blocks
// with a grid stride, so the table is loaded into shared memory once per
// CUDA block. K8a launches as many CUDA blocks as are resident (4 an SM, at
// most 64 registers a thread) and gives each warp a ring of kStages blocks in
// shared memory, filled by cp.async: a lane copies its own two 16-byte
// vectors of a block and later reads them back, so its next three blocks are
// in flight while it searches one, with no barrier and no registers held for
// them. Any number of quantization blocks; pointers must be 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/mma_sm90.cuh"

namespace {

constexpr int kBlock = 256;            // values per quantization block
constexpr int kThreads = 256;          // 8 warps: 8 quantization blocks at a time
constexpr int kWarps = kThreads / 32;
constexpr long kMaxGrid = 132 * 16;    // 16 blocks per SM of an H100
constexpr int kQuantBlocksPerSM = 4;   // K8a: resident blocks an SM (<= 64 registers)
constexpr int kSearch = 128 + 128 / 32;  // K8a's table: P_m at m + m / 32
constexpr int kStages = 4;             // K8a's ring: a warp's next 3 blocks in flight

// x / safe for the values of one block, correctly rounded (the note above).
template <int N>
__device__ __forceinline__ void quotients(const float (&v)[N], float safe, float (&q)[N]) {
  if (safe >= 0x1p-64f && safe <= 0x1p64f) {
    const float r = __frcp_rn(safe);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float q0 = __fmul_rn(v[j], r);
      const float ne = __fmaf_rn(q0, safe, -v[j]);     // -(x - q0 * safe), exact
      q[j] = __fmaf_rn(-ne, r, q0);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) q[j] = __fdiv_rn(v[j], safe);
  }
}

// Four codes (byte 0 of each word) packed into one word, a in the lowest byte.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ int search_at(int m) { return m + (m >> 5); }

// The midpoints of the search's first two steps, and P_127, as bits.
struct Top {
  int p63, p31, p95, p127;
};

// A 32-bit word of shared memory at a shared-window byte address.
__device__ __forceinline__ int lds_s32(uint32_t addr) {
  int v;
  asm("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// The code of v = x / safe: #(mid <= v) (the note above). The walk keeps the
// table entry's shared-window byte address, so that each step is a load at a
// constant offset, a compare and a predicated add.
__device__ __forceinline__ uint32_t code_of(uint32_t tab, const Top& t, float v) {
  const int bits = __float_as_int(v);
  const int neg = bits >> 31;                     // -1 where the sign bit is set
  const int w = (bits & 0x7fffffff) + neg;        // |v|, or the float just below it
  const bool s64 = w >= t.p63;
  const bool s32 = w >= (s64 ? t.p95 : t.p31);
  // P_pos, pos = 64 s64 + 32 s32, sits at pos + pos / 32, and the steps
  // below stay in pos's 32 (pos + 31 at most)
  const uint32_t pad = tab + (s64 ? 8u : 0u) + (s32 ? 4u : 0u);
  uint32_t a = pad + (s64 ? 256u : 0u) + (s32 ? 128u : 0u);
  if (lds_s32(a + 60) <= w) a += 64;
  if (lds_s32(a + 28) <= w) a += 32;
  if (lds_s32(a + 12) <= w) a += 16;
  if (lds_s32(a + 4) <= w) a += 8;
  if (lds_s32(a) <= w) a += 4;
  int c = (int)(a - pad) >> 2;                    // #(P_m <= w), m < 127
  if (neg == 0 && w >= t.p127) c += 1;
  return (uint32_t)(127 + ((c ^ neg) - neg));     // 127 + c, or 127 - c
}

__global__ void __launch_bounds__(kThreads, kQuantBlocksPerSM)
quantize_kernel(const float* __restrict__ x, const int* __restrict__ search,
                uint8_t* __restrict__ codes, float* __restrict__ scales, long nblocks) {
  __shared__ int tab[kSearch];
  __shared__ float4 ring[kWarps][kStages][kBlock / 4];
  for (int i = threadIdx.x; i < kSearch; i += kThreads) tab[i] = search[i];
  const Top top = {search[search_at(63)], search[search_at(31)], search[search_at(95)],
                   search[search_at(127)]};
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t tab_s = smem_u32(tab);
  float4 (&mine)[kStages][kBlock / 4] = ring[warp];
  const long step = (long)gridDim.x * kWarps;
  long b = (long)blockIdx.x * kWarps + warp;      // the same for every lane of a warp
  // a lane copies, and later reads, its own two 16-byte vectors of a block:
  // no barrier between lanes; one commit group a block, empty past the end
  auto fetch = [&](long blk, int slot) {
    if (blk < nblocks) {
      const float4* src = reinterpret_cast<const float4*>(x + blk * kBlock);
      cp_async16(smem_u32(&mine[slot][lane]), src + lane, 16);
      cp_async16(smem_u32(&mine[slot][32 + lane]), src + 32 + lane, 16);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) fetch(b + k * step, k);
  for (int i = 0; b < nblocks; b += step, ++i) {
    fetch(b + (kStages - 1) * step, (i + kStages - 1) % kStages);
    cp_async_wait<kStages - 1>();                 // this block's group has landed
    __syncwarp();
    const float4 lo = mine[i % kStages][lane];
    const float4 hi = mine[i % kStages][32 + lane];
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
#pragma unroll
    for (int o = 16; o > 0; o /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    float q[8];
    quotients(v, amax > 0.f ? amax : 1.f, q);
    uint32_t c[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] = code_of(tab_s, top, q[j]);
    uint32_t* cb = reinterpret_cast<uint32_t*>(codes + b * kBlock);
    cb[lane] = pack4(c[0], c[1], c[2], c[3]);
    cb[32 + lane] = pack4(c[4], c[5], c[6], c[7]);
    if (lane == 0) scales[b] = amax;
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ scales,
                  const float* __restrict__ map_in, float* __restrict__ out, long nblocks) {
  __shared__ float map[256];
  map[threadIdx.x] = map_in[threadIdx.x];  // kThreads == 256
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (long b = (long)blockIdx.x * kWarps + warp; b < nblocks; b += (long)gridDim.x * kWarps) {
    const float s = scales[b];
    const uchar4* cb = reinterpret_cast<const uchar4*>(codes + b * kBlock);
    const uchar4 clo = cb[lane];
    const uchar4 chi = cb[32 + lane];
    float4* ob = reinterpret_cast<float4*>(out + b * kBlock);
    ob[lane] = make_float4(map[clo.x] * s, map[clo.y] * s, map[clo.z] * s, map[clo.w] * s);
    ob[32 + lane] = make_float4(map[chi.x] * s, map[chi.y] * s, map[chi.z] * s, map[chi.w] * s);
  }
}

int grid_for(long nblocks) {
  const long want = (nblocks + kWarps - 1) / kWarps;
  return (int)(want < kMaxGrid ? want : kMaxGrid);
}

}  // namespace

extern "C" {

// x (nblocks * 256,) f32 -> codes (nblocks * 256,) uint8, scales (nblocks,) f32.
// search: the dynamic map's positive midpoints as ref.py::search_table lays
// them out (f32, read as their bits). Returns cudaGetLastError().
int blockwise_quantize(const float* x, const float* search, uint8_t* codes, float* scales,
                       long long nblocks, cudaStream_t stream) {
  if (nblocks > 0) {
    const int grid = grid_for(nblocks) < 132 * kQuantBlocksPerSM ? grid_for(nblocks)
                                                                 : 132 * kQuantBlocksPerSM;
    quantize_kernel<<<grid, kThreads, 0, stream>>>(
        x, reinterpret_cast<const int*>(search), codes, scales, (long)nblocks);
  }
  return (int)cudaGetLastError();
}

// codes (nblocks * 256,) uint8, scales (nblocks,) f32 -> out (nblocks * 256,) f32.
// map: the 256 f32 codes of the dynamic map. Returns cudaGetLastError().
int blockwise_dequantize(const uint8_t* codes, const float* scales, const float* map,
                         float* out, long long nblocks, cudaStream_t stream) {
  if (nblocks > 0)
    dequantize_kernel<<<grid_for(nblocks), kThreads, 0, stream>>>(codes, scales, map, out,
                                                                  (long)nblocks);
  return (int)cudaGetLastError();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// K7a / K7b: the activation stash's symmetric codec (kernels.paged_attention.
// quant.kv_quantize / kv_dequantize with a row reinterpreted as one flat block
// of 256 values). Per block, as the Pallas bodies compute it in f32:
//   scale = __fdiv_rn(max |x|, cmax)         cmax = 127 (int8) or 448 (fp8)
//   safe  = scale > 0 ? scale : 1
//   code  = rint(clip(x / safe, -cmax, cmax))   int8, half to even
//         = the same value rounded to e4m3 (nearest even, satfinite)   fp8
//   out   = (float)code * scale, one rounding to the output dtype
// Both divisions are correctly rounded whatever the flags (x / safe as K8a's
// note above says), as PyTorch's f32 division is on the CPU and on the card,
// so codes, scales and outputs are the plain version's bits (and through it
// the JAX package's eager codec). Below the first code boundary the
// quotient's last bits cannot matter: int8 rounds |q| < 0.5 to 0, and e4m3's
// smallest subnormal is 2^-9, so |q| < 2^-10 becomes a zero with the sign of
// q, which is the sign of x (q0 = x * r carries it, and the residual's form
// keeps a zero's): fp8's -0 is 0x80. A zero block gets scale 0 and codes 0.
// Inputs are f32 or bf16 (bf16 -> f32 is exact: the bits shifted up),
// outputs f32 or bf16.
//
// What bounds them on the H100: bytes. At the pipeline's slot, 8,388,608 bf16
// values, K7a reads 2 B and writes 1 B per value plus 4 B per block (7.6 us at
// 3.35 TB/s; ~0.21 SM-cycles a value on 132 SMs at ~1.75 GHz, H100 80GB HBM3,
// 700 W); K7b moves the same bytes the other way. The TPU kernel took
// (32, 256) tiles through VMEM. Here K7a gives each block to a half-warp and
// each lane 16 contiguous values (two 16-byte loads of bf16 in flight, four
// of f32), so the absmax is a per-lane max and four shuffles, nothing touches
// shared memory, and a lane's 16 codes are one 16-byte store; lane 0 of the
// half stores the scale. Per value it spends the Markstein quotient (two FMAs
// and a product; one reciprocal a block), a clamp and: for int8, one add of
// 1.5 * 2^23, which rounds |q| <= 127 half to even and leaves the code in the
// low byte of the sum's bits, packed four to a word by PRMT; for fp8, half a
// cvt.rn.satfinite.e4m3x2.f32, which converts a pair. K7b: one warp a block,
// each lane 8 values (a 16-byte vector of bf16, two of f32). Pointers: values
// 16-byte aligned, K7a's codes 16-byte and K7b's 8-byte, scales 4-byte.

namespace {

// Values off .. off+15 as f32 (one lane's run of K7a).
template <bool kBf16>
__device__ __forceinline__ void load16(const void* base, long off, float (&v)[16]) {
  if (kBf16) {
    const uint4* p = reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(base) + off);
    const uint4 u0 = p[0], u1 = p[1];
    const uint32_t w[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(base) + off);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 a = p[k];
      v[4 * k] = a.x; v[4 * k + 1] = a.y; v[4 * k + 2] = a.z; v[4 * k + 3] = a.w;
    }
  }
}

// int8: q + 1.5 * 2^23 is 1.5 * 2^23 + rint(q) for |q| <= 2^22 (half to even),
// so byte 0 of its bits is rint(q) as an int8.
__device__ __forceinline__ uint32_t int8_code(float q) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(q, -127.f), 127.f), 0x1.8p23f));
}

// fp8: two codes, a in the low byte.
__device__ __forceinline__ uint32_t fp8_pair(float a, float b) {
  return (uint32_t)__nv_cvt_float2_to_fp8x2(make_float2(fminf(fmaxf(a, -448.f), 448.f),
                                                        fminf(fmaxf(b, -448.f), 448.f)),
                                            __NV_SATFINITE, __NV_E4M3);
}

template <bool kBf16In, bool kFp8>
__global__ void __launch_bounds__(kThreads)
stash_quantize_kernel(const void* __restrict__ x, uint8_t* __restrict__ codes,
                      float* __restrict__ scales, long nblocks) {
  const float cmax = kFp8 ? 448.f : 127.f;
  const int l = threadIdx.x % 16;                 // lane within the half-warp
  const long step = (long)gridDim.x * kWarps * 2;
  // a warp holds blocks b0 and b0 + 1; both halves run while b0 exists, so
  // the shuffles always see all 32 lanes
  for (long b0 = ((long)blockIdx.x * kWarps + threadIdx.x / 32) * 2; b0 < nblocks; b0 += step) {
    const long b = b0 + (threadIdx.x / 16) % 2;
    const bool valid = b < nblocks;
    float v[16];
    if (valid) {
      load16<kBf16In>(x, b * kBlock + 16 * l, v);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = 0.f;
    }
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) amax = fmaxf(amax, fabsf(v[j]));
#pragma unroll
    for (int o = 8; o > 0; o /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = __fdiv_rn(amax, cmax);
    float q[16];
    quotients(v, scale > 0.f ? scale : 1.f, q);
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (kFp8)
        w[k] = __byte_perm(fp8_pair(q[4 * k], q[4 * k + 1]),
                           fp8_pair(q[4 * k + 2], q[4 * k + 3]), 0x5410);
      else
        w[k] = pack4(int8_code(q[4 * k]), int8_code(q[4 * k + 1]),
                     int8_code(q[4 * k + 2]), int8_code(q[4 * k + 3]));
    }
    if (valid) {
      reinterpret_cast<uint4*>(codes + b * kBlock)[l] = make_uint4(w[0], w[1], w[2], w[3]);
      if (l == 0) scales[b] = scale;
    }
  }
}

template <bool kFp8>
__device__ __forceinline__ float decode(uint32_t byte) {
  if (kFp8)
    return __half2float(__half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)byte, __NV_E4M3)));
  return (float)(int8_t)(uint8_t)byte;
}

template <bool kFp8, bool kBf16Out>
__global__ void __launch_bounds__(kThreads)
stash_dequantize_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ scales,
                        void* __restrict__ out, long nblocks) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (long b = (long)blockIdx.x * kWarps + warp; b < nblocks; b += (long)gridDim.x * kWarps) {
    const float s = scales[b];
    const uint8_t* cb = codes + b * kBlock;
    float v[8];
    if (kBf16Out) {           // the quantize layout of bf16: 8 contiguous values
      const uint2 w = reinterpret_cast<const uint2*>(cb)[lane];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = decode<kFp8>((w.x >> (8 * j)) & 0xffu) * s;
        v[4 + j] = decode<kFp8>((w.y >> (8 * j)) & 0xffu) * s;
      }
      uint32_t h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[j] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j])) |
               ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1])) << 16);
      reinterpret_cast<uint4*>(static_cast<uint16_t*>(out) + b * kBlock)[lane] =
          make_uint4(h[0], h[1], h[2], h[3]);
    } else {                  // the f32 layout: 4 at 4*lane, 4 at 128+4*lane
      const uint32_t lo = reinterpret_cast<const uint32_t*>(cb)[lane];
      const uint32_t hi = reinterpret_cast<const uint32_t*>(cb)[32 + lane];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = decode<kFp8>((lo >> (8 * j)) & 0xffu) * s;
        v[4 + j] = decode<kFp8>((hi >> (8 * j)) & 0xffu) * s;
      }
      float4* ob = reinterpret_cast<float4*>(static_cast<float*>(out) + b * kBlock);
      ob[lane] = make_float4(v[0], v[1], v[2], v[3]);
      ob[32 + lane] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

template <bool kBf16In, bool kFp8>
void launch_quantize(const void* x, void* codes, float* scales, long n, cudaStream_t st) {
  stash_quantize_kernel<kBf16In, kFp8><<<grid_for((n + 1) / 2), kThreads, 0, st>>>(
      x, static_cast<uint8_t*>(codes), scales, n);
}

template <bool kFp8, bool kBf16Out>
void launch_dequantize(const void* codes, const float* scales, void* out, long n,
                       cudaStream_t st) {
  stash_dequantize_kernel<kFp8, kBf16Out><<<grid_for(n), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(codes), scales, out, n);
}

}  // namespace

extern "C" {

// x (nblocks * 256,) f32 or bf16 (in_bf16) -> codes (nblocks * 256,) int8 or
// fp8-e4m3fn (fp8), scales (nblocks,) f32. Returns cudaGetLastError().
int stash_quantize(const void* x, int in_bf16, void* codes, int fp8, float* scales,
                   long long nblocks, cudaStream_t stream) {
  if (nblocks > 0) {
    const long n = (long)nblocks;
    if (in_bf16)
      fp8 ? launch_quantize<true, true>(x, codes, scales, n, stream)
          : launch_quantize<true, false>(x, codes, scales, n, stream);
    else
      fp8 ? launch_quantize<false, true>(x, codes, scales, n, stream)
          : launch_quantize<false, false>(x, codes, scales, n, stream);
  }
  return (int)cudaGetLastError();
}

// codes (nblocks * 256,) int8 or fp8-e4m3fn (fp8), scales (nblocks,) f32 ->
// out (nblocks * 256,) f32 or bf16 (out_bf16). Returns cudaGetLastError().
int stash_dequantize(const void* codes, int fp8, const float* scales, void* out,
                     int out_bf16, long long nblocks, cudaStream_t stream) {
  if (nblocks > 0) {
    const long n = (long)nblocks;
    if (out_bf16)
      fp8 ? launch_dequantize<true, true>(codes, scales, out, n, stream)
          : launch_dequantize<false, true>(codes, scales, out, n, stream);
    else
      fp8 ? launch_dequantize<true, false>(codes, scales, out, n, stream)
          : launch_dequantize<false, false>(codes, scales, out, n, stream);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
