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
// both computed on the host in f32 and passed in, so the kernel sees the very
// values the plain version searches. For finite inputs the count equals
// searchsorted(mid, v, side="right"), and codes, scales and dequantized values
// are the plain version's bits: the division is __fdiv_rn (correctly rounded,
// whatever the flags), and nothing here is contracted into an FMA.
//
// What bounds K8 on the H100: bytes. K8a reads 4 B and writes 1 B per
// element (plus 4 B per block), K8b the reverse; a handful of operations per
// element. The TPU kernel found its index with a (tile, 255) compare-sum and
// its code with a (tile, 256) one-hot select-sum, because the VPU has no
// gather; here each thread binary-searches the midpoints in shared memory
// (8 steps; shared, not constant memory, since the lanes' addresses diverge)
// and dequantization is a shared-memory lookup.
//
// Layout: one warp per 256-value block; lane l handles values 4l..4l+3 and
// 128+4l..128+4l+3, so the warp's float4 loads and uchar4 stores are each one
// contiguous run. Blocks of 8 warps walk the quantization blocks with a grid
// stride, so the table is loaded into shared memory once per CUDA block. Any
// number of quantization blocks; pointers must be 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;            // values per quantization block
constexpr int kThreads = 256;          // 8 warps: 8 quantization blocks at a time
constexpr int kWarps = kThreads / 32;
constexpr int kMid = 255;              // midpoints between the 256 codes
constexpr long kMaxGrid = 132 * 16;    // 16 blocks per SM of an H100

// Number of midpoints <= v (mid sorted ascending): 8 halving steps. The index
// read at step s is at most 255 - s, so it never leaves the 255 entries.
__device__ __forceinline__ uint8_t code_of(const float* mid, float v) {
  int pos = 0;
#pragma unroll
  for (int s = 128; s > 0; s >>= 1)
    if (mid[pos + s - 1] <= v) pos += s;
  return (uint8_t)pos;
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ mid_in,
                uint8_t* __restrict__ codes, float* __restrict__ scales, long nblocks) {
  __shared__ float mid[kMid];
  for (int i = threadIdx.x; i < kMid; i += kThreads) mid[i] = mid_in[i];
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // b is the same for every lane of a warp, so the shuffles below are uniform
  for (long b = (long)blockIdx.x * kWarps + warp; b < nblocks; b += (long)gridDim.x * kWarps) {
    const float4* xb = reinterpret_cast<const float4*>(x + b * kBlock);
    const float4 lo = xb[lane];
    const float4 hi = xb[32 + lane];
    float amax = fmaxf(fmaxf(fmaxf(fabsf(lo.x), fabsf(lo.y)), fmaxf(fabsf(lo.z), fabsf(lo.w))),
                       fmaxf(fmaxf(fabsf(hi.x), fabsf(hi.y)), fmaxf(fabsf(hi.z), fabsf(hi.w))));
#pragma unroll
    for (int o = 16; o > 0; o /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float safe = amax > 0.f ? amax : 1.f;
    uchar4 clo, chi;
    clo.x = code_of(mid, __fdiv_rn(lo.x, safe));
    clo.y = code_of(mid, __fdiv_rn(lo.y, safe));
    clo.z = code_of(mid, __fdiv_rn(lo.z, safe));
    clo.w = code_of(mid, __fdiv_rn(lo.w, safe));
    chi.x = code_of(mid, __fdiv_rn(hi.x, safe));
    chi.y = code_of(mid, __fdiv_rn(hi.y, safe));
    chi.z = code_of(mid, __fdiv_rn(hi.z, safe));
    chi.w = code_of(mid, __fdiv_rn(hi.w, safe));
    uchar4* cb = reinterpret_cast<uchar4*>(codes + b * kBlock);
    cb[lane] = clo;
    cb[32 + lane] = chi;
    if (lane == 0) scales[b] = amax;
  }
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
// mid: the 255 f32 midpoints of the dynamic map. Returns cudaGetLastError().
int blockwise_quantize(const float* x, const float* mid, uint8_t* codes, float* scales,
                       long long nblocks, cudaStream_t stream) {
  if (nblocks > 0)
    quantize_kernel<<<grid_for(nblocks), kThreads, 0, stream>>>(x, mid, codes, scales,
                                                                (long)nblocks);
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
//   code  = rint(clip(__fdiv_rn(x, safe), -cmax, cmax))   int8, half to even
//         = the same value rounded to e4m3 (nearest even, satfinite)   fp8
//   out   = (float)code * scale, one rounding to the output dtype
// Both divisions are correctly rounded whatever the flags, as PyTorch's f32
// division is on the CPU and on the card, so codes, scales and outputs are the
// plain version's bits (and through it the JAX package's eager codec). A zero
// block gets scale 0 and codes 0. Inputs are f32 or bf16 (bf16 -> f32 is
// exact: the bits shifted up), outputs f32 or bf16.
//
// What bounds them on the H100: bytes. At the pipeline's slot, 8,388,608 bf16
// values, K7a reads 2 B and writes 1 B per value plus 4 B per block (7.6 us at
// 3.35 TB/s); K7b moves the same bytes the other way. A handful of operations
// per value. The TPU kernel took (32, 256) tiles through VMEM; here one warp
// owns a block and each lane 8 of its values, loaded as 16-byte vectors (two
// float4 of f32, or one of 8 bf16), so the absmax is a per-lane max and five
// shuffles and nothing touches shared memory. Codes are stored packed (4 or 8
// bytes per lane, contiguous across the warp); lane 0 stores the scale.
// Pointers: values 16-byte aligned, codes 8-byte aligned, scales 4-byte.

namespace {

// Lane `lane`'s k-th 16-byte vector of a block lies at value offset
// (k * 32 + lane) * VEC, VEC = 16 / sizeof(value): 4 for f32 (two vectors a
// lane), 8 for bf16 (one).
template <bool kBf16>
__device__ __forceinline__ void load8(const void* base, long off0, int lane, float v[8]) {
  if (kBf16) {
    const uint4 u = reinterpret_cast<const uint4*>(
        static_cast<const uint16_t*>(base) + off0)[lane];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(base) + off0);
    const float4 a = p[lane];
    const float4 b = p[32 + lane];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

__device__ __forceinline__ uint32_t pack4(const uint8_t* c) {
  return (uint32_t)c[0] | ((uint32_t)c[1] << 8) | ((uint32_t)c[2] << 16) |
         ((uint32_t)c[3] << 24);
}

template <bool kBf16In, bool kFp8>
__global__ void __launch_bounds__(kThreads)
stash_quantize_kernel(const void* __restrict__ x, uint8_t* __restrict__ codes,
                      float* __restrict__ scales, long nblocks) {
  const float cmax = kFp8 ? 448.f : 127.f;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (long b = (long)blockIdx.x * kWarps + warp; b < nblocks; b += (long)gridDim.x * kWarps) {
    float v[8];
    load8<kBf16In>(x, b * kBlock, lane, v);
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
#pragma unroll
    for (int o = 16; o > 0; o /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = __fdiv_rn(amax, cmax);
    const float safe = scale > 0.f ? scale : 1.f;
    uint8_t c[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float q = fminf(fmaxf(__fdiv_rn(v[j], safe), -cmax), cmax);
      if (kFp8)
        c[j] = (uint8_t)__nv_cvt_float_to_fp8(q, __NV_SATFINITE, __NV_E4M3);
      else
        c[j] = (uint8_t)(int8_t)__float2int_rn(q);
    }
    uint8_t* cb = codes + b * kBlock;
    if (kBf16In) {            // values 8*lane .. 8*lane+7
      reinterpret_cast<uint2*>(cb)[lane] = make_uint2(pack4(c), pack4(c + 4));
    } else {                  // values 4*lane .. +3 and 128+4*lane .. +3
      reinterpret_cast<uint32_t*>(cb)[lane] = pack4(c);
      reinterpret_cast<uint32_t*>(cb)[32 + lane] = pack4(c + 4);
    }
    if (lane == 0) scales[b] = scale;
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
  stash_quantize_kernel<kBf16In, kFp8><<<grid_for(n), kThreads, 0, st>>>(
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
