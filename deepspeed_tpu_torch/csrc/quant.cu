// K4a, K4b, K5a, K5b: block int8 / int4 quantization for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/quant_kernels.py:
//   K4a q8_kernel   <- _q8_kernel  (:31, quantize_int8_pallas :74)
//   K4b dq8_kernel  <- _dq8_kernel (:39, dequantize_int8_pallas :103)
//   K5a q4_kernel   <- _q4_kernel  (:44, quantize_int4_pallas :126)
//   K5b dq4_kernel  <- _dq4_kernel (:56, dequantize_int4_pallas :154)
// They carry the ZeRO++ quantized gradient wire (qgZ): every gradient tensor
// is quantized before the all-to-all and the all-gather and dequantized
// after each (deepspeed_tpu/runtime/comm/compressed.py:64-159).
//
// What they compute, per block of `block` elements (x viewed as
// [nblocks, block], f32 or bf16):
//   scale = absmax == 0 ? 1 : absmax / qmax                (qmax 127 or 7)
//   code  = clamp(rint(x / scale), -qmax, qmax)
//   int8: q[i] = code[i]                       -> int8  [nblocks, block]
//   int4: q[i] = (code[i] + 8) | (code[i + block/2] + 8) << 4
//                                              -> uint8 [nblocks, block/2]
//   dequant: out[i] = float(code[i]) * scale   -> f32   [nblocks, block]
// The int4 packing is the halves layout of the JAX package
// (deepspeed_tpu/ops/quantizer.py:48-53), not an interleave.
//
// Bit-exact to the plain versions (deepspeed_tpu_torch/ops/quantizer.py),
// which are bit-exact to the JAX package's functions evaluated op by op:
// both divisions are __fdiv_rn (a correctly rounded divide, never a product
// with the reciprocal), rounding is rintf (half to even, as torch.round and
// jnp.round), and the source is built without --use_fast_math
// (ops/op_builder/builder.py NVCC_FLAGS).
//
// Bound.  Each kernel reads every input byte once and writes every output
// byte once, with a handful of operations per element: memory-bound on any
// card.  For the largest tensor of Llama-125M (the embedding, n = 24,576,000
// in f32) at 3.35 TB/s: K4a reads 4n and writes n + 4n/256 bytes (123.3 MB,
// 36.8 us), K4b the reverse, K5a writes n/2 + 4n/256 (111.0 MB, 33.1 us),
// K5b the reverse.
//
// Design.  The TPU kernels take 256 blocks per grid step through VMEM and
// emit lane-broadcast scales; the Pallas wrappers fall back to jnp when
// nblocks is not a multiple of 256.  Here:
//   * quantize: one warp per block, 8 warps per CTA, grid over nblocks with
//     a masked tail, nothing carried across CTAs.  Lane l holds elements
//     l, l+32, l+64, ... in registers (one coalesced 128-byte load per step
//     for f32), takes its |max|, and a 5-step __shfl_xor_sync max gives the
//     block's absmax to every lane; each lane then writes its codes (a
//     coalesced 32-byte store per step) and lane 0 the scale.  For int4,
//     the warp writes its block's codes to shared memory (1 KB per warp) and
//     lane l packs the bytes l, l+32, ...: code i in the low nibble, code
//     i + block/2 (held by another lane) in the high one.
//   * dequantize: the same grid, one warp per block; lane l writes outputs
//     l, l+32, ... (a coalesced 128-byte store per step) from its codes and
//     the block's scale, read once per lane.
// block <= 1024 (32 values per lane) and any nblocks.  Vector (16-byte)
// loads and stores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerCta = 8;
constexpr int kMaxBlock = 1024;
constexpr int kMaxPerLane = kMaxBlock / 32;

__device__ __forceinline__ float load_f32(const float* x, long long i) { return x[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* x, long long i) { return __bfloat162float(x[i]); }

// The block's values in registers (lane l holds element l + 32 j in v[j])
// and its scale, the same on every lane.
template <typename T>
__device__ __forceinline__ float load_block(const T* xb, int block, float qmax, float (&v)[kMaxPerLane]) {
  const int lane = threadIdx.x & 31;
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < block ? load_f32(xb, i) : 0.f;
    amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  return amax == 0.f ? 1.f : __fdiv_rn(amax, qmax);
}

__device__ __forceinline__ float code(float x, float scale, float qmax) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -qmax), qmax);
}

template <typename T>
__global__ void q8_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
                          long long nblocks, int block) {
  const long long b = (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (b >= nblocks) return;   // a whole warp leaves together: the shuffles below see full warps
  const int lane = threadIdx.x & 31;
  float v[kMaxPerLane];
  const float scale = load_block(x + b * block, block, 127.f, v);
  int8_t* qb = q + b * block;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int i = lane + 32 * j;
    if (i < block) qb[i] = (int8_t)code(v[j], scale, 127.f);
  }
  if (lane == 0) scales[b] = scale;
}

template <typename T>
__global__ void q4_kernel(const T* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ scales,
                          long long nblocks, int block) {
  const long long b = (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (b >= nblocks) return;
  const int lane = threadIdx.x & 31;
  float v[kMaxPerLane];
  const float scale = load_block(x + b * block, block, 7.f, v);
  // the codes (+8) of the warp's block, so that a lane can pack element i
  // with element i + block/2, which another lane holds
  __shared__ uint8_t codes[kWarpsPerCta][kMaxBlock];
  uint8_t* cw = codes[threadIdx.x >> 5];
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int i = lane + 32 * j;
    if (i < block) cw[i] = (uint8_t)((int)code(v[j], scale, 7.f) + 8);
  }
  __syncwarp();
  const int half = block >> 1;
  uint8_t* qb = q + b * half;
  for (int i = lane; i < half; i += 32) qb[i] = (uint8_t)(cw[i] | (cw[i + half] << 4));
  if (lane == 0) scales[b] = scale;
}

__global__ void dq8_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales, float* __restrict__ out,
                           long long nblocks, int block) {
  const long long b = (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (b >= nblocks) return;
  const float s = scales[b];
  const int8_t* qb = q + b * block;
  float* ob = out + b * block;
  for (int i = threadIdx.x & 31; i < block; i += 32) ob[i] = (float)qb[i] * s;
}

__global__ void dq4_kernel(const uint8_t* __restrict__ q, const float* __restrict__ scales, float* __restrict__ out,
                           long long nblocks, int block) {
  const long long b = (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (b >= nblocks) return;
  const float s = scales[b];
  const int half = block >> 1;
  const uint8_t* qb = q + b * half;
  float* ob = out + b * block;
  for (int i = threadIdx.x & 31; i < block; i += 32) {
    const int c = (i < half ? (qb[i] & 0xF) : (qb[i - half] >> 4)) - 8;
    ob[i] = (float)c * s;
  }
}

int grid_for(long long nblocks) { return (int)((nblocks + kWarpsPerCta - 1) / kWarpsPerCta); }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Each function returns the cudaError_t
// of its launch (0 on success).  The Python wrappers
// (deepspeed_tpu_torch/ops/quant_kernels.py) check devices, dtypes, shapes,
// contiguity, block <= 1024 and an even int4 block before calling.
int ds_quant_q8(const void* x, int dtype, void* q, void* scales, long long nblocks, int block, void* stream) {
  if (nblocks <= 0 || block <= 0 || block > kMaxBlock) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(grid_for(nblocks)), threads(kWarpsPerCta * 32);
  if (dtype == 0)
    q8_kernel<float><<<grid, threads, 0, s>>>(static_cast<const float*>(x), static_cast<int8_t*>(q),
                                              static_cast<float*>(scales), nblocks, block);
  else if (dtype == 1)
    q8_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                      static_cast<int8_t*>(q), static_cast<float*>(scales),
                                                      nblocks, block);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int ds_quant_q4(const void* x, int dtype, void* q, void* scales, long long nblocks, int block, void* stream) {
  if (nblocks <= 0 || block <= 0 || block > kMaxBlock || block % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(grid_for(nblocks)), threads(kWarpsPerCta * 32);
  if (dtype == 0)
    q4_kernel<float><<<grid, threads, 0, s>>>(static_cast<const float*>(x), static_cast<uint8_t*>(q),
                                              static_cast<float*>(scales), nblocks, block);
  else if (dtype == 1)
    q4_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                      static_cast<uint8_t*>(q), static_cast<float*>(scales),
                                                      nblocks, block);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int ds_quant_dq8(const void* q, const void* scales, void* out, long long nblocks, int block, void* stream) {
  if (nblocks <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  dq8_kernel<<<grid_for(nblocks), kWarpsPerCta * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales), static_cast<float*>(out), nblocks, block);
  return (int)cudaGetLastError();
}

int ds_quant_dq4(const void* q, const void* scales, void* out, long long nblocks, int block, void* stream) {
  if (nblocks <= 0 || block <= 0 || block % 2) return (int)cudaErrorInvalidValue;
  dq4_kernel<<<grid_for(nblocks), kWarpsPerCta * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(scales), static_cast<float*>(out), nblocks, block);
  return (int)cudaGetLastError();
}

const char* ds_quant_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
