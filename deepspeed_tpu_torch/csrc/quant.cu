// K4a, K4b, K5a, K5b: block int8 / int4 quantization for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/quant_kernels.py:
//   K4a q8_kernel_256 / q8_kernel_any   <- _q8_kernel  (:31, quantize_int8_pallas :74)
//   K4b dq8_kernel_256 / dq8_kernel_any <- _dq8_kernel (:39, dequantize_int8_pallas :103)
//   K5a q4_kernel                       <- _q4_kernel  (:44, quantize_int4_pallas :126)
//   K5b dq4_kernel                      <- _dq4_kernel (:56, dequantize_int4_pallas :154)
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
// Grouped int8 (K4a, K4b).  One launch covers every tensor of a training
// step.  A segment table (ops/quant_kernels.py SegmentTable) gives, per
// tensor t, its element count n_t, its first element x_off_t in the flat
// tensor-order buffer (the tensors back to back, unpadded), its blocks per
// rank chunk c_t (its count padded to world·block, over world·block) and its
// first block off_t inside a chunk (the sum of the c_u before it); C is the
// sum of all c_t.  The code buffer is rank-major: block b of tensor t sits at
// row (b / c_t)·C + off_t + b % c_t, so chunk d (rows d·C ..) is what rank d
// receives and the whole buffer is one all_to_all_single; the all-gathered
// shards come back in the same layout.  Elements past n_t are the padding:
// K4a reads them as zeros, K4b writes nothing there.  A single tensor is the
// identity layout: one segment, world 1 (passed by value, no table).
//   * K4a maps each code row to its tensor, reads that block of x and
//     writes its codes and scale: every row is written, the padding's too.
//   * K4b maps each code row the same way and writes the values to the
//     tensor-order buffer, cut at n_t, optionally rounded through bfloat16
//     (what `.to(torch.bfloat16).float()` gives) where the wire's input was
//     bf16.
//   * The grid's y is the rank chunk d, its x the rows of a chunk; a row's
//     tensor is one load from the table's per-row segment index, so there is
//     no search and no 64-bit division per row.
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
// nblocks is not a multiple of 256.  Here, at block 256 (the wire's):
//   * one warp holds a block, 8 elements a lane, so that each warp load or
//     store instruction covers one contiguous span: f32 elements 4l..4l+3 and
//     128+4l..128+4l+3 (two 16-byte loads, 512 contiguous bytes a warp
//     instruction), bf16 elements 8l..8l+7 (one 16-byte load).  A 5-step
//     __shfl_xor_sync gives the block's absmax to every lane; each lane
//     stores its 8 codes in one 8-byte (bf16) or two 4-byte (f32) stores.
//     K4b reads codes 4l.. and 128+4l.. (two 4-byte loads) and writes their
//     values with two 16-byte stores.  (Eight contiguous f32 a lane, 32 bytes
//     apart from lane to lane, made each 16-byte instruction cover 1 KB at
//     half density, and K4b ran slower than the scalar kernel it replaced.)
//   * one row a warp: the 64 warps of an SM hold 16-64 KB of loads in flight,
//     which is enough.  Warps that took 2 or 4 rows, every load issued before
//     the first reduction, measured slower on the card at every shape of
//     the step (fewer CTAs, a longer last wave).
//   * where a block's start is not 16-byte aligned (a tensor's x_off_t after
//     an odd cut) or the block runs past n_t, the lanes take their elements
//     one by one; K4b codes that do not start on a 4-byte boundary take
//     dq8_kernel_any.
// Other blocks up to 1024 take q8_kernel_any / dq8_kernel_any: lane l holds
// elements l, l + 32, ... (one coalesced access per step), the same grouped
// layout.  No path hands the work to the plain version.
// K5a/K5b (int4, one tensor a launch): one warp per block, lane l holds
// elements l, l+32, ...; for K5a the warp writes its block's codes to shared
// memory (1 KB per warp) and lane l packs the bytes l, l+32, ...: code i in
// the low nibble, code i + block/2 (held by another lane) in the high one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerCta = 8;
constexpr int kMaxBlock = 1024;
constexpr int kMaxPerLane = kMaxBlock / 32;

__device__ __forceinline__ float load_f32(const float* x, long long i) { return x[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* x, long long i) { return __bfloat162float(x[i]); }

__device__ __forceinline__ float code(float x, float scale, float qmax) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -qmax), qmax);
}

__device__ __forceinline__ float warp_absmax_scale(float amax, float qmax) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  return amax == 0.f ? 1.f : __fdiv_rn(amax, qmax);
}

// ------------------------------------------------------------------ layout

// The grouped layout: `table` holds the segment records {n, x_off, c, off}
// (int64, on the device) and `row_seg` the segment of each row of a chunk
// (int32, chunk entries), or both are null for the identity layout of one
// tensor of n0 elements.  Code rows: world·chunk; chunk d is blockIdx.y.
struct Layout {
  const long long* table;
  const int* row_seg;
  long long n0;
  long long chunk;
};

// Row r of chunk d → its tensor's first element in the flat buffer (`elem`)
// and how many of its `block` elements lie inside the tensor (`valid`, 0 for
// a row of padding).
__device__ __forceinline__ void locate(const Layout& L, long long d, long long r, int block, long long& elem,
                                       int& valid) {
  long long n = L.n0, x_off = 0, c = L.chunk, off = 0;
  if (L.table != nullptr) {
    const long long* rec = L.table + 4 * __ldg(L.row_seg + r);
    n = __ldg(rec);
    x_off = __ldg(rec + 1);
    c = __ldg(rec + 2);
    off = __ldg(rec + 3);
  }
  const long long first = (d * c + (r - off)) * block;   // the row's first element inside its tensor
  elem = x_off + first;
  const long long left = n - first;
  valid = left <= 0 ? 0 : (left >= block ? block : (int)left);
}

__device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Which 8 of a 256-block's elements lane l holds, so that every load or store
// instruction of the warp covers one contiguous span: for 4-byte values
// elements 4l..4l+3 and 128+4l..128+4l+3 (two 16-byte accesses, each warp
// instruction 512 contiguous bytes); for bf16 elements 8l..8l+7 (one
// 16-byte load).
template <int PER_ACCESS>
__device__ __forceinline__ int lane_elem(int lane, int k) {
  return PER_ACCESS == 4 ? (k < 4 ? 4 * lane + k : 128 + 4 * lane + k - 4) : 8 * lane + k;
}

// Lane `lane`'s 8 elements of a block starting at src, of which the first
// `valid` exist (zeros past them).
__device__ __forceinline__ void load8(const float* src, int lane, int valid, float (&v)[8]) {
  if (aligned16(src) && valid == 256) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src) + lane);
    const float4 b = __ldg(reinterpret_cast<const float4*>(src + 128) + lane);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = lane_elem<4>(lane, k);
      v[k] = e < valid ? src[e] : 0.f;
    }
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, int lane, int valid, float (&v)[8]) {
  if (aligned16(src) && valid == 256) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + lane);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {   // little-endian: element 2k in the low half
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = lane_elem<8>(lane, k);
      v[k] = e < valid ? __bfloat162float(src[e]) : 0.f;
    }
  }
}

__device__ __forceinline__ float through_bf16(float v, bool round) {
  return round ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ uint32_t pack4(const float (&v)[8], int k0, float scale) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) w |= ((uint32_t)(int)code(v[k0 + i], scale, 127.f) & 0xffu) << (8 * i);
  return w;
}

// ------------------------------------------------------------------ K4a

// Grid (chunk rows / 8, world); 8 warps a CTA, one row a warp.
template <typename T>
__global__ void q8_kernel_256(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
                              Layout L) {
  const int lane = threadIdx.x & 31;
  const long long d = blockIdx.y;
  const long long r = (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (r >= L.chunk) return;   // a whole warp leaves together: the shuffles below see full warps
  long long elem;
  int valid;
  locate(L, d, r, 256, elem, valid);
  float v[8];
  load8(x + elem, lane, valid, v);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
  const float scale = warp_absmax_scale(amax, 127.f);
  const long long row = d * L.chunk + r;
  int8_t* qr = q + row * 256;
  if (sizeof(T) == 4) {   // codes 4l.. and 128+4l..: two 4-byte stores, 128 contiguous bytes a warp instruction
    reinterpret_cast<uint32_t*>(qr)[lane] = pack4(v, 0, scale);
    reinterpret_cast<uint32_t*>(qr + 128)[lane] = pack4(v, 4, scale);
  } else {                // codes 8l..8l+7: one 8-byte store
    reinterpret_cast<uint2*>(qr)[lane] = make_uint2(pack4(v, 0, scale), pack4(v, 4, scale));
  }
  if (lane == 0) scales[row] = scale;
}

// Any block up to 1024: one warp a row, lane l holds elements l, l+32, ...
template <typename T>
__global__ void q8_kernel_any(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
                              Layout L, int block) {
  const long long d = blockIdx.y;
  const long long r = (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (r >= L.chunk) return;
  const int lane = threadIdx.x & 31;
  long long elem;
  int valid;
  locate(L, d, r, block, elem, valid);
  float v[kMaxPerLane];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < valid ? load_f32(x, elem + i) : 0.f;
    amax = fmaxf(amax, fabsf(v[j]));
  }
  const float scale = warp_absmax_scale(amax, 127.f);
  const long long row = d * L.chunk + r;
  int8_t* qb = q + row * block;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int i = lane + 32 * j;
    if (i < block) qb[i] = (int8_t)code(v[j], scale, 127.f);
  }
  if (lane == 0) scales[row] = scale;
}

// ------------------------------------------------------------------ K4b

// Grid as K4a's.  Lane l reads codes 4l.. and 128+4l.. (two 4-byte loads)
// and writes their values with two 16-byte stores: each warp instruction
// covers 512 contiguous bytes of output.
__global__ void dq8_kernel_256(const int8_t* __restrict__ q, const float* __restrict__ scales,
                               float* __restrict__ out, Layout L, bool round_bf16) {
  const int lane = threadIdx.x & 31;
  const long long d = blockIdx.y;
  const long long r = (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (r >= L.chunk) return;
  long long elem;
  int valid;
  locate(L, d, r, 256, elem, valid);
  if (valid == 0) return;   // a row of padding: nothing to write
  const long long row = d * L.chunk + r;
  const int8_t* qr = q + row * 256;
  const uint32_t codes[2] = {__ldg(reinterpret_cast<const uint32_t*>(qr) + lane),
                             __ldg(reinterpret_cast<const uint32_t*>(qr + 128) + lane)};
  const float s = __ldg(scales + row);
  float f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = (int)(int8_t)((codes[i >> 2] >> (8 * (i & 3))) & 0xffu);
    f[i] = through_bf16((float)c * s, round_bf16);
  }
  float* dst = out + elem;
  if (aligned16(dst) && valid == 256) {
    reinterpret_cast<float4*>(dst)[lane] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(dst + 128)[lane] = make_float4(f[4], f[5], f[6], f[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = lane_elem<4>(lane, i);
      if (e < valid) dst[e] = f[i];
    }
  }
}

__global__ void dq8_kernel_any(const int8_t* __restrict__ q, const float* __restrict__ scales,
                               float* __restrict__ out, Layout L, int block, bool round_bf16) {
  const long long d = blockIdx.y;
  const long long r = (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (r >= L.chunk) return;
  long long elem;
  int valid;
  locate(L, d, r, block, elem, valid);
  const long long row = d * L.chunk + r;
  const float s = scales[row];
  const int8_t* qb = q + row * block;
  for (int i = threadIdx.x & 31; i < valid; i += 32) out[elem + i] = through_bf16((float)qb[i] * s, round_bf16);
}

// ------------------------------------------------------------------ K5a, K5b

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
  return warp_absmax_scale(amax, qmax);
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

int grid_for(long long warps) { return (int)((warps + kWarpsPerCta - 1) / kWarpsPerCta); }

bool layout_ok(const void* table, const void* row_seg, long long n0, long long chunk, long long rows, int block) {
  if (rows <= 0 || chunk <= 0 || rows % chunk || rows / chunk > 65535 || block <= 0 || block > kMaxBlock)
    return false;
  return table != nullptr ? row_seg != nullptr : n0 > 0;
}

// (one warp a row of a chunk, one grid row per rank chunk)
dim3 grouped_grid(long long chunk, long long rows) { return dim3(grid_for(chunk), (unsigned)(rows / chunk)); }

}  // namespace

extern "C" {

// The grouped int8 pair.  `table` is a device pointer to the segment records
// {n, x_off, c, off} (int64) and `row_seg` to each chunk row's segment
// (int32), or both are null for one tensor of n0 elements in the identity
// layout.  rows = world·chunk code rows.  dtype: 0 = float32,
// 1 = bfloat16.  Each function returns the cudaError_t of its launch (0 on
// success).  The Python wrappers (deepspeed_tpu_torch/ops/quant_kernels.py)
// check devices, dtypes, shapes, contiguity, the table and block <= 1024
// before calling.
int ds_quant_q8(const void* x, int dtype, void* q, void* scales, const void* table, const void* row_seg,
                long long n0, long long chunk, long long rows, int block, void* stream) {
  if (!layout_ok(table, row_seg, n0, chunk, rows, block) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Layout L{static_cast<const long long*>(table), static_cast<const int*>(row_seg), n0, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scales);
  const int threads = kWarpsPerCta * 32;
  const float* xf = static_cast<const float*>(x);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const dim3 grid = grouped_grid(chunk, rows);
  if (block == 256) {
    if (dtype == 0) q8_kernel_256<float><<<grid, threads, 0, s>>>(xf, qo, so, L);
    else q8_kernel_256<__nv_bfloat16><<<grid, threads, 0, s>>>(xb, qo, so, L);
  } else {
    if (dtype == 0) q8_kernel_any<float><<<grid, threads, 0, s>>>(xf, qo, so, L, block);
    else q8_kernel_any<__nv_bfloat16><<<grid, threads, 0, s>>>(xb, qo, so, L, block);
  }
  return (int)cudaGetLastError();
}

// round_bf16: write each value as bfloat16 would hold it (then widened).
int ds_quant_dq8(const void* q, const void* scales, void* out, const void* table, const void* row_seg,
                 long long n0, long long chunk, long long rows, int block, int round_bf16, void* stream) {
  if (!layout_ok(table, row_seg, n0, chunk, rows, block)) return (int)cudaErrorInvalidValue;
  const Layout L{static_cast<const long long*>(table), static_cast<const int*>(row_seg), n0, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* si = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  const int threads = kWarpsPerCta * 32;
  // the 256 path reads the codes as 4-byte words: codes that start off a
  // 4-byte boundary (a view at an odd storage offset) take the generic kernel
  if (block == 256 && (reinterpret_cast<uintptr_t>(q) & 3) == 0)
    dq8_kernel_256<<<grouped_grid(chunk, rows), threads, 0, s>>>(qi, si, o, L, round_bf16 != 0);
  else
    dq8_kernel_any<<<grouped_grid(chunk, rows), threads, 0, s>>>(qi, si, o, L, block, round_bf16 != 0);
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

int ds_quant_dq4(const void* q, const void* scales, void* out, long long nblocks, int block, void* stream) {
  if (nblocks <= 0 || block <= 0 || block % 2) return (int)cudaErrorInvalidValue;
  dq4_kernel<<<grid_for(nblocks), kWarpsPerCta * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(scales), static_cast<float*>(out), nblocks, block);
  return (int)cudaGetLastError();
}

const char* ds_quant_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
