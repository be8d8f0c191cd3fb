// K3: paged (blocked-KV) attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/paged_attention.py:40
// (_paged_kernel, driven by paged_attention_pallas :124).  Computes, for each
// sequence b, the attention of its C chunk queries against its paged KV
// history gathered through block_table:
//
//   q      [B, C, H, D]            (any strides with a unit last stride)
//   pages  [P, page, 2, n_kv, D]   contiguous; [:, :, 0] = K, [:, :, 1] = V
//   block_table [B, max_pages] i32, start_pos [B] i32, chunk_lens [B] i32
//   out    [B, C, H, D]            contiguous
//
//   out[b, c, h] = softmax_k(q·k / sqrt(D), k <= start_pos[b] + c) @ V   for c <  chunk_lens[b]
//   out[b, c, h] = 0                                                     for c >= chunk_lens[b]
//
// Query head h = kv·rep + r reads kv head kv (GQA, rep = H / n_kv); rows are
// taken group-major, row = r·C + c, as in the TPU kernel.  QK and PV
// accumulate in f32; p is rounded to V's dtype before PV, as the TPU kernel
// (:75-77) and the plain version (models/llama_cache.py) do.
//
// Bound.  Decode (C = 1) reads every live KV byte of the batch once and does
// 4·D flops per key and query head — about 2 flops per byte in bf16, far
// below the ~295 the H100 needs to be compute-bound — so decode is bound by
// HBM bandwidth (3.35 TB/s).  A prefill chunk (C = 256) reuses each KV tile
// for up to rep·C query rows and becomes bound by operations.
//
// Design, and what it does about the bound.  The TPU kernel runs a
// sequential (batch, pages) grid carrying the online-softmax state in VMEM
// and keeps a whole [rep·C, D] f32 accumulator per kv head.  Here:
//   * grid (B, n_kv, ceil(rep·C / ROWS)); blocks share nothing, the page loop
//     runs inside the block;
//   * rows are tiled (ROWS = 4 at decode, 16 otherwise), one warp per row or
//     per four rows, with (m, l, acc) for each row in registers: the 1024×128
//     f32 accumulator of a 256-token chunk never has to fit in one block;
//   * the page loop stops at the last key any valid row of the block can see,
//     min(start_pos + c_max, max_pages·page − 1) — never past
//     (start_pos + C − 1) // page — so pages beyond the true length cost no
//     bytes: decode moves O(context), not O(max_pages);
//   * KV tiles of 64 keys (K and V, one kv head) are staged in shared memory
//     by cp.async, double-buffered so the next tile's loads overlap this
//     tile's math; 16-byte loads, rows padded by 16 bytes so that a lane per
//     key reads conflict-free;
//   * rows with c >= chunk_lens[b] are written as zeros by the same pass.
// Scalar f32 math on the CUDA cores: wgmma, TMA and splitting long contexts
// over several blocks (flash-decoding) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeysPerTile = 64;
constexpr int kStages = 2;

template <typename T>
struct VecWidth;  // elements in one 16-byte vector
template <>
struct VecWidth<float> {
  static constexpr int value = 4;
};
template <>
struct VecWidth<__nv_bfloat16> {
  static constexpr int value = 8;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of shared memory as floats
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

// global -> shared, 16 bytes; pred false fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D, int RPW>
constexpr size_t smem_bytes() {
  return sizeof(T) * kStages * 2 * kKeysPerTile * (D + VecWidth<T>::value) +
         sizeof(float) * (kWarps * RPW * D + kWarps * kKeysPerTile);
}

// RPW: query rows per warp; a block owns ROWS = kWarps * RPW consecutive
// group-major rows of one (sequence, kv head).
template <typename T, int D, int RPW>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ pages, const int* __restrict__ block_table,
                           const int* __restrict__ start_pos, const int* __restrict__ chunk_lens,
                           T* __restrict__ out, int C, int H, int n_kv, int page_size, int max_pages, long long q_sb,
                           long long q_sc, long long q_sh, float scale) {
  constexpr int VEC = VecWidth<T>::value;
  constexpr int LD = D + VEC;  // padded shared row: lane j's 16-byte reads of key j hit distinct banks
  constexpr int CHUNKS = D / VEC;
  constexpr int DPL = D / 32;  // output dims per lane
  constexpr int ROWS = kWarps * RPW;
  constexpr int KT = kKeysPerTile;
  constexpr int KPL = KT / 32;  // keys per lane in QK

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kv_s = reinterpret_cast<T*>(smem_raw);                          // [kStages][2][KT][LD]
  float* q_s = reinterpret_cast<float*>(kv_s + kStages * 2 * KT * LD);  // [ROWS][D]
  float* p_s = q_s + ROWS * D;                                       // [kWarps][KT]

  const int b = blockIdx.x;
  const int kv = blockIdx.y;
  const int rep = H / n_kv;
  const int rows_total = rep * C;
  const int row0 = blockIdx.z * ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int start = start_pos[b];
  const int clen = chunk_lens[b];

  // the last key a valid row of this block may see bounds the page loop
  int last_key = -1;
  for (int i = 0; i < ROWS; ++i) {
    const int rg = row0 + i;
    if (rg < rows_total && rg % C < clen) last_key = max(last_key, start + rg % C);
  }
  last_key = min(last_key, max_pages * page_size - 1);
  const int n_keys = last_key + 1;
  const int n_tiles = (n_keys + KT - 1) / KT;

  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int rg = row0 + i / D;
    float val = 0.f;
    if (rg < rows_total) {
      const int h = kv * rep + rg / C;
      val = to_float(q[b * q_sb + (rg % C) * q_sc + h * q_sh + i % D]);
    }
    q_s[i] = val;
  }

  auto load_tile = [&](int tile, int stage) {
    T* k_dst = kv_s + stage * 2 * KT * LD;
    for (int i = threadIdx.x; i < 2 * KT * CHUNKS; i += kThreads) {
      const int which = i / (KT * CHUNKS);  // 0 = K, 1 = V
      const int j = (i / CHUNKS) % KT;
      const int ch = i % CHUNKS;
      const int key = tile * KT + j;
      const bool ok = key < n_keys;
      const T* src = pages;
      if (ok) {
        const long long page = block_table[(long long)b * max_pages + key / page_size];
        const long long slot = key % page_size;
        src = pages + (((page * page_size + slot) * 2 + which) * n_kv + kv) * D + ch * VEC;
      }
      cp_async16(k_dst + (which * KT + j) * LD + ch * VEC, src, ok);
    }
    cp_async_commit();
  };

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;
  }

  if (n_tiles > 0) load_tile(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(t + 1, (t + 1) % kStages);
    } else {
      cp_async_commit();  // empty group keeps wait_group<1> meaning "tile t landed"
    }
    cp_async_wait<1>();
    __syncthreads();

    const T* k_s = kv_s + (t % kStages) * 2 * KT * LD;
    const T* v_s = k_s + KT * LD;
    float* p_w = p_s + warp * KT;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int lr = warp * RPW + i;
      const int rg = row0 + lr;
      if (rg >= rows_total || rg % C >= clen) continue;  // warp-uniform
      const int qpos = start + rg % C;
      const int first_key = t * KT;
      if (first_key > qpos) continue;  // whole tile in this row's future
      const float* qr = q_s + lr * D;

      float s[KPL];
      float tmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        const int j = u * 32 + lane;
        const T* kr = k_s + j * LD;
        float dot = 0.f;
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) {
          float kf[VEC];
          load_vec(kr + ch * VEC, kf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qr[ch * VEC + e], kf[e], dot);
        }
        s[u] = (first_key + j <= qpos) ? dot * scale : -INFINITY;
        tmax = fmaxf(tmax, s[u]);
      }
      tmax = warp_max(tmax);
      const float m_new = fmaxf(m[i], tmax);  // finite: key first_key <= qpos is visible
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        const float p = expf(s[u] - m_new);
        psum += p;
        p_w[u * 32 + lane] = to_float(from_float<T>(p));  // p in V's dtype before PV
      }
      psum = warp_sum(psum);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
      __syncwarp();
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] *= alpha;
      const int j_end = min(KT, qpos - first_key + 1);
      for (int j = 0; j < j_end; ++j) {
        const float p = p_w[j];
        const T* vr = v_s + j * LD + lane * DPL;
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = fmaf(p, to_float(vr[dd]), acc[i][dd]);
      }
      __syncwarp();
    }
    __syncthreads();  // stage t % kStages is refilled by the next iteration's load
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int rg = row0 + warp * RPW + i;
    if (rg >= rows_total) continue;
    const int c = rg % C;
    const int h = kv * rep + rg / C;
    T* o = out + (((long long)b * C + c) * H + h) * D + lane * DPL;
    const bool valid = c < clen;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) o[dd] = from_float<T>(valid ? acc[i][dd] / denom : 0.f);
  }
}

template <typename T, int D, int RPW>
cudaError_t launch(const void* q, const void* pages, const int* block_table, const int* start_pos,
                   const int* chunk_lens, void* out, int B, int C, int H, int n_kv, int page_size, int max_pages,
                   long long q_sb, long long q_sc, long long q_sh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D, RPW>();
  auto kernel = paged_attention_kernel<T, D, RPW>;
  // the shared-memory opt-in is a per-device attribute of each
  // instantiation: set it on a device's first launch only
  static std::atomic<bool> smem_opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_opted_in[dev].store(true, std::memory_order_release);
  }
  constexpr int rows_per_block = kWarps * RPW;
  const int row_blocks = ((H / n_kv) * C + rows_per_block - 1) / rows_per_block;
  const dim3 grid(B, n_kv, row_blocks);
  const float scale = (float)(1.0 / sqrt((double)D));
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(pages), block_table,
                                           start_pos, chunk_lens, static_cast<T*>(out), C, H, n_kv, page_size,
                                           max_pages, q_sb, q_sc, q_sh, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_rows(const void* q, const void* pages, const int* block_table, const int* start_pos,
                        const int* chunk_lens, void* out, int B, int C, int H, int n_kv, int page_size,
                        int max_pages, long long q_sb, long long q_sc, long long q_sh, cudaStream_t stream) {
  // decode (rep·C <= 4 rows): one row per warp; otherwise four rows per
  // warp so each staged KV tile serves 16 query rows
  if ((H / n_kv) * C <= kWarps)
    return launch<T, D, 1>(q, pages, block_table, start_pos, chunk_lens, out, B, C, H, n_kv, page_size, max_pages,
                           q_sb, q_sc, q_sh, stream);
  return launch<T, D, 4>(q, pages, block_table, start_pos, chunk_lens, out, B, C, H, n_kv, page_size, max_pages,
                         q_sb, q_sc, q_sh, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides of q are in elements.  Returns
// the cudaError_t of the launch (0 on success); shapes are checked by the
// Python wrapper (deepspeed_tpu_torch/ops/paged_attention.py).
int ds_paged_attention(const void* q, const void* pages, const int* block_table, const int* start_pos,
                       const int* chunk_lens, void* out, int B, int C, int H, int n_kv, int D, int page_size,
                       int max_pages, long long q_sb, long long q_sc, long long q_sh, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128)
    return launch_rows<__nv_bfloat16, 128>(q, pages, block_table, start_pos, chunk_lens, out, B, C, H, n_kv,
                                           page_size, max_pages, q_sb, q_sc, q_sh, s);
  if (dtype == 1 && D == 64)
    return launch_rows<__nv_bfloat16, 64>(q, pages, block_table, start_pos, chunk_lens, out, B, C, H, n_kv,
                                          page_size, max_pages, q_sb, q_sc, q_sh, s);
  if (dtype == 0 && D == 128)
    return launch_rows<float, 128>(q, pages, block_table, start_pos, chunk_lens, out, B, C, H, n_kv, page_size,
                                   max_pages, q_sb, q_sc, q_sh, s);
  if (dtype == 0 && D == 64)
    return launch_rows<float, 64>(q, pages, block_table, start_pos, chunk_lens, out, B, C, H, n_kv, page_size,
                                  max_pages, q_sb, q_sc, q_sh, s);
  return (int)cudaErrorInvalidValue;
}

const char* ds_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
