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
// Two masked variants, compile-time (VAR), so the full-attention route is
// the code it was: a sliding window (Mistral; key k visible when qpos −
// window < k <= qpos, and the page loop starts at the first tile that holds
// a visible key, so a windowed decode reads O(window) keys), and alibi
// (Falcon-RW: slopes[h]·k·scale added to the scaled logits before the
// online max, as the plain version does).  Head dims 64, 80, 96 and 128:
// multiples of 16, so the k16 steps of Q·Kᵀ and the n8 blocks of P·V divide
// them and a row is a whole number of 16-byte chunks.
//
// Query head h = kv·rep + r reads kv head kv (GQA, rep = H / n_kv).  QK and PV
// accumulate in f32; p is rounded to V's dtype before PV, with the softmax
// denominator l summed over the unrounded f32 p, as the TPU kernel (:75-77)
// and the plain version (models/llama_cache.py) do.
//
// Bound (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16).  Decode (C = 1) reads every
// live KV byte once and does 4·D flops per key and query head, ~2 flops per
// byte: bytes-bound.  At the smoke run's cases (chip_smoke.py phase 2,
// Llama-3-8B: H 32, n_kv 8, D 128, page 16): decode 16 sequences of 1-2000
// keys 0.01841 ms (bytes), a prefill chunk of 4 × 256 rows 0.0114 ms
// (operations), a mixed SplitFuse step 0.01065 ms (bytes).
//
// Design, bf16 (D 64, 80, 96, 128): paged_attention_tc_kernel.
//   * Row tiles, position-major inside a kv group.  A CTA of 4 warps owns
//     ROWS query rows of one (sequence, kv head); row i is chunk position
//     c0 + i / rep, head kv·rep + i % rep.  A 64-row tile spans 64 / rep
//     consecutive positions, so its causal edge is at most one key tile wide,
//     and a decode row's rep heads share one tile.  Tiles with no valid row
//     write their zeros (or empty partials) and exit.  The grid runs the last
//     row tiles (the most keys) first, so the longest CTAs do not start in
//     the tail.
//   * Q·Kᵀ and P·V on the tensor cores, mma.sync.m16n8k16 bf16 → f32.  Each
//     warp's Q fragments are loaded once (ldmatrix) and stay in registers;
//     K tiles are read with ldmatrix, V tiles with ldmatrix.trans; S and the
//     running O stay in registers; the online softmax runs in registers (a
//     row's max takes two __shfl_xor_sync across its lane quad, its sum is
//     reduced once at the end); P is rounded to bf16 straight into the A
//     fragments of the P·V product (C-fragment → A-fragment reuse).
//   * KV tiles of 64 keys gathered through the block table by cp.async
//     16-byte copies into a 3-stage ring (rows padded by 16 B, so ldmatrix's
//     eight row reads hit distinct banks); the Q tile is staged in the third
//     stage before the ring starts.  D 128: 3 × 34 KB = 102 KB, two CTAs per
//     SM.  The loop stops at the last key a valid row of the tile sees.
//   * Two CTA shapes.  rep·C > 16 (prefill, mixed): 64 rows, warp w takes
//     rows 16w..16w+15 against every key of a tile.  rep·C <= 16 (decode):
//     16 rows, and warp w takes keys 16w..16w+15 of every tile, so no warp
//     idles; the four warps merge (m, l, O) through shared memory at the end.
//     A group wider than a tile (Falcon-7B's 71 heads on one kv head) takes
//     several 64-row tiles, each reading the group's keys: at decode a tile
//     of 64 rows and one of 7, whose warps 1-3 hold no row and skip the math.
//   * The context split over the grid (flash-decoding) when the grid is
//     small: the wrapper picks n_split from shapes only (the lengths live on
//     the device); split s covers keys [s·L, (s+1)·L), L a multiple of 64.
//     A split writes its partial (m in base 2, l, unnormalised O; m = -inf
//     and l = 0 where a row sees no key of the split) to f32 scratch, and
//     paged_merge_kernel combines the partials, writes out and zeroes the
//     rows at c >= chunk_lens.  With n_split = 1 the first kernel writes out.
// The cp.async, ldmatrix and mma.sync helpers live in csrc/mma_tile.cuh,
// shared with the bf16 K1 and K2b of csrc/flash_attention.cu.
// TMA is not used (the pages are scattered 16-row blocks).  Left for later:
// wgmma with a warp-specialised producer, and decode split across a cluster
// instead of through global scratch.
//
// float32 keeps the scalar kernel (paged_attention_f32_kernel): the tensor
// cores would bring TF32 rounding into the f32 greedy-parity streams.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <climits>

#include "mma_tile.cuh"

namespace {

using namespace ds_tile;

constexpr int kMaxDevices = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeysPerTile = 64;
// the masked variants of both kernels (template argument VAR)
constexpr int kFull = 0;
constexpr int kWindow = 1;
constexpr int kAlibi = 2;

// the shared-memory opt-in above 48 KB is a per-device attribute of each
// kernel instantiation: set it on a device's first launch only
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t smem, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    done[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

// ============================================================ float32: scalar

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

constexpr int kF32Stages = 2;
constexpr int kF32Vec = 4;  // floats in one 16-byte vector

template <int D, int RPW>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (kF32Stages * 2 * kKeysPerTile * (D + kF32Vec) + kWarps * RPW * D + kWarps * kKeysPerTile);
}

// RPW: query rows per warp; a block owns ROWS = kWarps * RPW consecutive
// group-major rows (row = r·C + c) of one (sequence, kv head).  Scalar f32
// math on the CUDA cores, KV tiles of 64 keys double-buffered by cp.async.
template <int D, int RPW, int VAR>
__global__ void __launch_bounds__(kThreads)
    paged_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ pages,
                               const int* __restrict__ block_table, const int* __restrict__ start_pos,
                               const int* __restrict__ chunk_lens, float* __restrict__ out, int C, int H, int n_kv,
                               int page_size, int max_pages, long long q_sb, long long q_sc, long long q_sh,
                               float scale, int window, const float* __restrict__ slopes) {
  constexpr int VEC = kF32Vec;
  constexpr int LD = D + VEC;  // padded shared row: lane j's 16-byte reads of key j hit distinct banks
  constexpr int CHUNKS = D / VEC;
  constexpr int DPL = (D + 31) / 32;     // output dims per lane (D 80: the last lanes hold fewer)
  constexpr bool kWhole = D % 32 == 0;  // every lane holds DPL dims
  constexpr int ROWS = kWarps * RPW;
  constexpr int KT = kKeysPerTile;
  constexpr int KPL = KT / 32;  // keys per lane in QK

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kv_s = reinterpret_cast<float*>(smem_raw);  // [kF32Stages][2][KT][LD]
  float* q_s = kv_s + kF32Stages * 2 * KT * LD;      // [ROWS][D]
  float* p_s = q_s + ROWS * D;                       // [kWarps][KT]

  const int b = blockIdx.x;
  const int kv = blockIdx.y;
  const int rep = H / n_kv;
  const int rows_total = rep * C;
  const int row0 = blockIdx.z * ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int start = start_pos[b];
  const int clen = chunk_lens[b];

  // the last key a valid row of this block may see bounds the page loop; a
  // window also bounds its start
  int last_key = -1, first_pos = INT_MAX;
  for (int i = 0; i < ROWS; ++i) {
    const int rg = row0 + i;
    if (rg < rows_total && rg % C < clen) {
      last_key = max(last_key, start + rg % C);
      first_pos = min(first_pos, start + rg % C);
    }
  }
  last_key = min(last_key, max_pages * page_size - 1);
  const int n_keys = last_key + 1;
  const int n_tiles = (n_keys + KT - 1) / KT;
  const int t0 = VAR == kWindow && last_key >= 0 ? max(0, first_pos - window + 1) / KT : 0;

  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int rg = row0 + i / D;
    float val = 0.f;
    if (rg < rows_total) {
      const int h = kv * rep + rg / C;
      val = q[b * q_sb + (rg % C) * q_sc + h * q_sh + i % D];
    }
    q_s[i] = val;
  }

  auto load_tile = [&](int tile, int stage) {
    float* k_dst = kv_s + stage * 2 * KT * LD;
    for (int i = threadIdx.x; i < 2 * KT * CHUNKS; i += kThreads) {
      const int which = i / (KT * CHUNKS);  // 0 = K, 1 = V
      const int j = (i / CHUNKS) % KT;
      const int ch = i % CHUNKS;
      const int key = tile * KT + j;
      const bool ok = key < n_keys;
      const float* src = pages;
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

  if (n_tiles > t0) load_tile(t0, t0 % kF32Stages);
  for (int t = t0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(t + 1, (t + 1) % kF32Stages);
    } else {
      cp_async_commit();  // empty group keeps wait_group<1> meaning "tile t landed"
    }
    cp_async_wait<1>();
    __syncthreads();

    const float* k_s = kv_s + (t % kF32Stages) * 2 * KT * LD;
    const float* v_s = k_s + KT * LD;
    float* p_w = p_s + warp * KT;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int lr = warp * RPW + i;
      const int rg = row0 + lr;
      if (rg >= rows_total || rg % C >= clen) continue;  // warp-uniform
      const int qpos = start + rg % C;
      const int first_key = t * KT;
      if (first_key > qpos) continue;  // whole tile in this row's future
      if (VAR == kWindow && first_key + KT <= qpos - window + 1) continue;  // before the row's window
      const float* qr = q_s + lr * D;
      const float slope = VAR == kAlibi ? slopes[kv * rep + rg / C] : 0.f;

      float s[KPL];
      float tmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        const int j = u * 32 + lane;
        const float* kr = k_s + j * LD;
        float dot = 0.f;
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) {
          const float4 kf = *reinterpret_cast<const float4*>(kr + ch * VEC);
          dot = fmaf(qr[ch * VEC + 0], kf.x, dot);
          dot = fmaf(qr[ch * VEC + 1], kf.y, dot);
          dot = fmaf(qr[ch * VEC + 2], kf.z, dot);
          dot = fmaf(qr[ch * VEC + 3], kf.w, dot);
        }
        const int key = first_key + j;
        bool vis = key <= qpos;
        if (VAR == kWindow) vis = vis && key > qpos - window;
        if (VAR == kAlibi) dot += slope * (float)key;
        s[u] = vis ? dot * scale : -INFINITY;
        tmax = fmaxf(tmax, s[u]);
      }
      tmax = warp_max(tmax);
      const float m_new = fmaxf(m[i], tmax);  // finite: the tile holds a visible key of the row
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        const float p = expf(s[u] - m_new);
        psum += p;
        p_w[u * 32 + lane] = p;
      }
      psum = warp_sum(psum);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
      __syncwarp();
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] *= alpha;
      const int j_end = min(KT, qpos - first_key + 1);
      const int j_begin = VAR == kWindow ? max(0, qpos - window + 1 - first_key) : 0;
      for (int j = j_begin; j < j_end; ++j) {
        const float p = p_w[j];
        const float* vr = v_s + j * LD + lane * DPL;
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd)
          if (kWhole || lane * DPL + dd < D) acc[i][dd] = fmaf(p, vr[dd], acc[i][dd]);
      }
      __syncwarp();
    }
    __syncthreads();  // stage t % kF32Stages is refilled by the next iteration's load
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int rg = row0 + warp * RPW + i;
    if (rg >= rows_total) continue;
    const int c = rg % C;
    const int h = kv * rep + rg / C;
    float* o = out + (((long long)b * C + c) * H + h) * D + lane * DPL;
    const bool valid = c < clen;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd)
      if (kWhole || lane * DPL + dd < D) o[dd] = valid ? acc[i][dd] / denom : 0.f;
  }
}

template <int D, int RPW, int VAR>
cudaError_t launch_f32(const void* q, const void* pages, const int* block_table, const int* start_pos,
                       const int* chunk_lens, void* out, int B, int C, int H, int n_kv, int page_size, int max_pages,
                       long long q_sb, long long q_sc, long long q_sh, int window, const float* slopes,
                       cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D, RPW>();
  auto kernel = paged_attention_f32_kernel<D, RPW, VAR>;
  static std::atomic<bool> opted_in[kMaxDevices];
  cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  constexpr int rows_per_block = kWarps * RPW;
  const int row_blocks = ((H / n_kv) * C + rows_per_block - 1) / rows_per_block;
  const dim3 grid(B, n_kv, row_blocks);
  const float scale = (float)(1.0 / sqrt((double)D));
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(pages),
                                           block_table, start_pos, chunk_lens, static_cast<float*>(out), C, H, n_kv,
                                           page_size, max_pages, q_sb, q_sc, q_sh, scale, window, slopes);
  return cudaGetLastError();
}

template <int D, int VAR>
cudaError_t launch_f32_rows(const void* q, const void* pages, const int* block_table, const int* start_pos,
                            const int* chunk_lens, void* out, int B, int C, int H, int n_kv, int page_size,
                            int max_pages, long long q_sb, long long q_sc, long long q_sh, int window,
                            const float* slopes, cudaStream_t stream) {
  // decode (rep·C <= 4 rows): one row per warp; otherwise four rows per
  // warp so each staged KV tile serves 16 query rows
  if ((H / n_kv) * C <= kWarps)
    return launch_f32<D, 1, VAR>(q, pages, block_table, start_pos, chunk_lens, out, B, C, H, n_kv, page_size,
                                 max_pages, q_sb, q_sc, q_sh, window, slopes, stream);
  return launch_f32<D, 4, VAR>(q, pages, block_table, start_pos, chunk_lens, out, B, C, H, n_kv, page_size,
                               max_pages, q_sb, q_sc, q_sh, window, slopes, stream);
}

// ============================================================ bf16: tensor cores

constexpr int kTcStages = 3;

template <int D>
__host__ __device__ constexpr int tc_ld() {
  return D + 8;  // bf16 per padded shared row: eight rows 16 B apart in banks
}
template <int D>
__host__ __device__ constexpr int tc_stage_elems() {
  return 2 * kKeysPerTile * tc_ld<D>();  // K tile, then V tile
}
template <int D>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * kTcStages * tc_stage_elems<D>();
}

// ROWS = 64: warp w takes rows 16w..16w+15 and every key of a tile.
// ROWS = 16 (decode): warp w takes rows 0..15 and keys 16w..16w+15 of a tile.
template <int D, int ROWS, int VAR>
__global__ void __launch_bounds__(kThreads, 2)
    paged_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ pages,
                              const int* __restrict__ block_table, const int* __restrict__ start_pos,
                              const int* __restrict__ chunk_lens, bf16* __restrict__ out, float* __restrict__ part_m,
                              float* __restrict__ part_l, float* __restrict__ part_o, int C, int H, int n_kv,
                              int page_size, int max_pages, long long q_sb, long long q_sc, long long q_sh,
                              float scale_log2, int split_len, int window, const float* __restrict__ slopes) {
  constexpr bool KSPLIT = ROWS == 16;
  constexpr int KT = kKeysPerTile;
  constexpr int WKEYS = KSPLIT ? KT / kWarps : KT;  // keys of a tile one warp takes
  constexpr int NB = WKEYS / 8;                     // S blocks of 8 keys per warp
  constexpr int KD = D / 16;                        // depth slices of Q·Kᵀ
  constexpr int DB = D / 8;                         // column blocks of O
  constexpr int LD = tc_ld<D>();
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int STAGE = tc_stage_elems<D>();
  static_assert(ROWS * LD <= STAGE, "the Q tile is staged in one ring stage");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kv_s = reinterpret_cast<bf16*>(smem_raw);  // [kTcStages][K, V][KT][LD]
  bf16* q_s = kv_s + (kTcStages - 1) * STAGE;       // [ROWS][LD], until the ring reaches its last stage

  // the last row tiles see the most keys (causal): they launch first
  const int n_batch = gridDim.x / n_kv;
  const int tile = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / n_kv;
  const int kv = blockIdx.x % n_kv;
  const int split = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = lane >> 2;
  const int tig = lane & 3;
  const int rep = H / n_kv;
  const int rows_total = rep * C;
  const int row0 = tile * ROWS;
  const int start = start_pos[b];
  const int clen = min(chunk_lens[b], C);

  // chunk positions of the tile's rows, and the last key a valid row sees
  const int c_lo = row0 / rep;
  const int c_hi = min((row0 + ROWS - 1) / rep, clen - 1);
  const int n_keys = c_lo <= c_hi ? min(start + c_hi, max_pages * page_size - 1) + 1 : 0;
  int k_begin = split * split_len;
  if (VAR == kWindow)  // from the tile holding the first key the earliest row's window sees
    k_begin = max(k_begin, max(0, start + c_lo - window + 1) / KT * KT);
  const int k_end = min((split + 1) * split_len, n_keys);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + KT - 1) / KT : 0;

  // partial row (c, h) of this split
  auto part_row = [&](int c, int h) -> long long { return (((long long)split * n_batch + b) * C + c) * H + h; };

  if (n_tiles == 0) {  // no valid row, or every row's keys end before this split
    for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
      const int g = row0 + i / CH;
      if (g >= rows_total) continue;
      const int c = g / rep;
      const int h = kv * rep + g % rep;
      if (out != nullptr) {
        *reinterpret_cast<uint4*>(out + (((long long)b * C + c) * H + h) * D + (i % CH) * 8) = make_uint4(0, 0, 0, 0);
      } else if (i % CH == 0) {
        part_m[part_row(c, h)] = -INFINITY;
        part_l[part_row(c, h)] = 0.f;
      }
    }
    return;
  }

  // Q tile -> the last stage; rows past the chunk are zeros
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
    const int r = i / CH;
    const int ch = i % CH;
    const int g = row0 + r;
    const bool ok = g < rows_total && g / rep < clen;
    const bf16* src = q;
    if (ok) src = q + b * q_sb + (g / rep) * q_sc + (kv * rep + g % rep) * q_sh + ch * 8;
    cp_async16(q_s + r * LD + ch * 8, src, ok);
  }
  cp_async_commit();

  // a thread copies one 16-byte column chunk of KT / (kThreads / CH) keys,
  // K and V from one page lookup
  constexpr int KEY_STEP = kThreads / CH;
  constexpr int LOADERS = KEY_STEP * CH;  // D 80 and 96: the last 8 threads copy nothing
  const int my_ch = threadIdx.x % CH;
  const int* bt_row = block_table + (long long)b * max_pages;
  const bf16* kv_col = pages + (long long)kv * D + my_ch * 8;  // K of slot 0 of page 0, this chunk
  const long long slot_stride = 2LL * n_kv * D;
  auto load_tile = [&](int t, int stage) {
    bf16* dst = kv_s + stage * STAGE + my_ch * 8;
    const int j0 = threadIdx.x / CH;
    int key = k_begin + t * KT + j0;
    int pidx = key / page_size;  // the page of key, and its slot, stepped along
    int slot = key - pidx * page_size;
#pragma unroll
    for (int j = j0; j < KT && (LOADERS == kThreads || threadIdx.x < LOADERS); j += KEY_STEP) {
      const bool ok = key < k_end;
      const bf16* src = pages;
      if (ok) src = kv_col + ((long long)bt_row[pidx] * page_size + slot) * slot_stride;
      cp_async16(dst + j * LD, src, ok);
      cp_async16(dst + (KT + j) * LD, ok ? src + (long long)n_kv * D : src, ok);
      key += KEY_STEP;
      for (slot += KEY_STEP; slot >= page_size; slot -= page_size) ++pidx;
    }
    cp_async_commit();
  };
  load_tile(0, 0);
  if (n_tiles > 1) {
    load_tile(1, 1);
  } else {
    cp_async_commit();
  }

  // this thread's two rows (g, g + 8 of the warp's 16) and their last visible key
  const int rb = KSPLIT ? 0 : warp;
  const int ga = row0 + rb * 16 + group;
  const int gb = ga + 8;
  const int qpos_a = (ga < rows_total && ga / rep < clen) ? start + ga / rep : -1;
  const int qpos_b = (gb < rows_total && gb / rep < clen) ? start + gb / rep : -1;
  const float slope_a = VAR == kAlibi && ga < rows_total ? slopes[kv * rep + ga % rep] : 0.f;
  const float slope_b = VAR == kAlibi && gb < rows_total ? slopes[kv * rep + gb % rep] : 0.f;
  // the last key any row of the warp sees (-1: the warp has no valid row),
  // and the last key every valid row sees
  int warp_qmax = -1, warp_qmin = -1;
  {
    const int g0 = row0 + rb * 16;
    const int g_last = min(g0 + 15, rows_total - 1);
    if (g0 < rows_total && g0 / rep < clen) {
      warp_qmax = start + min(g_last / rep, clen - 1);
      warp_qmin = start + g0 / rep;
    }
  }

  cp_async_wait<2>();  // the Q tile
  __syncthreads();
  unsigned qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_a_frag(qa[kk], q_s + rb * 16 * LD + kk * 16, LD, lane);

  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float o[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;

  const int wkey0 = KSPLIT ? warp * WKEYS : 0;  // the warp's first key in a tile
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<1>();  // tile t landed
    __syncthreads();     // and every warp is done with tile t - 1 (and the Q tile)
    if (t + 2 < n_tiles) {
      load_tile(t + 2, (t + 2) % kTcStages);
    } else {
      cp_async_commit();  // empty group keeps wait_group<1> meaning "tile t + 1 landed"
    }
    const int kbase = k_begin + t * KT + wkey0;
    if (kbase > warp_qmax) continue;  // the warp's keys are in all its rows' future
    if (VAR == kWindow && kbase + WKEYS <= warp_qmin - window + 1) continue;  // before all its rows' windows
    const bf16* k_s = kv_s + (t % kTcStages) * STAGE + wkey0 * LD;
    const bf16* v_s = k_s + KT * LD;

    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int p = 0; p < NB / 2; ++p) {
        unsigned kf[4];
        load_k_frags(kf, k_s + p * 16 * LD + kk * 16, LD, lane);
        mma_bf16(s[2 * p], qa[kk], kf[0], kf[1]);
        mma_bf16(s[2 * p + 1], qa[kk], kf[2], kf[3]);
      }
    }

    // causal edge, keys past the last one, invalid rows (qpos -1): -inf.
    // A slice every valid row sees in full needs no mask: the invalid rows
    // of the warp then hold scores of zero q rows, which are never written
    // (their outputs are zeros, their partials are dropped by chunk_lens).
    // With a window, a slice is seen in full when it also starts inside the
    // latest row's window.  Alibi adds slope·key to the logit (the base-2
    // scale multiplies both).
    const bool full = kbase + WKEYS - 1 <= warp_qmin && (VAR != kWindow || kbase > warp_qmax - window);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kbase + nb * 8 + tig * 2 + (e & 1);
        const int qp = e < 2 ? qpos_a : qpos_b;
        bool vis = key <= qp && key < n_keys;
        if (VAR == kWindow) vis = vis && key > qp - window;
        float x = s[nb][e];
        if (VAR == kAlibi) x += (e < 2 ? slope_a : slope_b) * (float)key;
        s[nb][e] = (full || vis) ? x * scale_log2 : -INFINITY;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[nb][0], s[nb][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nb][2], s[nb][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    // a row that has seen no key keeps m = -inf: subtract 0, not -inf - -inf
    const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float alpha_a = exp2f(m_a - mu_a);
    const float alpha_b = exp2f(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= alpha_a;
    l_b *= alpha_b;
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      o[db][0] *= alpha_a;
      o[db][1] *= alpha_a;
      o[db][2] *= alpha_b;
      o[db][3] *= alpha_b;
    }

    // p in f32 for l, rounded to bf16 into the A fragments of P·V: S blocks
    // 2j and 2j + 1 are keys 16j..16j+15, the depth of one product
    unsigned pa[NB / 2][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float p0 = exp2f(s[nb][0] - mu_a);
      const float p1 = exp2f(s[nb][1] - mu_a);
      const float p2 = exp2f(s[nb][2] - mu_b);
      const float p3 = exp2f(s[nb][3] - mu_b);
      l_a += p0 + p1;
      l_b += p2 + p3;
      pa[nb / 2][(nb & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[nb / 2][(nb & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) {
#pragma unroll
      for (int dp = 0; dp < DB / 2; ++dp) {
        unsigned vf[4];
        load_v_frags(vf, v_s + j * 16 * LD + dp * 16, LD, lane);
        mma_bf16(o[2 * dp], pa[j], vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa[j], vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // a row's l: the sum over its lane quad
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);

  if constexpr (!KSPLIT) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int g = half ? gb : ga;
      if (g >= rows_total) continue;
      const int c = g / rep;
      const int h = kv * rep + g % rep;
      const float m_r = half ? m_b : m_a;
      const float l_r = half ? l_b : l_a;
      if (out != nullptr) {
        // a valid row sees key 0, so l > 0; other rows are zeros
        const float inv = c < clen ? 1.f / l_r : 0.f;
        bf16* dst = out + (((long long)b * C + c) * H + h) * D + tig * 2;
#pragma unroll
        for (int db = 0; db < DB; ++db)
          *reinterpret_cast<__nv_bfloat162*>(dst + db * 8) =
              __floats2bfloat162_rn(o[db][half * 2] * inv, o[db][half * 2 + 1] * inv);
      } else {
        const long long pr = part_row(c, h);
        float* dst = part_o + pr * D + tig * 2;
#pragma unroll
        for (int db = 0; db < DB; ++db)
          *reinterpret_cast<float2*>(dst + db * 8) = make_float2(o[db][half * 2], o[db][half * 2 + 1]);
        if (tig == 0) {
          part_m[pr] = m_r;
          part_l[pr] = l_r;
        }
      }
    }
  } else {
    // merge the four warps' (m, l, O) of rows 0..15 through shared memory
    constexpr int OLD = D + 4;
    static_assert(sizeof(float) * kWarps * 16 * (OLD + 2) <= tc_smem_bytes<D>(), "the merge reuses the ring");
    __syncthreads();  // every warp is done with the ring
    float* o_s = reinterpret_cast<float*>(smem_raw);  // [kWarps][16][OLD]
    float* m_s = o_s + kWarps * 16 * OLD;             // [kWarps][16]
    float* l_s = m_s + kWarps * 16;                   // [kWarps][16]
    float* ow = o_s + warp * 16 * OLD;
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      *reinterpret_cast<float2*>(ow + group * OLD + db * 8 + tig * 2) = make_float2(o[db][0], o[db][1]);
      *reinterpret_cast<float2*>(ow + (group + 8) * OLD + db * 8 + tig * 2) = make_float2(o[db][2], o[db][3]);
    }
    if (tig == 0) {
      m_s[warp * 16 + group] = m_a;
      m_s[warp * 16 + group + 8] = m_b;
      l_s[warp * 16 + group] = l_a;
      l_s[warp * 16 + group + 8] = l_b;
    }
    __syncthreads();
    constexpr int PER = D / 8;  // columns per thread: 8 threads per row
    const int i = threadIdx.x >> 3;
    const int col0 = (threadIdx.x & 7) * PER;
    const int g = row0 + i;
    if (g < rows_total) {
      float mw[kWarps];
      float big = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        mw[w] = m_s[w * 16 + i];
        big = fmaxf(big, mw[w]);
      }
      float wt[kWarps];
      float lsum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        wt[w] = mw[w] == -INFINITY ? 0.f : exp2f(mw[w] - big);
        lsum += wt[w] * l_s[w * 16 + i];
      }
      float acc[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += wt[w] * o_s[(w * 16 + i) * OLD + col0 + e];
        acc[e] = v;
      }
      const int c = g / rep;
      const int h = kv * rep + g % rep;
      if (out != nullptr) {
        const float inv = c < clen ? 1.f / lsum : 0.f;
        bf16* dst = out + (((long long)b * C + c) * H + h) * D + col0;
        if constexpr (PER % 8 == 0) {
#pragma unroll
          for (int e = 0; e < PER; e += 8) {
            uint4 v;
            v.x = pack_bf16(acc[e] * inv, acc[e + 1] * inv);
            v.y = pack_bf16(acc[e + 2] * inv, acc[e + 3] * inv);
            v.z = pack_bf16(acc[e + 4] * inv, acc[e + 5] * inv);
            v.w = pack_bf16(acc[e + 6] * inv, acc[e + 7] * inv);
            *reinterpret_cast<uint4*>(dst + e) = v;
          }
        } else {  // D 80: 10 columns a thread, 4-byte aligned
#pragma unroll
          for (int e = 0; e < PER; e += 2)
            *reinterpret_cast<__nv_bfloat162*>(dst + e) = __floats2bfloat162_rn(acc[e] * inv, acc[e + 1] * inv);
        }
      } else {
        const long long pr = part_row(c, h);
        float* dst = part_o + pr * D + col0;
        if constexpr (PER % 4 == 0) {
#pragma unroll
          for (int e = 0; e < PER; e += 4)
            *reinterpret_cast<float4*>(dst + e) = make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < PER; e += 2) *reinterpret_cast<float2*>(dst + e) = make_float2(acc[e], acc[e + 1]);
        }
        if (col0 == 0) {
          part_m[pr] = big;
          part_l[pr] = lsum;
        }
      }
    }
  }
}

template <int D, int ROWS, int VAR>
cudaError_t launch_tc(const void* q, const void* pages, const int* block_table, const int* start_pos,
                      const int* chunk_lens, void* out, float* part_m, float* part_l, float* part_o, int B, int C,
                      int H, int n_kv, int page_size, int max_pages, long long q_sb, long long q_sc, long long q_sh,
                      int n_split, int split_len, int window, const float* slopes, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  auto kernel = paged_attention_tc_kernel<D, ROWS, VAR>;
  static std::atomic<bool> opted_in[kMaxDevices];
  cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  const int row_tiles = ((H / n_kv) * C + ROWS - 1) / ROWS;
  const dim3 grid(B * n_kv, row_tiles, n_split);
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(pages), block_table,
                                           start_pos, chunk_lens, static_cast<bf16*>(out), part_m, part_l, part_o, C,
                                           H, n_kv, page_size, max_pages, q_sb, q_sc, q_sh, scale_log2, split_len,
                                           window, slopes);
  return cudaGetLastError();
}

template <int D, int VAR>
cudaError_t launch_tc_rows(int tile_rows, const void* q, const void* pages, const int* block_table,
                           const int* start_pos, const int* chunk_lens, void* out, float* part_m, float* part_l,
                           float* part_o, int B, int C, int H, int n_kv, int page_size, int max_pages, long long q_sb,
                           long long q_sc, long long q_sh, int n_split, int split_len, int window, const float* slopes,
                           cudaStream_t stream) {
  if (tile_rows == 16)
    return launch_tc<D, 16, VAR>(q, pages, block_table, start_pos, chunk_lens, out, part_m, part_l, part_o, B, C, H,
                                 n_kv, page_size, max_pages, q_sb, q_sc, q_sh, n_split, split_len, window, slopes,
                                 stream);
  if (tile_rows == 64)
    return launch_tc<D, 64, VAR>(q, pages, block_table, start_pos, chunk_lens, out, part_m, part_l, part_o, B, C, H,
                                 n_kv, page_size, max_pages, q_sb, q_sc, q_sh, n_split, split_len, window, slopes,
                                 stream);
  return cudaErrorInvalidValue;
}

// one attention launch at head dim D and variant VAR: the tensor-core kernel
// for bf16 (split or not), the scalar kernel for f32 (unsplit)
template <int D, int VAR>
cudaError_t launch_attention(int dtype, int tile_rows, const void* q, const void* pages, const int* block_table,
                             const int* start_pos, const int* chunk_lens, void* out, float* part_m, float* part_l,
                             float* part_o, int B, int C, int H, int n_kv, int page_size, int max_pages,
                             long long q_sb, long long q_sc, long long q_sh, int n_split, int split_len, int window,
                             const float* slopes, cudaStream_t stream) {
  if (dtype == 1)
    return launch_tc_rows<D, VAR>(tile_rows, q, pages, block_table, start_pos, chunk_lens, out, part_m, part_l, part_o,
                                  B, C, H, n_kv, page_size, max_pages, q_sb, q_sc, q_sh, n_split, split_len, window,
                                  slopes, stream);
  if (dtype == 0 && n_split == 1)
    return launch_f32_rows<D, VAR>(q, pages, block_table, start_pos, chunk_lens, out, B, C, H, n_kv, page_size,
                                   max_pages, q_sb, q_sc, q_sh, window, slopes, stream);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_variant(int dtype, int tile_rows, const void* q, const void* pages, const int* block_table,
                           const int* start_pos, const int* chunk_lens, void* out, float* part_m, float* part_l,
                           float* part_o, int B, int C, int H, int n_kv, int page_size, int max_pages, long long q_sb,
                           long long q_sc, long long q_sh, int n_split, int split_len, int window, const float* slopes,
                           cudaStream_t stream) {
  if (window > 0 && slopes != nullptr) return cudaErrorInvalidValue;  // no model takes both
  if (window > 0)
    return launch_attention<D, kWindow>(dtype, tile_rows, q, pages, block_table, start_pos, chunk_lens, out, part_m,
                                        part_l, part_o, B, C, H, n_kv, page_size, max_pages, q_sb, q_sc, q_sh, n_split,
                                        split_len, window, slopes, stream);
  if (slopes != nullptr)
    return launch_attention<D, kAlibi>(dtype, tile_rows, q, pages, block_table, start_pos, chunk_lens, out, part_m,
                                       part_l, part_o, B, C, H, n_kv, page_size, max_pages, q_sb, q_sc, q_sh, n_split,
                                       split_len, window, slopes, stream);
  return launch_attention<D, kFull>(dtype, tile_rows, q, pages, block_table, start_pos, chunk_lens, out, part_m,
                                    part_l, part_o, B, C, H, n_kv, page_size, max_pages, q_sb, q_sc, q_sh, n_split,
                                    split_len, window, slopes, stream);
}

// ============================================================ the merge of split partials

// one warp per row (b, c, h): out = Σ_s 2^(m_s − M) O_s / Σ_s 2^(m_s − M) l_s,
// M = max_s m_s; a split with m_s = -inf holds no key of the row (its O_s is
// not read); rows at c >= chunk_lens, and rows no split saw, are zeros
template <int D>
__global__ void __launch_bounds__(kThreads)
    paged_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                       const float* __restrict__ part_o, const int* __restrict__ chunk_lens, bf16* __restrict__ out,
                       int n_split, long long rows, int C, int H) {
  constexpr int E = D % 64 == 0 ? D / 32 : 2 * ((D + 63) / 64);  // columns per lane
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int b = (int)(row / ((long long)C * H));
  const int c = (int)((row / H) % C);
  float big = -INFINITY;
  for (int s = 0; s < n_split; ++s) big = fmaxf(big, part_m[s * rows + row]);
  // D 64 and 128: lane l holds columns [l·E, (l+1)·E); D 80 and 96: column
  // pairs l, l + 32, ... (E / 2 of them, the last ones past D unused)
  auto col = [&](int e) { return D % 64 == 0 ? lane * E + e : (e / 2 * 32 + lane) * 2 + e % 2; };
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float lsum = 0.f;
  const bool valid = c < chunk_lens[b] && big != -INFINITY;
  if (valid) {
    for (int s = 0; s < n_split; ++s) {
      const float ms = part_m[s * rows + row];
      if (ms == -INFINITY) continue;
      const float w = exp2f(ms - big);
      lsum += w * part_l[s * rows + row];
      const float* src = part_o + (s * rows + row) * D;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (D % 64 == 0 || col(e) < D) acc[e] += w * src[col(e)];
    }
  }
  const float inv = valid ? 1.f / lsum : 0.f;
  bf16* dst = out + row * D;
#pragma unroll
  for (int e = 0; e < E; e += 2)
    if (D % 64 == 0 || col(e) < D)
      *reinterpret_cast<__nv_bfloat162*>(dst + col(e)) = __floats2bfloat162_rn(acc[e] * inv, acc[e + 1] * inv);
}

// one warp: c1 = a · kᵀ and c2 = a · v through the fragment loaders and the
// mma of the main kernel (a [16][16], k [8][16], v [16][8] row-major bf16;
// c1, c2 [16][8] f32)
__global__ void mma_probe_kernel(const bf16* __restrict__ a, const bf16* __restrict__ k, const bf16* __restrict__ v,
                                 float* __restrict__ c1, float* __restrict__ c2) {
  constexpr int LD = 24;  // 16 columns + 16 B of padding
  __shared__ __align__(16) bf16 a_s[16 * LD];
  __shared__ __align__(16) bf16 k_s[16 * LD];
  __shared__ __align__(16) bf16 v_s[16 * LD];
  const int lane = threadIdx.x;
  for (int i = lane; i < 16 * 16; i += 32) {
    const int r = i / 16, col = i % 16;
    a_s[r * LD + col] = a[i];
    k_s[r * LD + col] = r < 8 ? k[i] : __float2bfloat16(0.f);
    v_s[r * LD + col] = col < 8 ? v[r * 8 + col] : __float2bfloat16(0.f);
  }
  __syncwarp();
  unsigned af[4], kf[4], vf[4];
  load_a_frag(af, a_s, LD, lane);
  load_k_frags(kf, k_s, LD, lane);
  load_v_frags(vf, v_s, LD, lane);
  float s[4] = {0.f, 0.f, 0.f, 0.f}, o[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(s, af, kf[0], kf[1]);
  mma_bf16(o, af, vf[0], vf[1]);
  const int g = lane >> 2, t = lane & 3;
  c1[g * 8 + 2 * t] = s[0];
  c1[g * 8 + 2 * t + 1] = s[1];
  c1[(g + 8) * 8 + 2 * t] = s[2];
  c1[(g + 8) * 8 + 2 * t + 1] = s[3];
  c2[g * 8 + 2 * t] = o[0];
  c2[g * 8 + 2 * t + 1] = o[1];
  c2[(g + 8) * 8 + 2 * t] = o[2];
  c2[(g + 8) * 8 + 2 * t + 1] = o[3];
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides of q are in elements.  D is 64,
// 80, 96 or 128.  window > 0: a sliding window; slopes (float32 [H], or
// null): alibi; not both.
// bfloat16: tile_rows (16 or 64) is the CTA shape, n_split the context split;
// with n_split = 1 the kernel writes out, otherwise out is unused and the
// partials go to part_m, part_l [n_split, B, C, H] and part_o [n_split, B, C,
// H, D] (f32) for ds_paged_merge.  float32 takes n_split = 1 only.  Returns
// the cudaError_t of the launch (0 on success); shapes are checked by the
// Python wrapper (deepspeed_tpu_torch/ops/paged_attention.py).
int ds_paged_attention(const void* q, const void* pages, const int* block_table, const int* start_pos,
                       const int* chunk_lens, void* out, float* part_m, float* part_l, float* part_o, int B, int C,
                       int H, int n_kv, int D, int page_size, int max_pages, long long q_sb, long long q_sc,
                       long long q_sh, int dtype, int tile_rows, int n_split, int split_len, int window,
                       const float* slopes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || (n_split > 1 && (part_m == nullptr || part_l == nullptr || part_o == nullptr)) ||
      (n_split == 1 && out == nullptr) || split_len < 1 || split_len % kKeysPerTile || window < 0)
    return (int)cudaErrorInvalidValue;
  void* dst = n_split == 1 ? out : nullptr;
  switch (D) {
    case 64:
      return launch_variant<64>(dtype, tile_rows, q, pages, block_table, start_pos, chunk_lens, dst, part_m, part_l,
                                part_o, B, C, H, n_kv, page_size, max_pages, q_sb, q_sc, q_sh, n_split, split_len,
                                window, slopes, s);
    case 80:
      return launch_variant<80>(dtype, tile_rows, q, pages, block_table, start_pos, chunk_lens, dst, part_m, part_l,
                                part_o, B, C, H, n_kv, page_size, max_pages, q_sb, q_sc, q_sh, n_split, split_len,
                                window, slopes, s);
    case 96:
      return launch_variant<96>(dtype, tile_rows, q, pages, block_table, start_pos, chunk_lens, dst, part_m, part_l,
                                part_o, B, C, H, n_kv, page_size, max_pages, q_sb, q_sc, q_sh, n_split, split_len,
                                window, slopes, s);
    case 128:
      return launch_variant<128>(dtype, tile_rows, q, pages, block_table, start_pos, chunk_lens, dst, part_m, part_l,
                                 part_o, B, C, H, n_kv, page_size, max_pages, q_sb, q_sc, q_sh, n_split, split_len,
                                 window, slopes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out [B, C, H, D] bf16 from the partials of ds_paged_attention
int ds_paged_merge(const float* part_m, const float* part_l, const float* part_o, const int* chunk_lens, void* out,
                   int n_split, int B, int C, int H, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * C * H;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  bf16* o = static_cast<bf16*>(out);
  switch (D) {
    case 64: paged_merge_kernel<64><<<blocks, kThreads, 0, s>>>(part_m, part_l, part_o, chunk_lens, o, n_split, rows, C, H); break;
    case 80: paged_merge_kernel<80><<<blocks, kThreads, 0, s>>>(part_m, part_l, part_o, chunk_lens, o, n_split, rows, C, H); break;
    case 96: paged_merge_kernel<96><<<blocks, kThreads, 0, s>>>(part_m, part_l, part_o, chunk_lens, o, n_split, rows, C, H); break;
    case 128: paged_merge_kernel<128><<<blocks, kThreads, 0, s>>>(part_m, part_l, part_o, chunk_lens, o, n_split, rows, C, H); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// one m16n8k16 product through the main kernel's fragment loaders
int ds_paged_mma_probe(const void* a, const void* k, const void* v, float* c1, float* c2, void* stream) {
  mma_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(k), static_cast<const bf16*>(v), c1, c2);
  return (int)cudaGetLastError();
}

const char* ds_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
