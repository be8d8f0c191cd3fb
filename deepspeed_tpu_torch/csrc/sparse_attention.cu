// K6a, K6b, K6c: block-sparse attention forward and backward for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels of
// deepspeed_tpu/ops/sparse_attention/pallas_kernel.py:
//   K6a sparse_fwd_kernel <- _kernel     (:35),  driven by _fwd_impl (:257)
//   K6b sparse_dq_kernel  <- _dq_kernel  (:125), driven by _bwd_impl (:307)
//   K6c sparse_dkv_kernel <- _dkv_kernel (:152), driven by _bwd_impl (:307)
//
// Layout (all contiguous; ops/sparse_attention/kernel.py checks shapes,
// dtypes and alignment):
//   q, k, v, o, do, dq, dk, dv   [B, H, S, D]      lse, delta   [B, H, S] f32
//   kpm (optional)               [B, S] uint8, 1 = the key may be attended
//   row_ptr [H·nb + 1], row_idx: the admitted kv blocks of each (head, q
//   block), ascending (CSR); col_ptr, col_idx: the admitted q blocks of each
//   (head, kv block), ascending; row_order, col_order [H·nb]: (head, block)
//   ids by descending count, the launch order.  nb = S / block.
// Scores are s = q·k · scale.  A score is masked when its key is not
// admitted by kpm or, with causal, lies after the query (token positions,
// inside admitted blocks); a masked score is the finite MASK and its p is 0,
// so a row whose admitted keys are all masked emits zeros.
//
//   K6a: o = softmax(s) v online over the row's admitted kv blocks; p is
//        rounded to v's dtype before PV, l sums the unrounded p.  A row with
//        l = 0 (no admitted key, or all masked) writes o = 0 and lse = 3e38,
//        so its backward is exactly 0.
//   K6b: delta = rowsum(do·o) (written for K6c), p = exp(s − lse),
//        dp = do·vᵀ, ds = p (dp − delta) · scale rounded to the input dtype,
//        dq = ds k.
//   K6c: over the transposed table, dv = pᵀ do (p rounded), dk = dsᵀ q.  A kv
//        block that no row admits writes zeros.
//
// Bound.  The work is 4·D (K6a), 6·D (K6b) and 8·D (K6c) flops for each
// visible (query, key) pair, over bytes that do not shrink with sparsity:
// q, k, v, o (and do, dq, dk, dv) are each moved once.  At BERT-large's
// attention (D = 64) with block 16, the DeepSpeed documentation's fixed
// layout (density 0.26 at S 4096) is bound by tensor-core operations, a
// BigBird layout (density 0.023) by HBM bytes.  Either way the bound is far
// below what these kernels take: at block 16 a tile is 16×16×64, so loads,
// the softmax and the shared-memory round trips between the products, not
// the products, set the time.
//
// Design.  The TPU kernels run a sequential grid (B·H, nb, L) whose last axis
// pads every row to the widest row's L and carries the softmax state in VMEM
// across grid steps.  Here:
//   * One CTA owns one query tile of BT = min(block, 64) rows (K6a, K6b), or
//     one key tile of BT keys (K6c), of one (batch, head): it loops over that
//     row's (column's) own admitted blocks, each cut into block / BT
//     sub-tiles of BT keys (queries), and writes its output once.  No
//     padding tile is read, no atomics: results are deterministic.
//   * A CTA is BT / 16 warps; each warp owns a 16-row strip of every tile
//     product, so the softmax between two products reads the warp's own rows
//     from shared memory and needs only __syncwarp.  At block 16 a CTA is one
//     warp and its 16 rows are one nvcuda::wmma row of fragments.
//   * The K/V (K6a, K6b) or Q/dO/lse/delta (K6c) sub-tiles are staged with
//     cp.async, double-buffered where shared memory allows: the next
//     sub-tile's loads overlap this one's math.
//   * With causal, the sub-tiles wholly after the tile's last query (K6a,
//     K6b) or wholly before its first key (K6c) are masked everywhere; the
//     tables are ascending, so they form a suffix (prefix), found by binary
//     search and never loaded.
//   * CTAs are launched heaviest (head, block) first, from row_order /
//     col_order: the rows and columns of global blocks, which admit every
//     block (L = nb), start first instead of trailing the grid.
//   * The products run on the tensor cores in bf16 with f32 accumulators
//     (16×16×16 wmma fragments); scores and accumulators pass through shared
//     memory in f32.  float32 uses f32 FMA on the CUDA cores.
//   * delta is computed once, by K6b, and read by K6c on the same stream
//     (the TPU K6c recomputes it for every tile).
// Later work: split a global row (column) over several CTAs, wgmma with
// register accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kMaxDevices = 64;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a block may use on sm_90
constexpr float kMask = -0.7f * 3.402823466e+38f;
constexpr float kEmptyLse = 3e38f;

template <typename T>
struct Pad {  // elements that pad a shared row by 16 bytes (keeps wmma's 32-byte alignment)
  static constexpr int value = 16 / sizeof(T);
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

// global -> shared, 16 bytes, asynchronous
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy ROWS contiguous rows of COLS elements (row stride COLS in global) into
// shared rows of ld elements, by all NT threads of the block.
template <typename T, int COLS, int ROWS, int NT>
__device__ __forceinline__ void async_rows(T* dst, int ld, const T* src) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = COLS / VEC;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NT) {
    const int r = i / CHUNKS, ch = i % CHUNKS;
    cp_async16(dst + r * ld + ch * VEC, src + (long long)r * COLS + ch * VEC);
  }
}

// One warp: C[16 x 16*NF] (+)= A[16 x KD] * B[KD x 16*NF].  A is row-major
// (lda); B is row-major (ldb) or, with B_COL, given as its transpose
// [16*NF x KD] row-major (ldb); C is f32 row-major (ldc).  All in shared
// memory.  The C tile is read (when accumulating) and written by this warp
// only.
template <typename T, bool B_COL, int NF, int KD>
struct WarpGemm;

template <bool B_COL, int NF, int KD>
struct WarpGemm<__nv_bfloat16, B_COL, NF, KD> {
  __device__ static void run(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B, int ldb, float* C, int ldc,
                             bool accumulate) {
    using BLayout = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      if (accumulate)
        wmma::load_matrix_sync(acc[f], C + 16 * f, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(acc[f], 0.f);
    }
#pragma unroll
    for (int kk = 0; kk < KD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + kk, lda);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b;
        wmma::load_matrix_sync(b, B_COL ? B + 16 * f * ldb + kk : B + kk * ldb + 16 * f, ldb);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) wmma::store_matrix_sync(C + 16 * f, acc[f], ldc, wmma::mem_row_major);
  }
};

template <bool B_COL, int NF, int KD>
struct WarpGemm<float, B_COL, NF, KD> {
  __device__ static void run(const float* A, int lda, const float* B, int ldb, float* C, int ldc, bool accumulate) {
    constexpr int N = 16 * NF;
    constexpr int E = N / 2;  // outputs per lane: 16·N over 32 lanes, output e at flat index 32·e + lane
    const int lane = threadIdx.x & 31;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = 32 * e + lane;
      acc[e] = accumulate ? C[(idx / N) * ldc + idx % N] : 0.f;
    }
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int idx = 32 * e + lane;
        const int row = idx / N, col = idx % N;
        const float b = B_COL ? B[col * ldb + kk] : B[kk * ldb + col];
        acc[e] = fmaf(A[row * lda + kk], b, acc[e]);
      }
    }
    __syncwarp();  // every lane has read C before any lane overwrites it
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = 32 * e + lane;
      C[(idx / N) * ldc + idx % N] = acc[e];
    }
  }
};

template <typename T, bool B_COL, int NF, int KD>
__device__ __forceinline__ void warp_gemm(const T* A, int lda, const T* B, int ldb, float* C, int ldc,
                                          bool accumulate) {
  WarpGemm<T, B_COL, NF, KD>::run(A, lda, B, ldb, C, ldc, accumulate);
  __syncwarp();
}

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// The tile a CTA owns, decoded from blockIdx.x: batch fastest, then the
// part of the block (block / BT parts), then the (head, block) in the
// launch order.
struct TileId {
  int b, h, blk, part;
  __device__ TileId(const int* order, int B, int nb, int subs) {
    int id = blockIdx.x;
    b = id % B;
    id /= B;
    part = id % subs;
    id /= subs;
    const int hb = order[id];
    h = hb / nb;
    blk = hb % nb;
  }
};

// First position of sub-tile t of a block list: list[t / subs]·block + (t % subs)·BT.
__device__ __forceinline__ int sub_tile_pos(const int* list, int t, int subs, int block, int bt) {
  return list[t / subs] * block + (t % subs) * bt;
}

// Number of leading sub-tiles whose first position is <= limit (the
// positions ascend with t).
__device__ __forceinline__ int count_upto(const int* list, int n, int subs, int block, int bt, int limit) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sub_tile_pos(list, mid, subs, block, bt) > limit)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

__device__ __forceinline__ bool key_kept(const uint8_t* kpm, long long b_off, int key) {
  return kpm == nullptr || kpm[b_off + key] != 0;
}

// ---------------------------------------------------------------- K6a

template <typename T, int D, int BT>
struct FwdSmem {
  static constexpr int LDT = D + Pad<T>::value;      // q, k, v tiles
  static constexpr int LDS = BT + 4;                 // f32 scores
  static constexpr int LDP = BT + Pad<T>::value;     // p in T
  static constexpr int LDO = D + 4;                  // f32 accumulator
  static constexpr size_t fixed = align128(sizeof(T) * BT * LDT) + align128(sizeof(float) * BT * LDS) +
                                  align128(sizeof(T) * BT * LDP) + align128(sizeof(float) * BT * LDO);
  static constexpr size_t stage = align128(sizeof(T) * 2 * BT * LDT);
  static constexpr int STAGES = fixed + 2 * stage <= kSmemLimit ? 2 : 1;
  static constexpr size_t q = 0;
  static constexpr size_t s = q + align128(sizeof(T) * BT * LDT);
  static constexpr size_t p = s + align128(sizeof(float) * BT * LDS);
  static constexpr size_t o = p + align128(sizeof(T) * BT * LDP);
  static constexpr size_t kv = o + align128(sizeof(float) * BT * LDO);
  static constexpr size_t bytes = kv + STAGES * stage;
};

template <typename T, int D, int BT>
__global__ void __launch_bounds__(2 * BT)
    sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const uint8_t* __restrict__ kpm, const int* __restrict__ row_ptr,
                      const int* __restrict__ row_idx, const int* __restrict__ row_order, T* __restrict__ o,
                      float* __restrict__ lse, int B, int H, int S, int block, int causal, float scale) {
  using L = FwdSmem<T, D, BT>;
  constexpr int NT = 2 * BT;  // BT / 16 warps
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::q);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  T* p_s = reinterpret_cast<T*>(smem + L::p);
  float* o_s = reinterpret_cast<float*>(smem + L::o);
  T* kv_s = reinterpret_cast<T*>(smem + L::kv);

  const int nb = S / block, subs = block / BT;
  const TileId id(row_order, B, nb, subs);
  const int row0 = id.blk * block + id.part * BT;
  const long long head = ((long long)id.b * H + id.h) * S;  // row offset of (b, h)
  const long long b_off = (long long)id.b * S;
  const int hb = id.h * nb + id.blk;
  const int* cols = row_idx + row_ptr[hb];
  int n_tiles = (row_ptr[hb + 1] - row_ptr[hb]) * subs;
  if (causal) n_tiles = count_upto(cols, n_tiles, subs, block, BT, row0 + BT - 1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;  // this warp's strip of rows
  float* s_w = s_s + r0 * L::LDS;
  T* p_w = p_s + r0 * L::LDP;
  float* o_w = o_s + r0 * L::LDO;

  auto load_tile = [&](int t, int stage) {
    const int key0 = sub_tile_pos(cols, t, subs, block, BT);
    T* dst = kv_s + stage * (L::stage / sizeof(T));
    async_rows<T, D, BT, NT>(dst, L::LDT, k + (head + key0) * D);
    async_rows<T, D, BT, NT>(dst + BT * L::LDT, L::LDT, v + (head + key0) * D);
  };

  async_rows<T, D, BT, NT>(q_s, L::LDT, q + (head + row0) * D);
  cp_async_commit();
  for (int i = lane; i < 16 * D; i += 32) o_w[(i / D) * L::LDO + i % D] = 0.f;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  float m[16], l[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const T* k_s = kv_s + (t % STAGES) * (L::stage / sizeof(T));
    const T* v_s = k_s + BT * L::LDT;
    const int key0 = sub_tile_pos(cols, t, subs, block, BT);

    warp_gemm<T, true, BT / 16, D>(q_s + r0 * L::LDT, L::LDT, k_s, L::LDT, s_w, L::LDS, false);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int qpos = row0 + r0 + i;
      float x[(BT + 31) / 32];
      bool keep[(BT + 31) / 32];
      float tmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < (BT + 31) / 32; ++u) {
        const int c = lane + 32 * u;
        keep[u] = false;
        x[u] = -INFINITY;  // lanes past the tile's width
        if (c < BT) {
          const int key = key0 + c;
          keep[u] = (!causal || key <= qpos) && key_kept(kpm, b_off, key);
          x[u] = keep[u] ? s_w[i * L::LDS + c] * scale : kMask;
        }
        tmax = fmaxf(tmax, x[u]);
      }
      const float m_new = fmaxf(m[i], warp_max(tmax));  // finite: kMask is finite
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < (BT + 31) / 32; ++u) {
        const int c = lane + 32 * u;
        const float p = keep[u] ? expf(x[u] - m_new) : 0.f;
        psum += p;
        if (c < BT) p_w[i * L::LDP + c] = from_float<T>(p);
      }
      l[i] = l[i] * alpha + warp_sum(psum);
      m[i] = m_new;
      for (int d = lane; d < D; d += 32) o_w[i * L::LDO + d] *= alpha;
    }
    __syncwarp();
    warp_gemm<T, false, D / 16, BT>(p_w, L::LDP, v_s, L::LDT, o_w, L::LDO, true);
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int pos = row0 + r0 + i;
    const bool live = l[i] > 0.f;
    const float denom = fmaxf(l[i], 1e-30f);
    T* dst = o + (head + pos) * D;
    for (int d = lane; d < D; d += 32) dst[d] = from_float<T>(live ? o_w[i * L::LDO + d] / denom : 0.f);
    if (lane == 0) lse[head + pos] = live ? m[i] + logf(denom) : kEmptyLse;
  }
}

// ---------------------------------------------------------------- K6b

template <typename T, int D, int BT>
struct DqSmem {
  static constexpr int LDT = D + Pad<T>::value;
  static constexpr int LDS = BT + 4;
  static constexpr int LDP = BT + Pad<T>::value;
  static constexpr int LDO = D + 4;
  static constexpr size_t fixed = 2 * align128(sizeof(T) * BT * LDT) + 2 * align128(sizeof(float) * BT * LDS) +
                                  align128(sizeof(T) * BT * LDP) + align128(sizeof(float) * BT * LDO);
  static constexpr size_t stage = align128(sizeof(T) * 2 * BT * LDT);
  static constexpr int STAGES = fixed + 2 * stage <= kSmemLimit ? 2 : 1;
  static constexpr size_t q = 0;
  static constexpr size_t dO = q + align128(sizeof(T) * BT * LDT);
  static constexpr size_t s = dO + align128(sizeof(T) * BT * LDT);
  static constexpr size_t dp = s + align128(sizeof(float) * BT * LDS);
  static constexpr size_t ds = dp + align128(sizeof(float) * BT * LDS);
  static constexpr size_t dq = ds + align128(sizeof(T) * BT * LDP);
  static constexpr size_t kv = dq + align128(sizeof(float) * BT * LDO);
  static constexpr size_t bytes = kv + STAGES * stage;
};

template <typename T, int D, int BT>
__global__ void __launch_bounds__(2 * BT)
    sparse_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
                     const uint8_t* __restrict__ kpm, const int* __restrict__ row_ptr,
                     const int* __restrict__ row_idx, const int* __restrict__ row_order, T* __restrict__ dq,
                     float* __restrict__ delta, int B, int H, int S, int block, int causal, float scale) {
  using L = DqSmem<T, D, BT>;
  constexpr int NT = 2 * BT;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::q);
  T* do_s = reinterpret_cast<T*>(smem + L::dO);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  float* dp_s = reinterpret_cast<float*>(smem + L::dp);
  T* ds_s = reinterpret_cast<T*>(smem + L::ds);
  float* dq_s = reinterpret_cast<float*>(smem + L::dq);
  T* kv_s = reinterpret_cast<T*>(smem + L::kv);

  const int nb = S / block, subs = block / BT;
  const TileId id(row_order, B, nb, subs);
  const int row0 = id.blk * block + id.part * BT;
  const long long head = ((long long)id.b * H + id.h) * S;
  const long long b_off = (long long)id.b * S;
  const int hb = id.h * nb + id.blk;
  const int* cols = row_idx + row_ptr[hb];
  int n_tiles = (row_ptr[hb + 1] - row_ptr[hb]) * subs;
  if (causal) n_tiles = count_upto(cols, n_tiles, subs, block, BT, row0 + BT - 1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  float* s_w = s_s + r0 * L::LDS;
  float* dp_w = dp_s + r0 * L::LDS;
  T* ds_w = ds_s + r0 * L::LDP;
  float* dq_w = dq_s + r0 * L::LDO;

  // q and do first, alone: delta needs do before the loop
  async_rows<T, D, BT, NT>(q_s, L::LDT, q + (head + row0) * D);
  async_rows<T, D, BT, NT>(do_s, L::LDT, dout + (head + row0) * D);
  cp_async_commit();
  for (int i = lane; i < 16 * D; i += 32) dq_w[(i / D) * L::LDO + i % D] = 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // delta = rowsum(do * o) in f32, and lse, for the warp's rows
  float lse_r[16], delta_r[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = r0 + i;
    const T* orow = o + (head + row0 + r) * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc = fmaf(to_float(do_s[r * L::LDT + d]), to_float(orow[d]), acc);
    delta_r[i] = warp_sum(acc);
    lse_r[i] = lse[head + row0 + r];
    if (lane == 0) delta[head + row0 + r] = delta_r[i];
  }

  auto load_tile = [&](int t, int stage) {
    const int key0 = sub_tile_pos(cols, t, subs, block, BT);
    T* dst = kv_s + stage * (L::stage / sizeof(T));
    async_rows<T, D, BT, NT>(dst, L::LDT, k + (head + key0) * D);
    async_rows<T, D, BT, NT>(dst + BT * L::LDT, L::LDT, v + (head + key0) * D);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const T* k_s = kv_s + (t % STAGES) * (L::stage / sizeof(T));
    const T* v_s = k_s + BT * L::LDT;
    const int key0 = sub_tile_pos(cols, t, subs, block, BT);

    warp_gemm<T, true, BT / 16, D>(q_s + r0 * L::LDT, L::LDT, k_s, L::LDT, s_w, L::LDS, false);
    warp_gemm<T, true, BT / 16, D>(do_s + r0 * L::LDT, L::LDT, v_s, L::LDT, dp_w, L::LDS, false);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int qpos = row0 + r0 + i;
#pragma unroll
      for (int u = 0; u < (BT + 31) / 32; ++u) {
        const int c = lane + 32 * u;
        if (c < BT) {
          const int key = key0 + c;
          const bool keep = (!causal || key <= qpos) && key_kept(kpm, b_off, key);
          const float p = keep ? expf(s_w[i * L::LDS + c] * scale - lse_r[i]) : 0.f;
          ds_w[i * L::LDP + c] = from_float<T>(p * (dp_w[i * L::LDS + c] - delta_r[i]) * scale);
        }
      }
    }
    __syncwarp();
    warp_gemm<T, false, D / 16, BT>(ds_w, L::LDP, k_s, L::LDT, dq_w, L::LDO, true);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    T* dst = dq + (head + row0 + r0 + i) * D;
    for (int d = lane; d < D; d += 32) dst[d] = from_float<T>(dq_w[i * L::LDO + d]);
  }
}

// ---------------------------------------------------------------- K6c

template <typename T, int D, int BT>
struct DkvSmem {
  static constexpr int LDT = D + Pad<T>::value;
  static constexpr int LDS = BT + 4;
  static constexpr int LDP = BT + Pad<T>::value;
  static constexpr int LDO = D + 4;
  static constexpr size_t fixed = 2 * align128(sizeof(T) * BT * LDT) + 2 * align128(sizeof(float) * BT * LDS) +
                                  align128(sizeof(T) * BT * LDP) + 2 * align128(sizeof(float) * BT * LDO);
  // one stage: the q and do sub-tiles, then lse and delta of their rows
  static constexpr size_t stage = align128(sizeof(T) * 2 * BT * LDT + sizeof(float) * 2 * BT);
  static constexpr int STAGES = fixed + 2 * stage <= kSmemLimit ? 2 : 1;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + align128(sizeof(T) * BT * LDT);
  static constexpr size_t st = v + align128(sizeof(T) * BT * LDT);
  static constexpr size_t dpt = st + align128(sizeof(float) * BT * LDS);
  static constexpr size_t pt = dpt + align128(sizeof(float) * BT * LDS);
  static constexpr size_t dk = pt + align128(sizeof(T) * BT * LDP);
  static constexpr size_t dv = dk + align128(sizeof(float) * BT * LDO);
  static constexpr size_t qdo = dv + align128(sizeof(float) * BT * LDO);
  static constexpr size_t bytes = qdo + STAGES * stage;
};

template <typename T, int D, int BT>
__global__ void __launch_bounds__(2 * BT)
    sparse_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                      const uint8_t* __restrict__ kpm, const int* __restrict__ col_ptr,
                      const int* __restrict__ col_idx, const int* __restrict__ col_order, T* __restrict__ dk,
                      T* __restrict__ dv, int B, int H, int S, int block, int causal, float scale) {
  using L = DkvSmem<T, D, BT>;
  constexpr int NT = 2 * BT;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem + L::k);
  T* v_s = reinterpret_cast<T*>(smem + L::v);
  float* st_s = reinterpret_cast<float*>(smem + L::st);  // s^T, then p^T, in f32
  float* dpt_s = reinterpret_cast<float*>(smem + L::dpt);
  T* pt_s = reinterpret_cast<T*>(smem + L::pt);  // p^T, then ds^T, in T
  float* dk_s = reinterpret_cast<float*>(smem + L::dk);
  float* dv_s = reinterpret_cast<float*>(smem + L::dv);
  unsigned char* qdo_s = smem + L::qdo;

  const int nb = S / block, subs = block / BT;
  const TileId id(col_order, B, nb, subs);
  const int key0 = id.blk * block + id.part * BT;
  const long long head = ((long long)id.b * H + id.h) * S;
  const long long b_off = (long long)id.b * S;
  const int hb = id.h * nb + id.blk;
  const int* rows = col_idx + col_ptr[hb];
  const int n_tiles = (col_ptr[hb + 1] - col_ptr[hb]) * subs;
  // with causal, the q sub-tiles wholly before the first key see none of it
  const int t0 = causal ? count_upto(rows, n_tiles, subs, block, BT, key0 - BT) : 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;  // this warp's 16 keys
  float* st_w = st_s + r0 * L::LDS;
  float* dpt_w = dpt_s + r0 * L::LDS;
  T* pt_w = pt_s + r0 * L::LDP;
  float* dk_w = dk_s + r0 * L::LDO;
  float* dv_w = dv_s + r0 * L::LDO;

  auto stage_ptr = [&](int stage) { return qdo_s + stage * L::stage; };
  auto load_tile = [&](int t, int stage) {
    const int qrow0 = sub_tile_pos(rows, t, subs, block, BT);
    T* q_dst = reinterpret_cast<T*>(stage_ptr(stage));
    T* do_dst = q_dst + BT * L::LDT;
    float* stat = reinterpret_cast<float*>(do_dst + BT * L::LDT);
    async_rows<T, D, BT, NT>(q_dst, L::LDT, q + (head + qrow0) * D);
    async_rows<T, D, BT, NT>(do_dst, L::LDT, dout + (head + qrow0) * D);
    async_rows<float, BT, 1, NT>(stat, BT, lse + head + qrow0);
    async_rows<float, BT, 1, NT>(stat + BT, BT, delta + head + qrow0);
  };

  async_rows<T, D, BT, NT>(k_s, L::LDT, k + (head + key0) * D);
  async_rows<T, D, BT, NT>(v_s, L::LDT, v + (head + key0) * D);
  cp_async_commit();
  for (int i = lane; i < 16 * D; i += 32) {
    dk_w[(i / D) * L::LDO + i % D] = 0.f;
    dv_w[(i / D) * L::LDO + i % D] = 0.f;
  }
  bool key_ok[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) key_ok[i] = key_kept(kpm, b_off, key0 + r0 + i);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (t0 + st < n_tiles) load_tile(t0 + st, st);
    cp_async_commit();
  }

  for (int t = t0; t < n_tiles; ++t) {
    const int j = t - t0;
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1, (j + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const T* q_s = reinterpret_cast<const T*>(stage_ptr(j % STAGES));
    const T* do_s = q_s + BT * L::LDT;
    const float* lse_s = reinterpret_cast<const float*>(do_s + BT * L::LDT);
    const float* delta_s = lse_s + BT;
    const int qrow0 = sub_tile_pos(rows, t, subs, block, BT);

    // s^T = K q^T and dp^T = V do^T for the warp's 16 keys
    warp_gemm<T, true, BT / 16, D>(k_s + r0 * L::LDT, L::LDT, q_s, L::LDT, st_w, L::LDS, false);
    warp_gemm<T, true, BT / 16, D>(v_s + r0 * L::LDT, L::LDT, do_s, L::LDT, dpt_w, L::LDS, false);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int key = key0 + r0 + i;
#pragma unroll
      for (int u = 0; u < (BT + 31) / 32; ++u) {
        const int c = lane + 32 * u;
        if (c < BT) {
          const bool keep = key_ok[i] && (!causal || key <= qrow0 + c);
          const float p = keep ? expf(st_w[i * L::LDS + c] * scale - lse_s[c]) : 0.f;
          st_w[i * L::LDS + c] = p;
          pt_w[i * L::LDP + c] = from_float<T>(p);
        }
      }
    }
    __syncwarp();
    warp_gemm<T, false, D / 16, BT>(pt_w, L::LDP, do_s, L::LDT, dv_w, L::LDO, true);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int u = 0; u < (BT + 31) / 32; ++u) {
        const int c = lane + 32 * u;
        if (c < BT)
          pt_w[i * L::LDP + c] =
              from_float<T>(st_w[i * L::LDS + c] * (dpt_w[i * L::LDS + c] - delta_s[c]) * scale);
      }
    }
    __syncwarp();
    warp_gemm<T, false, D / 16, BT>(pt_w, L::LDP, q_s, L::LDT, dk_w, L::LDO, true);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const long long off = (head + key0 + r0 + i) * D;
    for (int d = lane; d < D; d += 32) {
      dk[off + d] = from_float<T>(dk_w[i * L::LDO + d]);
      dv[off + d] = from_float<T>(dv_w[i * L::LDO + d]);
    }
  }
}

// ---------------------------------------------------------------- launch

// The shared-memory opt-in is a per-device attribute of each instantiation:
// set it on a device's first launch only.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    done[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

struct Dims {
  int B, H, S, D, block, causal;
  float scale;
  // one CTA per (batch, head, block, part of BT rows or keys)
  unsigned grid(int bt) const { return (unsigned)B * H * (S / block) * (block / bt); }
};

template <typename T, int D, int BT>
cudaError_t fwd(const void* q, const void* k, const void* v, const uint8_t* kpm, const int* row_ptr,
                const int* row_idx, const int* row_order, void* o, float* lse, const Dims& n, cudaStream_t st) {
  static std::atomic<bool> done[kMaxDevices];
  auto kernel = sparse_fwd_kernel<T, D, BT>;
  constexpr size_t bytes = FwdSmem<T, D, BT>::bytes;
  static_assert(bytes <= kSmemLimit, "K6a tile does not fit in shared memory");
  cudaError_t err = opt_in(kernel, bytes, done);
  if (err != cudaSuccess) return err;
  kernel<<<n.grid(BT), 2 * BT, bytes, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                            static_cast<const T*>(v), kpm, row_ptr, row_idx, row_order,
                                            static_cast<T*>(o), lse, n.B, n.H, n.S, n.block, n.causal, n.scale);
  return cudaGetLastError();
}

template <typename T, int D, int BT>
cudaError_t dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
               const uint8_t* kpm, const int* row_ptr, const int* row_idx, const int* row_order, void* dq_out,
               float* delta, const Dims& n, cudaStream_t st) {
  static std::atomic<bool> done[kMaxDevices];
  auto kernel = sparse_dq_kernel<T, D, BT>;
  constexpr size_t bytes = DqSmem<T, D, BT>::bytes;
  static_assert(bytes <= kSmemLimit, "K6b tile does not fit in shared memory");
  cudaError_t err = opt_in(kernel, bytes, done);
  if (err != cudaSuccess) return err;
  kernel<<<n.grid(BT), 2 * BT, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, kpm, row_ptr, row_idx, row_order, static_cast<T*>(dq_out), delta, n.B, n.H,
      n.S, n.block, n.causal, n.scale);
  return cudaGetLastError();
}

template <typename T, int D, int BT>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
                const uint8_t* kpm, const int* col_ptr, const int* col_idx, const int* col_order, void* dk_out,
                void* dv_out, const Dims& n, cudaStream_t st) {
  static std::atomic<bool> done[kMaxDevices];
  auto kernel = sparse_dkv_kernel<T, D, BT>;
  constexpr size_t bytes = DkvSmem<T, D, BT>::bytes;
  static_assert(bytes <= kSmemLimit, "K6c tile does not fit in shared memory");
  cudaError_t err = opt_in(kernel, bytes, done);
  if (err != cudaSuccess) return err;
  kernel<<<n.grid(BT), 2 * BT, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout), lse,
      delta, kpm, col_ptr, col_idx, col_order, static_cast<T*>(dk_out), static_cast<T*>(dv_out), n.B, n.H, n.S,
      n.block, n.causal, n.scale);
  return cudaGetLastError();
}

// The instantiation for (dtype, D, block): f(T*, D, BT) with tag arguments.
// dtype 0 = float32, 1 = bfloat16; head dims 64 and 128; blocks 16, 32, 64
// and 128.  The tile is BT = min(block, 64) rows, 32 for float32 at head dim
// 128 (whose 64-row K6c tile would not fit in shared memory).
template <typename T, int D, typename F>
int with_tile(int block, F&& f) {
  using DC = std::integral_constant<int, D>;
  T* tag = nullptr;
  if (block == 16) return f(tag, DC{}, std::integral_constant<int, 16>{});
  if constexpr (sizeof(T) == 4 && D == 128) {
    return f(tag, DC{}, std::integral_constant<int, 32>{});
  } else {
    if (block == 32) return f(tag, DC{}, std::integral_constant<int, 32>{});
    return f(tag, DC{}, std::integral_constant<int, 64>{});
  }
}

template <typename F>
int dispatch(int dtype, const Dims& n, F&& f) {
  if (n.block != 16 && n.block != 32 && n.block != 64 && n.block != 128) return (int)cudaErrorInvalidValue;
  if (n.S % n.block) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && n.D == 64) return with_tile<__nv_bfloat16, 64>(n.block, f);
  if (dtype == 1 && n.D == 128) return with_tile<__nv_bfloat16, 128>(n.block, f);
  if (dtype == 0 && n.D == 64) return with_tile<float, 64>(n.block, f);
  if (dtype == 0 && n.D == 128) return with_tile<float, 128>(n.block, f);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success).  kpm may be null.
int ds_sparse_attn_fwd(const void* q, const void* k, const void* v, const void* kpm, const void* row_ptr,
                       const void* row_idx, const void* row_order, void* o, void* lse, int B, int H, int S, int D,
                       int block, int causal, float scale, int dtype, void* stream) {
  const Dims n{B, H, S, D, block, causal, scale};
  return dispatch(dtype, n, [&](auto tag, auto d, auto bt) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return (int)fwd<T, decltype(d)::value, decltype(bt)::value>(
        q, k, v, static_cast<const uint8_t*>(kpm), static_cast<const int*>(row_ptr), static_cast<const int*>(row_idx),
        static_cast<const int*>(row_order), o, static_cast<float*>(lse), n, static_cast<cudaStream_t>(stream));
  });
}

int ds_sparse_attn_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
                      const void* kpm, const void* row_ptr, const void* row_idx, const void* row_order, void* dq_out,
                      void* delta, int B, int H, int S, int D, int block, int causal, float scale, int dtype,
                      void* stream) {
  const Dims n{B, H, S, D, block, causal, scale};
  return dispatch(dtype, n, [&](auto tag, auto d, auto bt) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return (int)dq<T, decltype(d)::value, decltype(bt)::value>(
        q, k, v, o, dout, static_cast<const float*>(lse), static_cast<const uint8_t*>(kpm),
        static_cast<const int*>(row_ptr), static_cast<const int*>(row_idx), static_cast<const int*>(row_order),
        dq_out, static_cast<float*>(delta), n, static_cast<cudaStream_t>(stream));
  });
}

int ds_sparse_attn_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                       const void* delta, const void* kpm, const void* col_ptr, const void* col_idx,
                       const void* col_order, void* dk_out, void* dv_out, int B, int H, int S, int D, int block,
                       int causal, float scale, int dtype, void* stream) {
  const Dims n{B, H, S, D, block, causal, scale};
  return dispatch(dtype, n, [&](auto tag, auto d, auto bt) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return (int)dkv<T, decltype(d)::value, decltype(bt)::value>(
        q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const uint8_t*>(kpm), static_cast<const int*>(col_ptr), static_cast<const int*>(col_idx),
        static_cast<const int*>(col_order), dk_out, dv_out, n, static_cast<cudaStream_t>(stream));
  });
}

const char* ds_sparse_attn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
