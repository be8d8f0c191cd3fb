// K6a, K6b, K6c: block-sparse attention forward and backward for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels of
// deepspeed_tpu/ops/sparse_attention/pallas_kernel.py:
//   K6a sparse_fwd_kernel <- _kernel     (:35),  driven by _fwd_impl (:257)
//       (bf16: sparse_fwd_kernel_tc)
//   K6b sparse_dq_kernel  <- _dq_kernel  (:125), driven by _bwd_impl (:307)
//       (bf16: sparse_dq_kernel_tc)
//   K6c sparse_dkv_kernel <- _dkv_kernel (:152), driven by _bwd_impl (:307)
//       (bf16: sparse_dkv_kernel_tc)
//
// Layout (all contiguous; ops/sparse_attention/kernel.py checks shapes,
// dtypes and alignment):
//   q, k, v, o, do, dq, dk, dv   [B, H, S, D]      lse, delta   [B, H, S] f32
//   kpm (optional)               [B, S] uint8, 1 = the key may be attended
//   row_ptr [H·nb + 1], row_idx: the admitted kv blocks of each (head, q
//   block), ascending (CSR); col_ptr, col_idx: the admitted q blocks of each
//   (head, kv block), ascending; row_order, col_order [H·nb]: (head, block)
//   ids by descending count, the launch order.  nb = S / block.
//   row_groups [G_r, W_r]: up to max(1, 64 / block) (head, q block) ids of
//   one head whose admitted lists are identical, ascending, -1 after the
//   last; col_groups [G_c, W_c] the same over the transposed CSR;
//   row_group_order, col_group_order: the groups by descending list length.
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
// BigBird layout (density 0.023) by HBM bytes.  At block 16 a tile is
// 16×16×64, so what a CTA loads per product, not the products, sets the
// time: each row block that reads its own copy of its list's K/V sub-tiles
// reads ~4.5 GB of L2 a call at the fixed layout (PERF.md).
//
// Design.  The TPU kernels run a sequential grid (B·H, nb, L) whose last axis
// pads every row to the widest row's L and carries the softmax state in VMEM
// across grid steps.  Here:
//   * A CTA owns a part of one (batch, head) and loops over its own list of
//     admitted blocks, cut into sub-tiles, and writes its output once.  No
//     padding tile is read, no atomics: results are deterministic.
//   * With causal, the sub-tiles wholly after the tile's last query (K6a,
//     K6b) or wholly before its first key (K6c) are masked everywhere; the
//     lists are ascending, so they form a suffix (prefix), found by binary
//     search and never loaded.
//   * CTAs are launched heaviest first, from the order tables: the rows and
//     columns of global blocks, which admit every block (L = nb), start
//     first instead of trailing the grid.
//   * bf16 runs on the tensor-core tile of csrc/mma_tile.cuh, mma.sync
//     m16n8k16 with every operand read by ldmatrix, as the flash kernels of
//     csrc/flash_attention.cu do.  Each warp owns 16 rows (queries, or keys
//     in K6c) of every product, so a row's softmax or gradient needs only
//     its lane quad; a thread masks its own scores by the causal position
//     and kpm; p and ds go from the C fragments, rounded to bf16, straight
//     into the A fragments of the next product; only the cp.async rings are
//     shared memory.  A warp whose rows all precede a sub-tile (K6a, K6b),
//     or whose keys all follow it (K6c), skips it; a sub-tile that every
//     row of the warp sees in full with no kpm skips the mask.
//   * bf16 K6a (sparse_fwd_kernel_tc): one CTA per query tile of BT =
//     min(block, 64) rows (BT / 16 warps); K1's register softmax (base 2,
//     S, m, l and O in registers) over sub-tiles of BT keys through a
//     3-stage ring, with the Q sub-tile staged in the ring's last stage.  At
//     block 16 a one-warp CTA holds 13.5 KB, 15 CTAs an SM.
//   * bf16 K6b (sparse_dq_kernel_tc), K2a's design over the CSR: one CTA per
//     row group, the up to 64 // block row blocks of one head that admit the
//     same list, so each K/V sub-tile of the list is loaded once for all of
//     them (at the fixed layout's block 16: 1024 CTAs a batch row, not 4096,
//     and a quarter of the loads).  The CTA has ROWS = 16, 32 or 64 rows
//     (the widest group's members, rounded up to a power of two) and ROWS /
//     16 warps; a warp owns 16 rows of one member.  Q and dO are staged in
//     the ring's last stage and kept as A fragments; delta and lse (base 2)
//     of the thread's two rows in registers; per 16 keys S = Q·Kᵀ,
//     dP = dO·Vᵀ, dS = P(dP − delta)·scale, dQ += dS·K, all in registers.
//     A ring stage holds ROWS keys, ROWS / 16 chunks of 16 keys of the
//     list; the causal cut is the group's last row, and each warp stops at
//     its own last row.  dq is written once.
//   * bf16 K6c (sparse_dkv_kernel_tc), K2b's design over the transposed
//     CSR: one CTA per column group (up to 64 keys of one head's kv blocks
//     that the same q blocks admit); the K and V rows are staged once and
//     each warp keeps dK and dV of its 16 keys in f32 registers; Q, dO, lse
//     and delta of QT = 32 (16 at ROWS 16) queries of the common list come
//     through a 3-stage ring; per 16 queries of a stage Sᵀ = K·Qᵀ,
//     Pᵀ = exp2(Sᵀ·scale_log2 − lse₂), dV += bf16(Pᵀ)·dO, dPᵀ = V·dOᵀ,
//     dSᵀ = Pᵀ(dPᵀ − delta)·scale rounded to bf16, dK += dSᵀ·Q (16 queries,
//     not 32, at a time keep D 64 at 128 registers with no spill: four CTAs
//     of 4 warps an SM).  The causal prefix is cut at the group's first key
//     and per warp, per 16 queries, at its own.
//   * float32 K6a, K6b and K6c run f32 FMA on the CUDA cores, with scores
//     and accumulators passing through shared memory; one CTA per tile of
//     BT rows (keys) of one block, BT / 16 warps.
//   * delta is computed once, by K6b, and read by K6c on the same stream
//     (the TPU K6c recomputes it for every tile).
// Later work: split a global row (column) over several CTAs; the row group
// table for K6a (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "mma_tile.cuh"

namespace {

using namespace ds_tile;

constexpr int kMaxDevices = 64;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a block may use on sm_90
constexpr float kMask = -0.7f * 3.402823466e+38f;
constexpr float kEmptyLse = 3e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
struct Pad {  // elements that pad a shared row by 16 bytes
  static constexpr int value = 16 / sizeof(T);
};

// the float32 kernels' element conversions (they are instantiated for float only)
__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
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

// Copy ROWS contiguous rows of COLS elements (row stride COLS in global) into
// shared rows of ld elements, by all NT threads of the block.
template <typename T, int COLS, int ROWS, int NT>
__device__ __forceinline__ void async_rows(T* dst, int ld, const T* src) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = COLS / VEC;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NT) {
    const int r = i / CHUNKS, ch = i % CHUNKS;
    cp_async16(dst + r * ld + ch * VEC, src + (long long)r * COLS + ch * VEC, true);
  }
}

// One warp: C[16 x 16*NF] (+)= A[16 x KD] * B[KD x 16*NF] in f32 on the CUDA
// cores (the float32 kernels).  A is row-major (lda); B is row-major (ldb)
// or, with B_COL, given as its transpose [16*NF x KD] row-major (ldb); C is
// row-major (ldc).  All in shared memory.  The C tile is read (when
// accumulating) and written by this warp only.
template <typename T, bool B_COL, int NF, int KD>
struct WarpGemm;

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

// float32 K6a (the bf16 one is sparse_fwd_kernel_tc below)

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

// shared memory and occupancy of the bf16 K6a: a ring of K/V sub-tiles
// only (the Q sub-tile is staged in its last stage before the ring reaches
// it); at most 128 registers a thread at D 64 and 255 at D 128
template <int D, int BT>
struct FwdTc {
  static constexpr int STAGES = 3;
  static constexpr int LD = D + 8;          // bf16 rows padded by 16 bytes
  static constexpr int STAGE = 2 * BT * LD;  // K rows, then V rows
  static constexpr size_t bytes = sizeof(bf16) * STAGES * STAGE;
  static constexpr int MIN_BLOCKS = (D == 64 ? 512 : 256) / (2 * BT);
};

// bf16 K6a on the tensor cores (see the file's head): the CTAs, the
// sub-tiles and the causal cut of sparse_fwd_kernel; per warp, 16 query rows
// with S, the softmax statistics and O in registers.
template <int D, int BT>
__global__ void __launch_bounds__(2 * BT, FwdTc<D, BT>::MIN_BLOCKS)
    sparse_fwd_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const uint8_t* __restrict__ kpm, const int* __restrict__ row_ptr,
                         const int* __restrict__ row_idx, const int* __restrict__ row_order, bf16* __restrict__ o,
                         float* __restrict__ lse, int B, int H, int S, int block, int causal, float scale_log2) {
  using L = FwdTc<D, BT>;
  constexpr int NT = 2 * BT;      // BT / 16 warps
  constexpr int STAGES = L::STAGES;
  constexpr int NB = BT / 8;      // S blocks of 8 keys
  constexpr int KD = D / 16;      // depth slices of Q·Kᵀ
  constexpr int DB = D / 8;       // column blocks of O
  constexpr int LD = L::LD;
  constexpr int STAGE = L::STAGE;
  constexpr int CH = D / 8;       // 16-byte chunks of a row
  constexpr int ROW_STEP = NT / CH;
  static_assert(BT % ROW_STEP == 0 && NB * 4 <= 32, "a sub-tile's rows split over the CTA; keep bits fit 32");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][K, V][BT][LD]
  bf16* q_s = ring + (STAGES - 1) * STAGE;          // [BT][LD], until the ring reaches its last stage

  const int nb = S / block, subs = block / BT;
  const TileId id(row_order, B, nb, subs);
  const int row0 = id.blk * block + id.part * BT;
  const long long head = ((long long)id.b * H + id.h) * S;  // row offset of (b, h)
  const long long b_off = (long long)id.b * S;
  const int hb = id.h * nb + id.blk;
  const int* cols = row_idx + row_ptr[hb];
  int n_tiles = (row_ptr[hb + 1] - row_ptr[hb]) * subs;
  if (causal) n_tiles = count_upto(cols, n_tiles, subs, block, BT, row0 + BT - 1);

  // a thread copies 16-byte chunk my_ch of rows j0, j0 + ROW_STEP, ... of a
  // sub-tile
  const int my_ch = threadIdx.x % CH, j0 = threadIdx.x / CH;
  const long long my_off = (head + j0) * D + my_ch * 8;
  bf16* dst0 = ring + j0 * LD + my_ch * 8;
#pragma unroll
  for (int j = 0; j < BT / ROW_STEP; ++j)
    cp_async16(q_s + (j0 + j * ROW_STEP) * LD + my_ch * 8, q + my_off + (long long)(row0 + j * ROW_STEP) * D, true);
  cp_async_commit();
  auto load_tile = [&](int t, int stage) {
    const long long off = my_off + (long long)sub_tile_pos(cols, t, subs, block, BT) * D;
    bf16* dst = dst0 + stage * STAGE;
#pragma unroll
    for (int j = 0; j < BT / ROW_STEP; ++j) {
      cp_async16(dst + j * ROW_STEP * LD, k + off + j * ROW_STEP * D, true);
      cp_async16(dst + (BT + j * ROW_STEP) * LD, v + off + j * ROW_STEP * D, true);
    }
    cp_async_commit();
  };
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) {
      load_tile(st, st);
    } else {
      cp_async_commit();  // empty groups keep the ring's wait counts
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane >> 2, tig = lane & 3;
  const int wr0 = row0 + warp * 16;                 // the warp's first row
  const int qpos_a = wr0 + group, qpos_b = qpos_a + 8;  // this thread's two rows

  cp_async_wait<STAGES - 1>();  // the Q sub-tile
  __syncthreads();
  unsigned qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_a_frag(qa[kk], q_s + warp * 16 * LD + kk * 16, LD, lane);

  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // m in base 2
  float acc[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // sub-tile t landed
    __syncthreads();              // and every warp is done with sub-tile t - 1 (and the Q sub-tile)
    if (t + STAGES - 1 < n_tiles) {
      load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    } else {
      cp_async_commit();
    }
    const int key0 = sub_tile_pos(cols, t, subs, block, BT);
    if (causal && key0 > wr0 + 15) continue;  // every key after the warp's rows
    const bf16* k_s = ring + (t % STAGES) * STAGE;
    const bf16* v_s = k_s + BT * LD;

    float s[NB][4];
#pragma unroll
    for (int i = 0; i < NB; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
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

    // bit 4·i + e: score e of block i is kept (causal position and kpm); a
    // tile with no kpm that every row of the warp sees in full keeps all
    unsigned keep = ~0u;
    if (kpm != nullptr || (causal && key0 + BT - 1 > wr0)) {
      keep = 0u;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int key = key0 + i * 8 + tig * 2;
        const bool k0 = key_kept(kpm, b_off, key), k1 = key_kept(kpm, b_off, key + 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = e < 2 ? qpos_a : qpos_b;
          if ((e & 1 ? k1 : k0) && (!causal || key + (e & 1) <= qpos)) keep |= 1u << (4 * i + e);
        }
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = (keep >> (4 * i + e) & 1u) ? s[i][e] * scale_log2 : kMask;
      mx_a = fmaxf(mx_a, fmaxf(s[i][0], s[i][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[i][2], s[i][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a);  // finite: kMask is finite
    const float mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = exp2f(m_a - mn_a);
    const float alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= alpha_a;
    l_b *= alpha_b;
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      acc[db][0] *= alpha_a;
      acc[db][1] *= alpha_a;
      acc[db][2] *= alpha_b;
      acc[db][3] *= alpha_b;
    }

    // p = exp2(s − m) where kept, else 0; l sums it in f32, P·V takes it
    // rounded to bf16 from the A fragments (blocks 2j and 2j + 1: 16 keys)
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) {
      unsigned pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 2 * j + half;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = (keep >> (4 * i + e) & 1u) ? exp2f(s[i][e] - (e < 2 ? mn_a : mn_b)) : 0.f;
        l_a += p[0] + p[1];
        l_b += p[2] + p[3];
        pa[half * 2] = pack_bf16(p[0], p[1]);
        pa[half * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int dp = 0; dp < DB / 2; ++dp) {
        unsigned vf[4];
        load_v_frags(vf, v_s + j * 16 * LD + dp * 16, LD, lane);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // a row's l: the sum over its lane quad.  l = 0 (no admitted key, or all
  // masked): o = 0 and lse = 3e38, so its backward is exactly 0
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pos = half ? qpos_b : qpos_a;
    const float l = half ? l_b : l_a;
    const bool live = l > 0.f;
    const float denom = fmaxf(l, 1e-30f);
    const float inv = live ? 1.f / denom : 0.f;
    bf16* dst = o + (head + pos) * D + tig * 2;
#pragma unroll
    for (int db = 0; db < DB; ++db)
      *reinterpret_cast<__nv_bfloat162*>(dst + db * 8) =
          __floats2bfloat162_rn(acc[db][half * 2] * inv, acc[db][half * 2 + 1] * inv);
    if (tig == 0) lse[head + pos] = live ? (half ? m_b : m_a) * kLn2 + logf(denom) : kEmptyLse;
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

// ---------------------------------------------------------------- bf16 K6b, K6c

// The group a bf16 backward CTA owns, decoded from blockIdx.x: batch
// fastest, then the part of the block (block / ROWS parts where a block is
// wider than the CTA), then the group in the launch order.  Row r of the CTA
// is row r % rpm of member r / rpm (rpm = min(block, ROWS) rows a member).
template <int ROWS>
struct GroupTile {
  int b, h, hb0, rpm, part, width;
  const int* members;  // width entries, ascending, -1 after the last
  __device__ GroupTile(const int* groups, const int* order, int B, int nb, int block, int w) : width(w) {
    rpm = block < ROWS ? block : ROWS;
    const int parts = block / rpm;
    int id = blockIdx.x;
    b = id % B;
    id /= B;
    part = id % parts;
    id /= parts;
    members = groups + (long long)order[id] * w;
    hb0 = members[0];
    h = hb0 / nb;
  }
  // token position of row r of the CTA, -1 where the group has no such member
  __device__ int pos(int r, int nb, int block) const {
    const int m = r / rpm;
    const int hb = m < width ? members[m] : -1;
    return hb < 0 ? -1 : (hb % nb) * block + part * rpm + r % rpm;
  }
};

// shared memory of the bf16 K6c: the CTA's K and V rows, then a ring of
// {Q [QT][LD], dO [QT][LD], lse [QT], delta [QT]}; at most 128 registers a
// thread at D 64 and 255 at D 128 (FwdTc's MIN_BLOCKS)
template <int D, int ROWS>
struct DkvTc {
  static constexpr int STAGES = 3;
  static constexpr int QT = ROWS == 16 ? 16 : 32;  // queries of a ring stage
  static constexpr int LD = D + 8;
  static constexpr size_t kv_bytes = sizeof(bf16) * 2 * ROWS * LD;
  static constexpr size_t stage_bytes = sizeof(bf16) * 2 * QT * LD + sizeof(float) * 2 * QT;
  static constexpr size_t bytes = kv_bytes + STAGES * stage_bytes;
};

// bf16 K6b on the tensor cores (see the file's head): one CTA per row group;
// K6a's ring of ROWS keys a stage (ROWS / 16 chunks of 16 keys of the
// group's list), Q and dO staged in its last stage.
template <int D, int ROWS>
__global__ void __launch_bounds__(2 * ROWS, FwdTc<D, ROWS>::MIN_BLOCKS)
    sparse_dq_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const uint8_t* __restrict__ kpm, const int* __restrict__ row_ptr,
                        const int* __restrict__ row_idx, const int* __restrict__ groups,
                        const int* __restrict__ group_order, bf16* __restrict__ dq, float* __restrict__ delta,
                        int B, int H, int S, int block, int width, int causal, float scale, float scale_log2) {
  using L = FwdTc<D, ROWS>;
  constexpr int NT = 2 * ROWS;   // ROWS / 16 warps
  constexpr int STAGES = L::STAGES;
  constexpr int KT = ROWS;       // keys of a ring stage
  constexpr int KC = KT / 16;    // its chunks of 16 keys
  constexpr int KD = D / 16;     // depth slices of Q·Kᵀ and dO·Vᵀ
  constexpr int DB = D / 8;      // column blocks of dQ
  constexpr int LD = L::LD;
  constexpr int STAGE = L::STAGE;
  constexpr int CH = D / 8;      // 16-byte chunks of a row
  constexpr int ROW_STEP = NT / CH;
  static_assert(16 % ROW_STEP == 0 && 2 * ROWS * LD <= STAGE, "a chunk's rows split over the CTA; Q, dO fit a stage");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][K, V][KT][LD]
  bf16* q_s = ring + (STAGES - 1) * STAGE;          // Q [ROWS][LD], then dO, until the ring reaches its last stage
  bf16* do_s = q_s + ROWS * LD;

  const int nb = S / block, subs = block / 16;  // chunks of 16 keys a block
  const GroupTile<ROWS> g(groups, group_order, B, nb, block, width);
  const long long head = ((long long)g.b * H + g.h) * S;  // row offset of (b, h)
  const long long b_off = (long long)g.b * S;
  const int* cols = row_idx + row_ptr[g.hb0];
  int n_chunks = (row_ptr[g.hb0 + 1] - row_ptr[g.hb0]) * subs;
  if (causal) {
    int last = 0;  // the group's last row: its last member's (members ascend)
    for (int m = 0; m < ROWS / g.rpm; ++m) {
      const int p = g.pos(m * g.rpm + g.rpm - 1, nb, block);
      if (p >= 0) last = p;
    }
    n_chunks = count_upto(cols, n_chunks, subs, block, 16, last);
  }
  const int n_tiles = (n_chunks + KC - 1) / KC;

  // a thread copies 16-byte chunk my_ch of rows j0, j0 + ROW_STEP, ...: of
  // the CTA's Q and dO rows, and of each stage's K and V rows (row r of a
  // stage is key r % 16 of its chunk r / 16)
  const int my_ch = threadIdx.x % CH, j0 = threadIdx.x / CH;
#pragma unroll
  for (int j = 0; j < ROWS / ROW_STEP; ++j) {
    const int r = j0 + j * ROW_STEP;
    const int p = g.pos(r, nb, block);
    const long long off = p < 0 ? 0 : (head + p) * D + my_ch * 8;
    cp_async16(q_s + r * LD + my_ch * 8, q + off, p >= 0);
    cp_async16(do_s + r * LD + my_ch * 8, dout + off, p >= 0);
  }
  cp_async_commit();
  auto load_tile = [&](int t, int stage) {
    bf16* dst = ring + stage * STAGE + my_ch * 8;
#pragma unroll
    for (int j = 0; j < KT / ROW_STEP; ++j) {
      const int r = j0 + j * ROW_STEP;
      const int c = t * KC + (r >> 4);
      const bool ok = c < n_chunks;
      const long long off = ok ? (head + sub_tile_pos(cols, c, subs, block, 16) + (r & 15)) * D + my_ch * 8 : 0;
      cp_async16(dst + r * LD, k + off, ok);
      cp_async16(dst + (KT + r) * LD, v + off, ok);
    }
    cp_async_commit();
  };
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) {
      load_tile(st, st);
    } else {
      cp_async_commit();  // empty groups keep the ring's wait counts
    }
  }

  // the warp's 16 rows are consecutive positions of one member, or none
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16;
  const int wpos = g.pos(r0, nb, block);
  const bool warp_rows = wpos >= 0;
  const int qpos_a = wpos + group, qpos_b = qpos_a + 8;  // this thread's two rows

  cp_async_wait<STAGES - 1>();  // Q and dO
  __syncthreads();
  unsigned qa[KD][4], da[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    load_a_frag(qa[kk], q_s + r0 * LD + kk * 16, LD, lane);
    load_a_frag(da[kk], do_s + r0 * LD + kk * 16, LD, lane);
  }

  // delta = rowsum(dO·O) in f32 for the thread's two rows, as K2a: the row's
  // lane quad reads O once and sums over the quad; -lse in base 2 beside it
  // (-inf for an empty row's 3e38: p = 0)
  float delta_r[2] = {0.f, 0.f}, nlse2[2] = {-INFINITY, -INFINITY};
  if (warp_rows) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + group + 8 * half;
      const long long row = head + (half ? qpos_b : qpos_a);
      const bf16* orow = o + row * D;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < CH / 4; ++c) {
        const int ch = tig + 4 * c;
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + ch * 8);
        const uint4 dv = *reinterpret_cast<const uint4*>(do_s + r * LD + ch * 8);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
          acc = fmaf(df.x, of.x, acc);
          acc = fmaf(df.y, of.y, acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      delta_r[half] = acc;
      if (tig == 0) delta[row] = acc;
      nlse2[half] = -kLog2e * lse[row];
    }
  }

  float acc[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t landed
    __syncthreads();              // and every warp is done with tile t - 1 (and Q, dO)
    if (t + STAGES - 1 < n_tiles) {
      load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    } else {
      cp_async_commit();
    }
    if (!warp_rows) continue;
    const bf16* k_s = ring + (t % STAGES) * STAGE;
    const bf16* v_s = k_s + KT * LD;
    const int n_here = min(KC, n_chunks - t * KC);
    // 16 keys at a time: S and dP of the warp's rows, dS, then dQ += dS·K.
    // D 64 keeps the loop rolled, as K2a (unrolled it was 3% slower, PERF.md)
#pragma unroll(D == 64 ? 1 : KC)
    for (int j = 0; j < KC; ++j) {
      if (j >= n_here) break;
      const int key0 = sub_tile_pos(cols, t * KC + j, subs, block, 16);
      if (causal && key0 > wpos + 15) break;  // this and every later chunk after the warp's rows
      const bool full = kpm == nullptr && (!causal || key0 + 15 <= wpos);
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nb2 = 0; nb2 < 2; ++nb2)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb2][e] = dp[nb2][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned kf[4], vf[4];
        load_k_frags(kf, k_s + j * 16 * LD + kk * 16, LD, lane);
        load_k_frags(vf, v_s + j * 16 * LD + kk * 16, LD, lane);
        mma_bf16(s[0], qa[kk], kf[0], kf[1]);
        mma_bf16(s[1], qa[kk], kf[2], kf[3]);
        mma_bf16(dp[0], da[kk], vf[0], vf[1]);
        mma_bf16(dp[1], da[kk], vf[2], vf[3]);
      }
      // dS = P(dP − delta)·scale with P = exp2(S·scale_log2 − lse₂), 0 where
      // masked, rounded to bf16 into the A fragment of dS·K
      unsigned dsa[4];
#pragma unroll
      for (int nb2 = 0; nb2 < 2; ++nb2) {
        const int key = key0 + nb2 * 8 + tig * 2;
        const bool k0 = full || key_kept(kpm, b_off, key), k1 = full || key_kept(kpm, b_off, key + 1);
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e >> 1;  // 0: row a, 1: row b
          const bool ok = full || ((e & 1 ? k1 : k0) && (!causal || key + (e & 1) <= (row ? qpos_b : qpos_a)));
          const float p = ok ? exp2f(fmaf(s[nb2][e], scale_log2, nlse2[row])) : 0.f;
          x[e] = p * (dp[nb2][e] - delta_r[row]) * scale;
        }
        dsa[nb2 * 2] = pack_bf16(x[0], x[1]);
        dsa[nb2 * 2 + 1] = pack_bf16(x[2], x[3]);
      }
#pragma unroll
      for (int dp2 = 0; dp2 < DB / 2; ++dp2) {
        unsigned kf[4];
        load_v_frags(kf, k_s + j * 16 * LD + dp2 * 16, LD, lane);
        mma_bf16(acc[2 * dp2], dsa, kf[0], kf[1]);
        mma_bf16(acc[2 * dp2 + 1], dsa, kf[2], kf[3]);
      }
    }
  }
  cp_async_wait<0>();

  if (!warp_rows) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    bf16* dst = dq + (head + (half ? qpos_b : qpos_a)) * D + tig * 2;
#pragma unroll
    for (int db = 0; db < DB; ++db)
      *reinterpret_cast<__nv_bfloat162*>(dst + db * 8) =
          __floats2bfloat162_rn(acc[db][half * 2], acc[db][half * 2 + 1]);
  }
}

// bf16 K6c on the tensor cores (see the file's head): one CTA per column
// group; K2b's products per warp of 16 keys over the group's common list of
// q blocks, QT queries (QT / 16 chunks of 16) a ring stage.
template <int D, int ROWS>
__global__ void __launch_bounds__(2 * ROWS, FwdTc<D, ROWS>::MIN_BLOCKS)
    sparse_dkv_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, const uint8_t* __restrict__ kpm,
                         const int* __restrict__ col_ptr, const int* __restrict__ col_idx,
                         const int* __restrict__ groups, const int* __restrict__ group_order, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int B, int H, int S, int block, int width, int causal, float scale,
                         float scale_log2) {
  using L = DkvTc<D, ROWS>;
  constexpr int NT = 2 * ROWS;   // ROWS / 16 warps
  constexpr int STAGES = L::STAGES;
  constexpr int QT = L::QT;
  constexpr int QC = QT / 16;    // chunks of 16 queries a stage
  constexpr int KD = D / 16;     // depth slices of K·Qᵀ and V·dOᵀ
  constexpr int DB = D / 8;      // column blocks of dK, dV
  constexpr int LD = L::LD;
  constexpr int CH = D / 8;      // 16-byte chunks of a row
  constexpr int ROW_STEP = NT / CH;
  static_assert(16 % ROW_STEP == 0 && 2 * QT <= NT, "a chunk's rows and a stage's statistics split over the CTA");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]
  bf16* v_s = k_s + ROWS * LD;                    // [ROWS][LD]
  unsigned char* ring = smem_raw + L::kv_bytes;   // [STAGES] of {Q [QT][LD], dO [QT][LD], lse [QT], delta [QT]}

  const int nb = S / block, subs = block / 16;  // chunks of 16 queries a block
  const GroupTile<ROWS> g(groups, group_order, B, nb, block, width);
  const long long head = ((long long)g.b * H + g.h) * S;
  const long long b_off = (long long)g.b * S;
  const int* rows = col_idx + col_ptr[g.hb0];
  const int n_chunks = (col_ptr[g.hb0 + 1] - col_ptr[g.hb0]) * subs;
  // with causal, the q chunks wholly before the group's first key see none of it
  const int c0 = causal ? count_upto(rows, n_chunks, subs, block, 16, g.pos(0, nb, block) - 16) : 0;
  const int n_it = (n_chunks - c0 + QC - 1) / QC;

  // K, V rows of the CTA's keys (zeros where the group has no member)
  const int my_ch = threadIdx.x % CH, j0 = threadIdx.x / CH;
#pragma unroll
  for (int j = 0; j < ROWS / ROW_STEP; ++j) {
    const int r = j0 + j * ROW_STEP;
    const int p = g.pos(r, nb, block);
    const long long off = p < 0 ? 0 : (head + p) * D + my_ch * 8;
    cp_async16(k_s + r * LD + my_ch * 8, k + off, p >= 0);
    cp_async16(v_s + r * LD + my_ch * 8, v + off, p >= 0);
  }
  cp_async_commit();

  // stage it holds chunks c0 + it·QC ...: a thread copies 16-byte chunk
  // my_ch of rows j0, j0 + ROW_STEP, ... of Q and dO, and thread i < 2·QT
  // one lse (i < QT) or delta value
  const float* stat_src = threadIdx.x < QT ? lse : delta;
  auto load_q_tile = [&](int it, int stage) {
    unsigned char* st = ring + stage * L::stage_bytes;
    bf16* q_dst = reinterpret_cast<bf16*>(st) + my_ch * 8;
    bf16* do_dst = q_dst + QT * LD;
#pragma unroll
    for (int j = 0; j < QT / ROW_STEP; ++j) {
      const int r = j0 + j * ROW_STEP;
      const int c = c0 + it * QC + (r >> 4);
      const bool ok = c < n_chunks;
      const long long off = ok ? (head + sub_tile_pos(rows, c, subs, block, 16) + (r & 15)) * D + my_ch * 8 : 0;
      cp_async16(q_dst + r * LD, q + off, ok);
      cp_async16(do_dst + r * LD, dout + off, ok);
    }
    if (threadIdx.x < 2 * QT) {
      const int i = threadIdx.x % QT;
      const int c = c0 + it * QC + (i >> 4);
      const bool ok = c < n_chunks;
      const long long off = ok ? head + sub_tile_pos(rows, c, subs, block, 16) + (i & 15) : 0;
      cp_async4(reinterpret_cast<float*>(st + sizeof(bf16) * 2 * QT * LD) + threadIdx.x, stat_src + off, ok);
    }
    cp_async_commit();
  };
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < n_it) {
      load_q_tile(it, it);
    } else {
      cp_async_commit();  // empty groups keep the ring's wait counts
    }
  }

  float dk_acc[DB][4], dv_acc[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[db][e] = dv_acc[db][e] = 0.f;

  // the warp's 16 keys are consecutive positions of one member, or none
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane >> 2, tig = lane & 3;
  const int kw0 = g.pos(warp * 16, nb, block);
  const bool warp_keys = kw0 >= 0;
  const int key_a = kw0 + group, key_b = key_a + 8;  // this thread's two keys
  const bool kept_a = warp_keys && key_kept(kpm, b_off, key_a);
  const bool kept_b = warp_keys && key_kept(kpm, b_off, key_b);

  cp_async_wait<STAGES - 1>();  // K and V
  __syncthreads();
  const bf16* k_w = k_s + warp * 16 * LD;  // the warp's K and V rows, A operands of K·Qᵀ and V·dOᵀ
  const bf16* v_w = v_s + warp * 16 * LD;
  // c = (the warp's K or V rows at a_rows) · (16 rows at r)ᵀ over the depth D
  auto product_t = [&](float (&c)[2][4], const bf16* a_rows, const bf16* r) {
    c[0][0] = c[0][1] = c[0][2] = c[0][3] = c[1][0] = c[1][1] = c[1][2] = c[1][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned a[4], bf[4];
      load_a_frag(a, a_rows + kk * 16, LD, lane);
      load_k_frags(bf, r + kk * 16, LD, lane);
      mma_bf16(c[0], a, bf[0], bf[1]);
      mma_bf16(c[1], a, bf[2], bf[3]);
    }
  };

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<STAGES - 2>();  // stage it landed
    __syncthreads();              // and every warp is done with stage it - 1
    if (it + STAGES - 1 < n_it) {
      load_q_tile(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    } else {
      cp_async_commit();
    }
    if (!warp_keys) continue;
    const unsigned char* st = ring + (it % STAGES) * L::stage_bytes;
    const bf16* q_t = reinterpret_cast<const bf16*>(st);
    const bf16* do_t = q_t + QT * LD;
    const float* lse_t = reinterpret_cast<const float*>(st + sizeof(bf16) * 2 * QT * LD);
    const float* delta_t = lse_t + QT;
    // one chunk of 16 queries at a time: Pᵀ and dPᵀ of 16 queries live, not
    // QT (the products over QT at once spilled 56 bytes at 128 registers;
    // unrolled, this loop fits 128 with no spill and is as fast, PERF.md)
#pragma unroll
    for (int j = 0; j < QC; ++j) {
      const int c = c0 + it * QC + j;
      if (c >= n_chunks) break;
      const int q0 = sub_tile_pos(rows, c, subs, block, 16);  // the chunk's first query
      if (causal && kw0 > q0 + 15) continue;  // every query of the chunk before the warp's keys
      // every (key, query) pair of the warp visible: no mask
      const bool full = kpm == nullptr && (!causal || kw0 + 15 <= q0);

      // Pᵀ = exp2(K·Qᵀ·scale_log2 − lse₂), 0 where masked
      float pt[2][4];
      product_t(pt, k_w, q_t + j * 16 * LD);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = j * 16 + i * 8 + tig * 2;
        const int qpos = q0 + i * 8 + tig * 2;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = full || ((e < 2 ? kept_a : kept_b) && (!causal || (e < 2 ? key_a : key_b) <= qpos + (e & 1)));
          pt[i][e] = ok ? exp2f(fmaf(pt[i][e], scale_log2, -kLog2e * ((e & 1) ? l2.y : l2.x))) : 0.f;
        }
      }
      // dV += bf16(Pᵀ)·dO
      {
        const unsigned pa[4] = {pack_bf16(pt[0][0], pt[0][1]), pack_bf16(pt[0][2], pt[0][3]),
                                pack_bf16(pt[1][0], pt[1][1]), pack_bf16(pt[1][2], pt[1][3])};
#pragma unroll
        for (int dp = 0; dp < DB / 2; ++dp) {
          unsigned bf[4];
          load_v_frags(bf, do_t + j * 16 * LD + dp * 16, LD, lane);
          mma_bf16(dv_acc[2 * dp], pa, bf[0], bf[1]);
          mma_bf16(dv_acc[2 * dp + 1], pa, bf[2], bf[3]);
        }
      }
      // dPᵀ = V·dOᵀ; dSᵀ = Pᵀ(dPᵀ − delta)·scale rounded to bf16; dK += dSᵀ·Q
      float dpt[2][4];
      product_t(dpt, v_w, do_t + j * 16 * LD);
      unsigned da[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 d2 = *reinterpret_cast<const float2*>(delta_t + j * 16 + i * 8 + tig * 2);
        da[i * 2] = pack_bf16(pt[i][0] * (dpt[i][0] - d2.x) * scale, pt[i][1] * (dpt[i][1] - d2.y) * scale);
        da[i * 2 + 1] = pack_bf16(pt[i][2] * (dpt[i][2] - d2.x) * scale, pt[i][3] * (dpt[i][3] - d2.y) * scale);
      }
#pragma unroll
      for (int dp = 0; dp < DB / 2; ++dp) {
        unsigned bf[4];
        load_v_frags(bf, q_t + j * 16 * LD + dp * 16, LD, lane);
        mma_bf16(dk_acc[2 * dp], da, bf[0], bf[1]);
        mma_bf16(dk_acc[2 * dp + 1], da, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  if (!warp_keys) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long off = (head + (half ? key_b : key_a)) * D + tig * 2;
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + db * 8) =
          __floats2bfloat162_rn(dk_acc[db][half * 2], dk_acc[db][half * 2 + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + db * 8) =
          __floats2bfloat162_rn(dv_acc[db][half * 2], dv_acc[db][half * 2 + 1]);
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
  if constexpr (std::is_same<T, bf16>::value) {
    auto kernel = sparse_fwd_kernel_tc<D, BT>;
    constexpr size_t bytes = FwdTc<D, BT>::bytes;
    static_assert(bytes <= kSmemLimit, "K6a ring does not fit in shared memory");
    cudaError_t err = opt_in(kernel, bytes, done);
    if (err != cudaSuccess) return err;
    kernel<<<n.grid(BT), 2 * BT, bytes, st>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                              static_cast<const bf16*>(v), kpm, row_ptr, row_idx, row_order,
                                              static_cast<bf16*>(o), lse, n.B, n.H, n.S, n.block, n.causal,
                                              n.scale * kLog2e);
  } else {
    auto kernel = sparse_fwd_kernel<T, D, BT>;
    constexpr size_t bytes = FwdSmem<T, D, BT>::bytes;
    static_assert(bytes <= kSmemLimit, "K6a tile does not fit in shared memory");
    cudaError_t err = opt_in(kernel, bytes, done);
    if (err != cudaSuccess) return err;
    kernel<<<n.grid(BT), 2 * BT, bytes, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                              static_cast<const T*>(v), kpm, row_ptr, row_idx, row_order,
                                              static_cast<T*>(o), lse, n.B, n.H, n.S, n.block, n.causal, n.scale);
  }
  return cudaGetLastError();
}

// rows of a bf16 K6b/K6c CTA: min(block, 64) for each member of the widest
// group, rounded up to a power of two; 0 where the groups do not fit
inline int group_rows(int block, int width) {
  const int rpm = block < 64 ? block : 64;
  if (width < 1 || width * rpm > 64) return 0;
  int p = 1;
  while (p < width) p *= 2;
  return p * rpm;
}

// the tables of the bf16 backward kernels: the groups, their launch order and count
struct Groups {
  const int* groups;
  const int* order;
  int count, width;
  // one CTA per (batch, part of a block, group)
  unsigned grid(const Dims& n) const {
    const int rows = group_rows(n.block, width);
    return (unsigned)n.B * count * (n.block > rows ? n.block / rows : 1);
  }
};

template <int D, int ROWS>
cudaError_t dq_tc(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
                  const uint8_t* kpm, const int* row_ptr, const int* row_idx, const Groups& g, void* dq_out,
                  float* delta, const Dims& n, cudaStream_t st) {
  static std::atomic<bool> done[kMaxDevices];
  auto kernel = sparse_dq_kernel_tc<D, ROWS>;
  constexpr size_t bytes = FwdTc<D, ROWS>::bytes;
  static_assert(bytes <= kSmemLimit, "K6b ring does not fit in shared memory");
  cudaError_t err = opt_in(kernel, bytes, done);
  if (err != cudaSuccess) return err;
  kernel<<<g.grid(n), 2 * ROWS, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, kpm, row_ptr, row_idx, g.groups, g.order,
      static_cast<bf16*>(dq_out), delta, n.B, n.H, n.S, n.block, g.width, n.causal, n.scale,
      n.scale * kLog2e);
  return cudaGetLastError();
}

template <int D, int ROWS>
cudaError_t dkv_tc(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, const uint8_t* kpm, const int* col_ptr, const int* col_idx, const Groups& g,
                   void* dk_out, void* dv_out, const Dims& n, cudaStream_t st) {
  static std::atomic<bool> done[kMaxDevices];
  auto kernel = sparse_dkv_kernel_tc<D, ROWS>;
  constexpr size_t bytes = DkvTc<D, ROWS>::bytes;
  static_assert(bytes <= kSmemLimit, "K6c ring does not fit in shared memory");
  cudaError_t err = opt_in(kernel, bytes, done);
  if (err != cudaSuccess) return err;
  kernel<<<g.grid(n), 2 * ROWS, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, kpm, col_ptr, col_idx, g.groups, g.order,
      static_cast<bf16*>(dk_out), static_cast<bf16*>(dv_out), n.B, n.H, n.S, n.block, g.width, n.causal, n.scale,
      n.scale * kLog2e);
  return cudaGetLastError();
}

// the bf16 instantiation for (D, CTA rows): f(D, ROWS) with tag arguments
template <typename F>
int dispatch_groups(const Dims& n, const Groups& g, F&& f) {
  if (n.block != 16 && n.block != 32 && n.block != 64 && n.block != 128) return (int)cudaErrorInvalidValue;
  if (n.S % n.block || g.count < 1) return (int)cudaErrorInvalidValue;
  const int rows = group_rows(n.block, g.width);
  using R16 = std::integral_constant<int, 16>;
  using R32 = std::integral_constant<int, 32>;
  using R64 = std::integral_constant<int, 64>;
  if (n.D == 64) {
    using DC = std::integral_constant<int, 64>;
    if (rows == 16) return f(DC{}, R16{});
    if (rows == 32) return f(DC{}, R32{});
    if (rows == 64) return f(DC{}, R64{});
  } else if (n.D == 128) {
    using DC = std::integral_constant<int, 128>;
    if (rows == 16) return f(DC{}, R16{});
    if (rows == 32) return f(DC{}, R32{});
    if (rows == 64) return f(DC{}, R64{});
  }
  return (int)cudaErrorInvalidValue;
}

// float32 K6b and K6c (the bf16 ones take dq_tc and dkv_tc)
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
// dtype 0 = float32, 1 = bfloat16 (only with BF16: the bf16 backward takes
// dispatch_groups); head dims 64 and 128; blocks 16, 32, 64 and 128.  The
// tile is BT = min(block, 64) rows, 32 for float32 at head dim 128 (whose
// 64-row K6c tile would not fit in shared memory).
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

template <bool BF16, typename F>
int dispatch(int dtype, const Dims& n, F&& f) {
  if (n.block != 16 && n.block != 32 && n.block != 64 && n.block != 128) return (int)cudaErrorInvalidValue;
  if (n.S % n.block) return (int)cudaErrorInvalidValue;
  if constexpr (BF16) {
    if (dtype == 1 && n.D == 64) return with_tile<__nv_bfloat16, 64>(n.block, f);
    if (dtype == 1 && n.D == 128) return with_tile<__nv_bfloat16, 128>(n.block, f);
  }
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
  return dispatch<true>(dtype, n, [&](auto tag, auto d, auto bt) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return (int)fwd<T, decltype(d)::value, decltype(bt)::value>(
        q, k, v, static_cast<const uint8_t*>(kpm), static_cast<const int*>(row_ptr), static_cast<const int*>(row_idx),
        static_cast<const int*>(row_order), o, static_cast<float*>(lse), n, static_cast<cudaStream_t>(stream));
  });
}

// dq and dkv: bf16 launches one CTA per group (groups, group_order,
// n_groups, width = the groups' second dimension); float32 one per tile of
// the order table (row_order, col_order).
int ds_sparse_attn_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
                      const void* kpm, const void* row_ptr, const void* row_idx, const void* row_order,
                      const void* row_groups, const void* row_group_order, void* dq_out, void* delta, int n_groups,
                      int width, int B, int H, int S, int D, int block, int causal, float scale, int dtype,
                      void* stream) {
  const Dims n{B, H, S, D, block, causal, scale};
  const auto* kp = static_cast<const uint8_t*>(kpm);
  const auto* ptr = static_cast<const int*>(row_ptr);
  const auto* idx = static_cast<const int*>(row_idx);
  auto* dl = static_cast<float*>(delta);
  auto* ls = static_cast<const float*>(lse);
  auto* st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const Groups g{static_cast<const int*>(row_groups), static_cast<const int*>(row_group_order), n_groups, width};
    return dispatch_groups(n, g, [&](auto d, auto rows) {
      return (int)dq_tc<decltype(d)::value, decltype(rows)::value>(q, k, v, o, dout, ls, kp, ptr, idx, g, dq_out,
                                                                   dl, n, st);
    });
  }
  return dispatch<false>(dtype, n, [&](auto tag, auto d, auto bt) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return (int)dq<T, decltype(d)::value, decltype(bt)::value>(q, k, v, o, dout, ls, kp, ptr, idx,
                                                               static_cast<const int*>(row_order), dq_out, dl, n, st);
  });
}

int ds_sparse_attn_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                       const void* delta, const void* kpm, const void* col_ptr, const void* col_idx,
                       const void* col_order, const void* col_groups, const void* col_group_order, void* dk_out,
                       void* dv_out, int n_groups, int width, int B, int H, int S, int D, int block, int causal,
                       float scale, int dtype, void* stream) {
  const Dims n{B, H, S, D, block, causal, scale};
  const auto* kp = static_cast<const uint8_t*>(kpm);
  const auto* ptr = static_cast<const int*>(col_ptr);
  const auto* idx = static_cast<const int*>(col_idx);
  auto* ls = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  auto* st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const Groups g{static_cast<const int*>(col_groups), static_cast<const int*>(col_group_order), n_groups, width};
    return dispatch_groups(n, g, [&](auto d, auto rows) {
      return (int)dkv_tc<decltype(d)::value, decltype(rows)::value>(q, k, v, dout, ls, dl, kp, ptr, idx, g, dk_out,
                                                                    dv_out, n, st);
    });
  }
  return dispatch<false>(dtype, n, [&](auto tag, auto d, auto bt) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return (int)dkv<T, decltype(d)::value, decltype(bt)::value>(q, k, v, dout, ls, dl, kp, ptr, idx,
                                                                static_cast<const int*>(col_order), dk_out, dv_out,
                                                                n, st);
  });
}

const char* ds_sparse_attn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
