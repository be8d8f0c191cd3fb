// K1, K2a, K2b: flash attention forward and backward for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/flash_attention.py:
//   K1  flash_fwd_kernel  <- _fwd2_kernel (:162), driven by _flash_fwd2 (:207)
//   K2a flash_dq_kernel   <- _dq2_kernel  (:287), driven by _flash_bwd2 (:340)
//   K2b flash_dkv_kernel  <- _dkv2_kernel (:309), driven by _flash_bwd2 (:340)
// (bf16 runs flash_fwd_kernel_tc, flash_dq_kernel_tc and flash_dkv_kernel_tc.)
//
// Layout (all contiguous; the Python wrappers in ops/flash_attention.py check
// shapes, dtypes and alignment):
//   q, o, do, dq   [B, Sq, H, D]     k, v, dk, dv   [B, Sk, HK, D]
//   lse, delta     [B, H, Sq] f32
// Query head h reads kv head h / rep (rep = H / HK, GQA without repeating K/V).
// Query row i sits at position q_offset + i; with causal it sees the keys at
// positions <= q_offset + i.  Scores are s = q.k / sqrt(D); a masked score is
// the finite MASK (as the JAX kernels' DEFAULT_MASK_VALUE), never -inf.
//
//   K1:  o = softmax(s) v, lse = m + log(l), online over kv tiles; p is
//        rounded to v's dtype before PV, l sums the unrounded p;
//        o = acc / max(l, 1e-30).
//   K2a: delta = rowsum(do * o) (written for K2b), p = exp(s - lse),
//        dp = do v^T, ds = p (dp - delta) / sqrt(D) rounded to the input
//        dtype, dq = ds k.
//   K2b: dv = sum over the rep query heads and q tiles of p^T do (p rounded),
//        dk = sum of ds^T q; summed inside one block in a fixed order, no
//        atomics, so the result is deterministic.  A kv tile wholly above
//        the causal diagonal has no q tile to visit and writes zeros.
//
// Bound.  Each kernel does O(S·D) flops per row it must move (a causal q row
// meets S/2 keys on average).  At Llama-125M's training shapes (S = 1024,
// D = 64, bf16) that is ~250 flops per byte, just under the ~295 at which
// the H100 turns compute-bound: K1 and K2a are bound by HBM bytes by a hair,
// K2b by tensor-core operations.  At Llama-3-8B's (S = 4096, D = 128) all
// three are operations-bound.  So the kernels must keep the tensor cores fed
// from shared memory and registers, not round-trip through shared memory.
//
// Design.  The TPU kernels run a sequential grid over a triangular (q block,
// kv block) table and carry the softmax state in VMEM scratch across grid
// steps.  Here blocks run in parallel and share nothing:
//   * K1 and K2a: one block per (q tile, kv head, batch) whose 64 rows are
//     the rep query heads of that kv head at 64/rep consecutive positions
//     (group-major rows), so each K/V tile is staged in shared memory once
//     for all rep heads; the loop over kv tiles stops at the causal diagonal
//     of the block's last row, so tiles above it are never read.  The last
//     (longest) q tiles launch first to balance the causal triangle.
//   * K2b: one block per (kv tile of 64 keys, kv head, batch); it sums over
//     the rep query heads and the q tiles at or below the diagonal, and the
//     first (heaviest) kv tiles launch first.
//   * Each of the 4 warps owns a 16-row strip (K1, K2a: query rows; K2b:
//     keys) of every tile product, so the softmax between products needs
//     only the warp's own rows.
//
// bf16: the tensor-core tile of csrc/mma_tile.cuh (shared with K3), mma.sync
// m16n8k16 with every operand read by ldmatrix:
//   * K1 (flash_fwd_kernel_tc): the warp's Q fragments are loaded once and
//     stay in registers; S = Q·Kᵀ, the row statistics m and l and the O
//     accumulator stay in registers; the online softmax runs in base 2
//     (a row's max over its lane quad by two shuffles); p goes from the S
//     accumulators, rounded to bf16, straight into the A fragments of P·V.
//     K/V tiles of 64 keys come through a 3-stage cp.async ring, one base
//     pointer per thread stepped by a constant; the Q tile is staged in the
//     ring's last stage before the ring reaches it.  A warp whose rows all
//     lie before a tile skips it; a tile every row of the warp sees in full
//     skips the mask.  D 128: 3 × 34 KB of ring, two blocks per SM.
//   * K2a (flash_dq_kernel_tc): K1's grid, rows, ring and skips.  The Q and
//     dO tiles are staged together in the ring's last stage; each warp holds
//     its Q and dO A fragments in registers for the whole block, computes
//     delta for its rows once (a lane quad per row, reading O once) and
//     keeps delta and lse (base 2) in registers.  Per 16 keys of a tile, all
//     in registers: S = Q·Kᵀ and dP = dO·Vᵀ (K and V rows by load_k_frags),
//     P = exp2(S·scale_log2 − lse₂) (0 where masked and on rows past Sq),
//     dS = P(dP − delta)·scale packed into A fragments as K1 packs P, and
//     dQ += dS·K (K rows by load_v_frags).  dQ stays in f32 registers and is
//     written once: no atomics, dq and delta are deterministic.  Only the
//     ring is shared memory (55 KB at D 64, 104 KB at D 128), so four and
//     two blocks fit on an SM.
//   * K2b (flash_dkv_kernel_tc): the block's K and V rows are staged once;
//     Q, dO, lse and delta of each q tile come through a 3-stage cp.async
//     ring.  Per q tile and warp (16 keys), all in registers: Sᵀ = K·Qᵀ,
//     Pᵀ = exp(Sᵀ·scale − lse), dV += bf16(Pᵀ)·dO, dPᵀ = V·dOᵀ,
//     dSᵀ = Pᵀ(dPᵀ − delta)·scale rounded to bf16, dK += dSᵀ·Q; Pᵀ and dSᵀ
//     go from C fragments into A fragments as K1's P does.  dK and dV
//     accumulate in f32 registers over the whole block and are written once.
//     q tiles of 32; the warp's K and V fragments are read from shared
//     memory for each product, which keeps D 64 at 128 registers and four
//     blocks per SM (faster on the H100 than K/V fragments held in
//     registers with q tiles of 64 at two blocks per SM, PERF.md); at
//     D 128, dK and dV alone are 128 registers a lane: two blocks per SM.
// float32 K1, K2a and K2b use plain f32 FMA on the CUDA cores, with scores
// and accumulators passing through shared memory between products; they
// serve float32 training and check the algorithm at full precision.
//
// Head dims 64, 80, 96 and 128, in bf16 and float32.  At D 80 and 96 (Phi-2,
// Phi-3) a row is 10 or 12 chunks of 16 bytes, which do not divide the 128
// threads: the ring loaders of K1 and K2a and K2b's q-tile loader run on 120
// threads (the last 8 copy nothing) and stop at the tile's last row.  The
// padded shared rows (D + 8: 176 and 208 bytes, odd multiples of 16) keep
// ldmatrix free of bank conflicts as at D 64 and 128; K2a's delta spreads 10
// chunks over a lane quad; the float32 products give half the lanes a third
// column.  ptxas (-O3, sm_90a): K1 162 / 172, K2a 208 / 220, K2b 178 / 204
// registers at D 80 / 96, no spill, two blocks per SM each.  A kv head with
// more than 64 query heads (Falcon-7B's 71) does not fit one block's rows:
// the wrappers repeat K and V to H heads first (ops/flash_attention.py).
// Later work: wgmma and TMA for all three.

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
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;     // rows of a K1/K2a block; keys of a kv tile and of a K2b block
constexpr int kQTile = 32;    // query rows of a float32 K2b q tile
constexpr int kStages = 3;    // cp.async ring of the bf16 K1, K2a and K2b
constexpr float kMask = -0.7f * 3.402823466e+38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
struct Pad {  // elements that pad a shared row by 16 bytes
  static constexpr int value = 16 / sizeof(T);
};

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

// One warp: C[16 x 16*NF] (+)= A[16 x KD] * B[KD x 16*NF].  A is row-major
// (lda); B is row-major (ldb) or, with B_COL, given as its transpose
// [16*NF x KD] row-major (ldb); C is f32 row-major (ldc).  All in shared
// memory.  The C tile is read (when accumulating) and written by this warp
// only.
template <typename T, bool B_COL, int NF, int KD>
struct WarpGemm;

template <bool B_COL, int NF, int KD>
struct WarpGemm<float, B_COL, NF, KD> {
  __device__ static void run(const float* A, int lda, const float* B, int ldb, float* C, int ldc, bool accumulate) {
    constexpr int COLS = 16 * NF;
    constexpr int CPL = (COLS + 31) / 32;  // columns per lane; D 80: the last one on lanes 0-15 only
    const int lane = threadIdx.x & 31;
    auto col_ok = [&](int c) { return COLS % 32 == 0 || lane + 32 * c < COLS; };
    float acc[16][CPL];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i][c] = accumulate && col_ok(c) ? C[i * ldc + lane + 32 * c] : 0.f;
    for (int kk = 0; kk < KD; ++kk) {
      float b[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int n = lane + 32 * c;
        b[c] = !col_ok(c) ? 0.f : B_COL ? B[n * ldb + kk] : B[kk * ldb + n];
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float a = A[i * lda + kk];
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[i][c] = fmaf(a, b[c], acc[i][c]);
      }
    }
    __syncwarp();  // every lane has read C before any lane overwrites it
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (col_ok(c)) C[i * ldc + lane + 32 * c] = acc[i][c];
  }
};

template <typename T, bool B_COL, int NF, int KD>
__device__ __forceinline__ void warp_gemm(const T* A, int lda, const T* B, int ldb, float* C, int ldc,
                                          bool accumulate) {
  WarpGemm<T, B_COL, NF, KD>::run(A, lda, B, ldb, C, ldc, accumulate);
  __syncwarp();
}

// Copy `rows` rows of D elements from global (row r at src + r*stride, or
// zeros where valid(r) is false) into shared rows of ld elements; all threads.
template <typename T, int D, typename RowPtr>
__device__ __forceinline__ void load_rows(T* dst, int ld, int rows, RowPtr row_ptr) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += kThreads) {
    const int r = i / CHUNKS, ch = i % CHUNKS;
    const T* src = row_ptr(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr) val = *reinterpret_cast<const uint4*>(src + ch * VEC);
    *reinterpret_cast<uint4*>(dst + r * ld + ch * VEC) = val;
  }
}

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Group-major rows of a K1/K2a block: row r is query head kv*rep + r / qpb at
// position q0 + r % qpb (qpb = 64 / rep positions per block).
struct RowMap {
  int rep, qpb, q0, Sq;
  __device__ bool valid(int r) const { return r < rep * qpb && q0 + r % qpb < Sq; }
  __device__ int pos(int r) const { return q0 + r % qpb; }
  __device__ int head(int kv, int r) const { return kv * rep + r / qpb; }
};

// ---------------------------------------------------------------- K1

template <typename T, int D>
struct FwdSmem {
  static constexpr int LDT = D + Pad<T>::value;     // q, k, v tiles
  static constexpr int LDS = kRows + 4;             // f32 scores
  static constexpr int LDP = kRows + Pad<T>::value; // p in T
  static constexpr int LDO = D + 4;                 // f32 accumulator
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128(sizeof(T) * kRows * LDT);
  static constexpr size_t v = k + align128(sizeof(T) * kRows * LDT);
  static constexpr size_t s = v + align128(sizeof(T) * kRows * LDT);
  static constexpr size_t p = s + align128(sizeof(float) * kRows * LDS);
  static constexpr size_t o = p + align128(sizeof(T) * kRows * LDP);
  static constexpr size_t bytes = o + align128(sizeof(float) * kRows * LDO);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int HK, int q_offset, int causal, float scale) {
  using L = FwdSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::q);
  T* k_s = reinterpret_cast<T*>(smem + L::k);
  T* v_s = reinterpret_cast<T*>(smem + L::v);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  T* p_s = reinterpret_cast<T*>(smem + L::p);
  float* o_s = reinterpret_cast<float*>(smem + L::o);

  const int rep = H / HK;
  const RowMap rows{rep, kRows / rep, (int)(gridDim.x - 1 - blockIdx.x) * (kRows / rep), Sq};
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;  // this warp's strip of rows

  load_rows<T, D>(q_s, L::LDT, kRows, [&](int r) -> const T* {
    return rows.valid(r) ? q + (((long long)b * Sq + rows.pos(r)) * H + rows.head(kv, r)) * D : nullptr;
  });
  for (int i = lane; i < 16 * D; i += 32) o_s[(r0 + i / D) * L::LDO + i % D] = 0.f;

  const int last_pos = min(rows.q0 + rows.qpb, Sq) - 1;
  const int n_tiles = causal ? min(Sk / kRows, (q_offset + last_pos) / kRows + 1) : Sk / kRows;
  float m[16], l[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kRows;
    __syncthreads();  // the previous tile's K/V are no longer read
    auto kv_row = [&](const T* base) {
      return [=](int r) -> const T* { return base + (((long long)b * Sk + k0 + r) * HK + kv) * D; };
    };
    load_rows<T, D>(k_s, L::LDT, kRows, kv_row(k));
    load_rows<T, D>(v_s, L::LDT, kRows, kv_row(v));
    __syncthreads();

    float* s_w = s_s + r0 * L::LDS;
    warp_gemm<T, true, kRows / 16, D>(q_s + r0 * L::LDT, L::LDT, k_s, L::LDT, s_w, L::LDS, false);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int qpos = q_offset + rows.pos(r0 + i);
      float s[kRows / 32];
      float tmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < kRows / 32; ++u) {
        const int c = lane + 32 * u;
        const float x = s_w[i * L::LDS + c] * scale;
        s[u] = (!causal || k0 + c <= qpos) ? x : kMask;
        tmax = fmaxf(tmax, s[u]);
      }
      const float m_new = fmaxf(m[i], warp_max(tmax));  // finite: kMask is finite
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kRows / 32; ++u) {
        const float p = expf(s[u] - m_new);
        psum += p;
        p_s[(r0 + i) * L::LDP + lane + 32 * u] = from_float<T>(p);
      }
      l[i] = l[i] * alpha + warp_sum(psum);
      m[i] = m_new;
      for (int d = lane; d < D; d += 32) o_s[(r0 + i) * L::LDO + d] *= alpha;
    }
    __syncwarp();
    warp_gemm<T, false, D / 16, kRows>(p_s + r0 * L::LDP, L::LDP, v_s, L::LDT, o_s + r0 * L::LDO, L::LDO, true);
  }

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = r0 + i;
    if (!rows.valid(r)) continue;  // warp-uniform
    const float denom = fmaxf(l[i], 1e-30f);
    const int h = rows.head(kv, r), pos = rows.pos(r);
    T* dst = o + (((long long)b * Sq + pos) * H + h) * D;
    for (int d = lane; d < D; d += 32) dst[d] = from_float<T>(o_s[r * L::LDO + d] / denom);
    if (lane == 0) lse[((long long)b * H + h) * Sq + pos] = m[i] + logf(denom);
  }
}

// bf16 tiles in shared memory: rows padded by 16 bytes, so ldmatrix's eight
// row reads of one matrix hit distinct banks
template <int D>
__host__ __device__ constexpr int tc_ld() {
  return D + 8;
}
template <int D>
__host__ __device__ constexpr int fwd_tc_stage() {
  return 2 * kRows * tc_ld<D>();  // K tile, then V tile
}
template <int D>
__host__ __device__ constexpr size_t fwd_tc_bytes() {
  return sizeof(bf16) * kStages * fwd_tc_stage<D>();
}

// bf16 K1 on the tensor cores (see the file's head): one block per (q tile,
// kv head, batch), blockIdx.x = batch · HK + kv head, blockIdx.y from the
// last q tile to the first.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        bf16* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int HK, int q_offset,
                        int causal, float scale_log2) {
  constexpr int KT = kRows;  // keys of a tile
  constexpr int NB = KT / 8;  // S blocks of 8 keys
  constexpr int KD = D / 16;  // depth slices of Q·Kᵀ
  constexpr int DB = D / 8;   // column blocks of O
  constexpr int LD = tc_ld<D>();
  constexpr int CH = D / 8;   // 16-byte chunks of a row
  constexpr int STAGE = fwd_tc_stage<D>();
  constexpr int KEY_STEP = kThreads / CH;
  static_assert(kRows * LD <= STAGE, "the Q tile is staged in one ring stage");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kv_s = reinterpret_cast<bf16*>(smem_raw);  // [kStages][K, V][KT][LD]
  bf16* q_s = kv_s + (kStages - 1) * STAGE;         // [kRows][LD], until the ring reaches its last stage

  const int rep = H / HK;
  const int qpb = kRows / rep;
  const RowMap rows{rep, qpb, (int)(gridDim.y - 1 - blockIdx.y) * qpb, Sq};
  const int kv = blockIdx.x % HK;
  const int b = blockIdx.x / HK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane >> 2, tig = lane & 3;

  // Q tile -> the last stage; rows past Sq and past rep·qpb are zeros
  for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
    const int r = i / CH, ch = i % CH;
    const bool ok = rows.valid(r);
    const bf16* src = q;
    if (ok) src = q + (((long long)b * Sq + rows.pos(r)) * H + rows.head(kv, r)) * D + ch * 8;
    cp_async16(q_s + r * LD + ch * 8, src, ok);
  }
  cp_async_commit();

  const int last_pos = min(rows.q0 + qpb, Sq) - 1;
  const int n_tiles = causal ? min(Sk / KT, (q_offset + last_pos) / KT + 1) : Sk / KT;

  // a thread copies 16-byte chunk my_ch of keys j0, j0 + KEY_STEP, ... of a
  // tile; its K and V sources step by one tile of keys per load
  const long long key_stride = (long long)HK * D;
  const int my_ch = threadIdx.x % CH, j0 = threadIdx.x / CH;
  const long long off0 = ((long long)b * Sk + j0) * key_stride + (long long)kv * D + my_ch * 8;
  const bf16* k_src = k + off0;
  const bf16* v_src = v + off0;
  bf16* dst0 = kv_s + j0 * LD + my_ch * 8;
  // D 80 and 96 (10 and 12 chunks a row): KEY_STEP · CH = 120 threads load,
  // the last 8 copy nothing, and the last step of keys stops at the tile
  auto tile_row_ok = [&](int key) {
    return (KEY_STEP * CH == kThreads || threadIdx.x < KEY_STEP * CH) && (KT % KEY_STEP == 0 || key < KT);
  };
  auto load_tile = [&](int stage) {
    bf16* dst = dst0 + stage * STAGE;
#pragma unroll
    for (int j = 0; j < (KT + KEY_STEP - 1) / KEY_STEP; ++j) {
      if (tile_row_ok(j0 + j * KEY_STEP)) {
        cp_async16(dst + j * KEY_STEP * LD, k_src + j * KEY_STEP * key_stride, true);
        cp_async16(dst + (KT + j * KEY_STEP) * LD, v_src + j * KEY_STEP * key_stride, true);
      }
    }
    cp_async_commit();
    k_src += KT * key_stride;
    v_src += KT * key_stride;
  };
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      load_tile(t);
    } else {
      cp_async_commit();  // empty groups keep the ring's wait counts
    }
  }

  // this thread's two rows (group, group + 8 of the warp's 16) and the key
  // positions they see; a row that is not valid (zero q, never written) is
  // given every key, so it never takes a mask
  constexpr int kAllKeys = 0x7fffffff;
  const int r0 = warp * 16;
  const int ra = r0 + group, rb = ra + 8;
  const int qpos_a = rows.valid(ra) ? q_offset + rows.pos(ra) : kAllKeys;
  const int qpos_b = rows.valid(rb) ? q_offset + rows.pos(rb) : kAllKeys;
  // the last key any valid row of the warp sees, and the last key every one sees
  bool warp_rows = false;
  int warp_qmax = 0, warp_qmin = kAllKeys;
  for (int i = 0; i < 16; ++i) {
    if (!rows.valid(r0 + i)) continue;
    const int p = q_offset + rows.pos(r0 + i);
    warp_qmax = warp_rows ? max(warp_qmax, p) : p;
    warp_qmin = min(warp_qmin, p);
    warp_rows = true;
  }

  cp_async_wait<kStages - 1>();  // the Q tile
  __syncthreads();
  unsigned qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_a_frag(qa[kk], q_s + r0 * LD + kk * 16, LD, lane);

  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // m in base 2
  float acc[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t landed
    __syncthreads();               // and every warp is done with tile t - 1 (and the Q tile)
    if (t + kStages - 1 < n_tiles) {
      load_tile((t + kStages - 1) % kStages);
    } else {
      cp_async_commit();
    }
    const int kbase = t * KT;
    if (!warp_rows || (causal && kbase > warp_qmax)) continue;  // every key in the warp's rows' future
    const bf16* k_s = kv_s + (t % kStages) * STAGE;
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

    // base-2 scores; the causal mask gives the finite kMask
    const bool full = !causal || kbase + KT - 1 <= warp_qmin;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kbase + nb * 8 + tig * 2 + (e & 1);
        s[nb][e] = (full || key <= (e < 2 ? qpos_a : qpos_b)) ? s[nb][e] * scale_log2 : kMask;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[nb][0], s[nb][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nb][2], s[nb][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a);  // finite: every score is
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

    // p in f32 for l, rounded to bf16 into the A fragments of P·V: S blocks
    // 2j and 2j + 1 are keys 16j..16j+15, the depth of one product
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) {
      unsigned pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nb = 2 * j + half;
        const float p0 = exp2f(s[nb][0] - mn_a);
        const float p1 = exp2f(s[nb][1] - mn_a);
        const float p2 = exp2f(s[nb][2] - mn_b);
        const float p3 = exp2f(s[nb][3] - mn_b);
        l_a += p0 + p1;
        l_b += p2 + p3;
        pa[half * 2] = pack_bf16(p0, p1);
        pa[half * 2 + 1] = pack_bf16(p2, p3);
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

  // a row's l: the sum over its lane quad
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (!rows.valid(r)) continue;
    const float denom = fmaxf(half ? l_b : l_a, 1e-30f);
    const float inv = 1.f / denom;
    const int h = rows.head(kv, r), pos = rows.pos(r);
    bf16* dst = o + (((long long)b * Sq + pos) * H + h) * D + tig * 2;
#pragma unroll
    for (int db = 0; db < DB; ++db)
      *reinterpret_cast<__nv_bfloat162*>(dst + db * 8) =
          __floats2bfloat162_rn(acc[db][half * 2] * inv, acc[db][half * 2 + 1] * inv);
    if (tig == 0) lse[((long long)b * H + h) * Sq + pos] = (half ? m_b : m_a) * kLn2 + logf(denom);
  }
}

// ---------------------------------------------------------------- K2a

// float32 K2a (the bf16 one is flash_dq_kernel_tc below)

template <typename T, int D>
struct DqSmem {
  static constexpr int LDT = D + Pad<T>::value;
  static constexpr int LDS = kRows + 4;
  static constexpr int LDP = kRows + Pad<T>::value;
  static constexpr int LDO = D + 4;
  static constexpr size_t q = 0;
  static constexpr size_t dO = q + align128(sizeof(T) * kRows * LDT);
  static constexpr size_t k = dO + align128(sizeof(T) * kRows * LDT);
  static constexpr size_t v = k + align128(sizeof(T) * kRows * LDT);
  static constexpr size_t s = v + align128(sizeof(T) * kRows * LDT);
  static constexpr size_t dp = s + align128(sizeof(float) * kRows * LDS);
  static constexpr size_t ds = dp + align128(sizeof(float) * kRows * LDS);
  static constexpr size_t dq = ds + align128(sizeof(T) * kRows * LDP);
  static constexpr size_t bytes = dq + align128(sizeof(float) * kRows * LDO);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
                    T* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk, int H, int HK, int q_offset,
                    int causal, float scale) {
  using L = DqSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::q);
  T* do_s = reinterpret_cast<T*>(smem + L::dO);
  T* k_s = reinterpret_cast<T*>(smem + L::k);
  T* v_s = reinterpret_cast<T*>(smem + L::v);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  float* dp_s = reinterpret_cast<float*>(smem + L::dp);
  T* ds_s = reinterpret_cast<T*>(smem + L::ds);
  float* dq_s = reinterpret_cast<float*>(smem + L::dq);

  const int rep = H / HK;
  const RowMap rows{rep, kRows / rep, (int)(gridDim.x - 1 - blockIdx.x) * (kRows / rep), Sq};
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;

  auto q_row = [&](const T* base) {
    return [=](int r) -> const T* {
      return rows.valid(r) ? base + (((long long)b * Sq + rows.pos(r)) * H + rows.head(kv, r)) * D : nullptr;
    };
  };
  load_rows<T, D>(q_s, L::LDT, kRows, q_row(q));
  load_rows<T, D>(do_s, L::LDT, kRows, q_row(dout));
  for (int i = lane; i < 16 * D; i += 32) dq_s[(r0 + i / D) * L::LDO + i % D] = 0.f;
  __syncthreads();

  // delta = rowsum(do * o) in f32 and this block's lse, for the warp's rows
  float lse_r[16], delta_r[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = r0 + i;
    float acc = 0.f;
    lse_r[i] = 0.f;
    if (rows.valid(r)) {  // warp-uniform
      const int h = rows.head(kv, r), pos = rows.pos(r);
      const T* orow = o + (((long long)b * Sq + pos) * H + h) * D;
      for (int d = lane; d < D; d += 32) acc = fmaf(to_float(do_s[r * L::LDT + d]), to_float(orow[d]), acc);
      acc = warp_sum(acc);
      lse_r[i] = lse[((long long)b * H + h) * Sq + pos];
      if (lane == 0) delta[((long long)b * H + h) * Sq + pos] = acc;
    }
    delta_r[i] = acc;
  }

  const int last_pos = min(rows.q0 + rows.qpb, Sq) - 1;
  const int n_tiles = causal ? min(Sk / kRows, (q_offset + last_pos) / kRows + 1) : Sk / kRows;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kRows;
    __syncthreads();
    auto kv_row = [&](const T* base) {
      return [=](int r) -> const T* { return base + (((long long)b * Sk + k0 + r) * HK + kv) * D; };
    };
    load_rows<T, D>(k_s, L::LDT, kRows, kv_row(k));
    load_rows<T, D>(v_s, L::LDT, kRows, kv_row(v));
    __syncthreads();

    float* s_w = s_s + r0 * L::LDS;
    float* dp_w = dp_s + r0 * L::LDS;
    warp_gemm<T, true, kRows / 16, D>(q_s + r0 * L::LDT, L::LDT, k_s, L::LDT, s_w, L::LDS, false);
    warp_gemm<T, true, kRows / 16, D>(do_s + r0 * L::LDT, L::LDT, v_s, L::LDT, dp_w, L::LDS, false);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int qpos = q_offset + rows.pos(r0 + i);
#pragma unroll
      for (int u = 0; u < kRows / 32; ++u) {
        const int c = lane + 32 * u;
        const float x = s_w[i * L::LDS + c] * scale;
        const float s = (!causal || k0 + c <= qpos) ? x : kMask;
        const float p = expf(s - lse_r[i]);
        ds_s[(r0 + i) * L::LDP + c] = from_float<T>(p * (dp_w[i * L::LDS + c] - delta_r[i]) * scale);
      }
    }
    __syncwarp();
    warp_gemm<T, false, D / 16, kRows>(ds_s + r0 * L::LDP, L::LDP, k_s, L::LDT, dq_s + r0 * L::LDO, L::LDO, true);
  }

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = r0 + i;
    if (!rows.valid(r)) continue;
    T* dst = dq + (((long long)b * Sq + rows.pos(r)) * H + rows.head(kv, r)) * D;
    for (int d = lane; d < D; d += 32) dst[d] = from_float<T>(dq_s[r * L::LDO + d]);
  }
}

// bf16 K2a on the tensor cores (see the file's head): K1's grid, blockIdx.x =
// batch · HK + kv head, blockIdx.y from the last q tile to the first.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 4 : 2)
    flash_dq_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
                       bf16* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk, int H, int HK,
                       int q_offset, int causal, float scale, float scale_log2) {
  constexpr int KT = kRows;   // keys of a tile
  constexpr int KD = D / 16;  // depth slices of Q·Kᵀ and dO·Vᵀ
  constexpr int DB = D / 8;   // column blocks of dQ
  constexpr int LD = tc_ld<D>();
  constexpr int CH = D / 8;   // 16-byte chunks of a row
  constexpr int STAGE = fwd_tc_stage<D>();
  constexpr int KEY_STEP = kThreads / CH;
  static_assert(2 * kRows * LD <= STAGE, "the Q and dO tiles are staged in one ring stage");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kv_s = reinterpret_cast<bf16*>(smem_raw);  // [kStages][K, V][KT][LD]
  bf16* q_s = kv_s + (kStages - 1) * STAGE;         // Q [kRows][LD], then dO, until the ring reaches its last stage
  bf16* do_s = q_s + kRows * LD;

  const int rep = H / HK;
  const int qpb = kRows / rep;
  const RowMap rows{rep, qpb, (int)(gridDim.y - 1 - blockIdx.y) * qpb, Sq};
  const int kv = blockIdx.x % HK;
  const int b = blockIdx.x / HK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane >> 2, tig = lane & 3;

  // Q and dO tiles -> the last stage; rows past Sq and past rep·qpb are zeros
  for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
    const int r = i / CH, ch = i % CH;
    const bool ok = rows.valid(r);
    long long off = 0;
    if (ok) off = (((long long)b * Sq + rows.pos(r)) * H + rows.head(kv, r)) * D + ch * 8;
    cp_async16(q_s + r * LD + ch * 8, q + off, ok);
    cp_async16(do_s + r * LD + ch * 8, dout + off, ok);
  }
  cp_async_commit();

  const int last_pos = min(rows.q0 + qpb, Sq) - 1;
  const int n_tiles = causal ? min(Sk / KT, (q_offset + last_pos) / KT + 1) : Sk / KT;

  // K1's ring: a thread copies 16-byte chunk my_ch of keys j0, j0 + KEY_STEP,
  // ... of a tile; its K and V sources step by one tile of keys per load
  const long long key_stride = (long long)HK * D;
  const int my_ch = threadIdx.x % CH, j0 = threadIdx.x / CH;
  const long long off0 = ((long long)b * Sk + j0) * key_stride + (long long)kv * D + my_ch * 8;
  const bf16* k_src = k + off0;
  const bf16* v_src = v + off0;
  bf16* dst0 = kv_s + j0 * LD + my_ch * 8;
  // D 80 and 96 (10 and 12 chunks a row): KEY_STEP · CH = 120 threads load,
  // the last 8 copy nothing, and the last step of keys stops at the tile
  auto tile_row_ok = [&](int key) {
    return (KEY_STEP * CH == kThreads || threadIdx.x < KEY_STEP * CH) && (KT % KEY_STEP == 0 || key < KT);
  };
  auto load_tile = [&](int stage) {
    bf16* dst = dst0 + stage * STAGE;
#pragma unroll
    for (int j = 0; j < (KT + KEY_STEP - 1) / KEY_STEP; ++j) {
      if (tile_row_ok(j0 + j * KEY_STEP)) {
        cp_async16(dst + j * KEY_STEP * LD, k_src + j * KEY_STEP * key_stride, true);
        cp_async16(dst + (KT + j * KEY_STEP) * LD, v_src + j * KEY_STEP * key_stride, true);
      }
    }
    cp_async_commit();
    k_src += KT * key_stride;
    v_src += KT * key_stride;
  };
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      load_tile(t);
    } else {
      cp_async_commit();  // empty groups keep the ring's wait counts
    }
  }

  // this thread's two rows and the key positions they see, as in K1
  constexpr int kAllKeys = 0x7fffffff;
  const int r0 = warp * 16;
  const int ra = r0 + group, rb = ra + 8;
  const int qpos_a = rows.valid(ra) ? q_offset + rows.pos(ra) : kAllKeys;
  const int qpos_b = rows.valid(rb) ? q_offset + rows.pos(rb) : kAllKeys;
  bool warp_rows = false;
  int warp_qmax = 0, warp_qmin = kAllKeys;
  for (int i = 0; i < 16; ++i) {
    if (!rows.valid(r0 + i)) continue;
    const int p = q_offset + rows.pos(r0 + i);
    warp_qmax = warp_rows ? max(warp_qmax, p) : p;
    warp_qmin = min(warp_qmin, p);
    warp_rows = true;
  }

  cp_async_wait<kStages - 1>();  // the Q and dO tiles
  __syncthreads();
  unsigned qa[KD][4], da[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    load_a_frag(qa[kk], q_s + r0 * LD + kk * 16, LD, lane);
    load_a_frag(da[kk], do_s + r0 * LD + kk * 16, LD, lane);
  }

  // delta = rowsum(dO·O) in f32 for the thread's two rows: the row's lane
  // quad reads O once, each lane every fourth 16-byte chunk, and sums over
  // the quad.  -lse in base 2 beside it; -inf on a row that is not valid
  // gives p = 0 there.
  float delta_r[2], nlse2[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    const bool ok = rows.valid(r);  // the same for the quad
    float acc = 0.f;
    if (ok) {
      const bf16* orow = o + (((long long)b * Sq + rows.pos(r)) * H + rows.head(kv, r)) * D;
#pragma unroll
      for (int c = 0; c < (CH + 3) / 4; ++c) {
        const int ch = tig + 4 * c;
        if (CH % 4 != 0 && ch >= CH) break;  // D 80: 10 chunks, lanes 2 and 3 of the quad take two
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
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    delta_r[half] = acc;
    nlse2[half] = -INFINITY;
    if (ok) {
      const long long st = ((long long)b * H + rows.head(kv, r)) * Sq + rows.pos(r);
      if (tig == 0) delta[st] = acc;
      nlse2[half] = -kLog2e * lse[st];
    }
  }

  float acc[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t landed
    __syncthreads();               // and every warp is done with tile t - 1 (and the Q and dO tiles)
    if (t + kStages - 1 < n_tiles) {
      load_tile((t + kStages - 1) % kStages);
    } else {
      cp_async_commit();
    }
    const int kbase = t * KT;
    if (!warp_rows || (causal && kbase > warp_qmax)) continue;  // every key in the warp's rows' future
    const bf16* k_s = kv_s + (t % kStages) * STAGE;
    const bf16* v_s = k_s + KT * LD;
    const bool full = !causal || kbase + KT - 1 <= warp_qmin;

    // 16 keys at a time: S and dP of the warp's rows, dS, then dQ += dS·K.
    // D 64 keeps the loop rolled, which fits 128 registers (four blocks per
    // SM) with no spill; D 128 unrolls it (PERF.md)
#pragma unroll (D == 64 ? 1 : kRows / 16)
    for (int j = 0; j < KT / 16; ++j) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
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
      for (int nb = 0; nb < 2; ++nb) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e >> 1;  // 0: row a, 1: row b
          const int key = kbase + j * 16 + nb * 8 + tig * 2 + (e & 1);
          const bool ok = full || key <= (row ? qpos_b : qpos_a);
          const float p = ok ? exp2f(fmaf(s[nb][e], scale_log2, nlse2[row])) : 0.f;
          x[e] = p * (dp[nb][e] - delta_r[row]) * scale;
        }
        dsa[nb * 2] = pack_bf16(x[0], x[1]);
        dsa[nb * 2 + 1] = pack_bf16(x[2], x[3]);
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

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (!rows.valid(r)) continue;
    bf16* dst = dq + (((long long)b * Sq + rows.pos(r)) * H + rows.head(kv, r)) * D + tig * 2;
#pragma unroll
    for (int db = 0; db < DB; ++db)
      *reinterpret_cast<__nv_bfloat162*>(dst + db * 8) =
          __floats2bfloat162_rn(acc[db][half * 2], acc[db][half * 2 + 1]);
  }
}

// ---------------------------------------------------------------- K2b

template <typename T, int D>
struct DkvSmem {
  static constexpr int LDT = D + Pad<T>::value;
  static constexpr int LDS = kQTile + 4;
  static constexpr int LDP = kQTile + Pad<T>::value;
  static constexpr int LDO = D + 4;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + align128(sizeof(T) * kRows * LDT);
  static constexpr size_t q = v + align128(sizeof(T) * kRows * LDT);
  static constexpr size_t dO = q + align128(sizeof(T) * kQTile * LDT);
  static constexpr size_t st = dO + align128(sizeof(T) * kQTile * LDT);
  static constexpr size_t dpt = st + align128(sizeof(float) * kRows * LDS);
  static constexpr size_t pt = dpt + align128(sizeof(float) * kRows * LDS);
  static constexpr size_t dk = pt + align128(sizeof(T) * kRows * LDP);
  static constexpr size_t dv = dk + align128(sizeof(float) * kRows * LDO);
  static constexpr size_t stats = dv + align128(sizeof(float) * kRows * LDO);
  static constexpr size_t bytes = stats + align128(sizeof(float) * 2 * kQTile);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int HK, int q_offset, int causal,
                     float scale) {
  using L = DkvSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem + L::k);
  T* v_s = reinterpret_cast<T*>(smem + L::v);
  T* q_s = reinterpret_cast<T*>(smem + L::q);
  T* do_s = reinterpret_cast<T*>(smem + L::dO);
  float* st_s = reinterpret_cast<float*>(smem + L::st);   // s^T, then p^T in f32
  float* dpt_s = reinterpret_cast<float*>(smem + L::dpt);
  T* pt_s = reinterpret_cast<T*>(smem + L::pt);           // p^T, then ds^T, in T
  float* dk_s = reinterpret_cast<float*>(smem + L::dk);
  float* dv_s = reinterpret_cast<float*>(smem + L::dv);
  float* lse_s = reinterpret_cast<float*>(smem + L::stats);
  float* delta_s = lse_s + kQTile;

  const int k0 = blockIdx.x * kRows;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / HK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;  // this warp's 16 keys

  auto kv_row = [&](const T* base) {
    return [=](int r) -> const T* { return base + (((long long)b * Sk + k0 + r) * HK + kv) * D; };
  };
  load_rows<T, D>(k_s, L::LDT, kRows, kv_row(k));
  load_rows<T, D>(v_s, L::LDT, kRows, kv_row(v));
  for (int i = lane; i < 16 * D; i += 32) {
    dk_s[(r0 + i / D) * L::LDO + i % D] = 0.f;
    dv_s[(r0 + i / D) * L::LDO + i % D] = 0.f;
  }
  // the first q tile with a row that sees key k0: rows at positions
  // >= k0 - q_offset; none when that is past Sq (the tile writes zeros)
  const int n_qt = (Sq + kQTile - 1) / kQTile;
  const int qt_lo = causal ? max(0, k0 - q_offset) / kQTile : 0;

  for (int hr = 0; hr < rep; ++hr) {
    const int h = kv * rep + hr;
    for (int qt = qt_lo; qt < n_qt; ++qt) {
      const int p0 = qt * kQTile;
      __syncthreads();  // the previous q tile is no longer read
      auto q_row = [&](const T* base) {
        return [=](int r) -> const T* {
          return p0 + r < Sq ? base + (((long long)b * Sq + p0 + r) * H + h) * D : nullptr;
        };
      };
      load_rows<T, D>(q_s, L::LDT, kQTile, q_row(q));
      load_rows<T, D>(do_s, L::LDT, kQTile, q_row(dout));
      for (int i = threadIdx.x; i < kQTile; i += kThreads) {
        const bool ok = p0 + i < Sq;
        lse_s[i] = ok ? lse[((long long)b * H + h) * Sq + p0 + i] : 0.f;
        delta_s[i] = ok ? delta[((long long)b * H + h) * Sq + p0 + i] : 0.f;
      }
      __syncthreads();

      float* st_w = st_s + r0 * L::LDS;
      float* dpt_w = dpt_s + r0 * L::LDS;
      T* pt_w = pt_s + r0 * L::LDP;
      // s^T = K q^T and dp^T = V do^T for the warp's 16 keys
      warp_gemm<T, true, kQTile / 16, D>(k_s + r0 * L::LDT, L::LDT, q_s, L::LDT, st_w, L::LDS, false);
      warp_gemm<T, true, kQTile / 16, D>(v_s + r0 * L::LDT, L::LDT, do_s, L::LDT, dpt_w, L::LDS, false);
      const int c = lane;  // kQTile == 32: one query column per lane
      const bool col_ok = p0 + c < Sq;
      const int qpos = q_offset + p0 + c;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float x = st_w[i * L::LDS + c] * scale;
        const float s = (!causal || k0 + r0 + i <= qpos) ? x : kMask;
        const float p = col_ok ? expf(s - lse_s[c]) : 0.f;
        st_w[i * L::LDS + c] = p;
        pt_w[i * L::LDP + c] = from_float<T>(p);
      }
      __syncwarp();
      warp_gemm<T, false, D / 16, kQTile>(pt_w, L::LDP, do_s, L::LDT, dv_s + r0 * L::LDO, L::LDO, true);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float p = st_w[i * L::LDS + c];
        pt_w[i * L::LDP + c] = from_float<T>(p * (dpt_w[i * L::LDS + c] - delta_s[c]) * scale);
      }
      __syncwarp();
      warp_gemm<T, false, D / 16, kQTile>(pt_w, L::LDP, q_s, L::LDT, dk_s + r0 * L::LDO, L::LDO, true);
    }
  }

  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = r0 + i / D, d = i % D;
    const long long off = (((long long)b * Sk + k0 + r) * HK + kv) * D + d;
    dk[off] = from_float<T>(dk_s[r * L::LDO + d]);
    dv[off] = from_float<T>(dv_s[r * L::LDO + d]);
  }
}

// global -> shared, 4 bytes; pred false fills the destination with zeros
// shared memory and occupancy of the bf16 K2b (see the file's head)
template <int D>
struct DkvTc {
  static constexpr int QT = 32;                     // queries of a q tile
  static constexpr int MIN_BLOCKS = D == 64 ? 4 : 2;  // blocks per SM: 128 / 255 registers a thread, no spill
  static constexpr int LD = tc_ld<D>();
  static constexpr size_t kv_bytes = sizeof(bf16) * 2 * kRows * LD;                        // K, V rows
  static constexpr size_t stage_bytes = sizeof(bf16) * 2 * QT * LD + sizeof(float) * 2 * QT;  // Q, dO, lse, delta
  static constexpr size_t bytes = kv_bytes + kStages * stage_bytes;
};

// bf16 K2b on the tensor cores (see the file's head): one block per (kv
// tile, kv head, batch), blockIdx.x = batch · HK + kv head, blockIdx.y the kv
// tile (the first tiles see the most queries under causal and launch first).
template <int D>
__global__ void __launch_bounds__(kThreads, DkvTc<D>::MIN_BLOCKS)
    flash_dkv_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                        int Sk, int H, int HK, int q_offset, int causal, float scale, float scale_log2) {
  using L = DkvTc<D>;
  constexpr int QT = L::QT;
  constexpr int NB = QT / 8;   // Sᵀ blocks of 8 queries
  constexpr int KD = D / 16;   // depth slices of K·Qᵀ and V·dOᵀ
  constexpr int DB = D / 8;    // column blocks of dK, dV
  constexpr int LD = L::LD;
  constexpr int CH = D / 8;    // 16-byte chunks of a row
  constexpr int ROW_STEP = kThreads / CH;  // D 80 and 96: 120 threads load, the last 8 copy no row
  static_assert(2 * QT <= kThreads, "a q tile's statistics split over the block");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kRows][LD]
  bf16* v_s = k_s + kRows * LD;                   // [kRows][LD]
  unsigned char* ring = smem_raw + L::kv_bytes;   // [kStages] of {Q [QT][LD], dO [QT][LD], lse [QT], delta [QT]}

  const int k0 = blockIdx.y * kRows;
  const int kv = blockIdx.x % HK;
  const int b = blockIdx.x / HK;
  const int rep = H / HK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane >> 2, tig = lane & 3;
  const int kw0 = k0 + warp * 16;  // the warp's first key

  // the q tiles with a row that sees key k0 (rows at positions >= k0 -
  // q_offset), for each of the rep heads; none when that is past Sq (the
  // block writes zeros)
  const int n_qt = (Sq + QT - 1) / QT;
  const int qt_lo = causal ? min(n_qt, max(0, k0 - q_offset) / QT) : 0;
  const int per_head = n_qt - qt_lo;
  const int n_it = rep * per_head;

  // K, V rows of the block's keys
  for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
    const int r = i / CH, ch = i % CH;
    const long long off = (((long long)b * Sk + k0 + r) * HK + kv) * D + ch * 8;
    cp_async16(k_s + r * LD + ch * 8, k + off, true);
    cp_async16(v_s + r * LD + ch * 8, v + off, true);
  }
  cp_async_commit();

  // q tile it: head kv·rep + it / per_head, rows from (qt_lo + it % per_head)·QT.
  // A thread copies 16-byte chunk my_ch of rows j0, j0 + ROW_STEP, ... of Q
  // and dO, and thread i < 2·QT one lse (i < QT) or delta value.
  const long long row_stride = (long long)H * D;
  const int my_ch = threadIdx.x % CH, j0 = threadIdx.x / CH;
  const int stat_i = threadIdx.x % QT;
  const float* stat_src = threadIdx.x < QT ? lse : delta;
  auto load_q_tile = [&](int it, int stage) {
    const int h = kv * rep + it / per_head;
    const int p0 = (qt_lo + it % per_head) * QT;
    unsigned char* st = ring + stage * L::stage_bytes;
    bf16* q_dst = reinterpret_cast<bf16*>(st) + j0 * LD + my_ch * 8;
    bf16* do_dst = q_dst + QT * LD;
    const long long off = (((long long)b * Sq + p0 + j0) * H + h) * D + my_ch * 8;
#pragma unroll
    for (int j = 0; j < (QT + ROW_STEP - 1) / ROW_STEP; ++j) {
      const int row = j0 + j * ROW_STEP;
      if ((ROW_STEP * CH == kThreads || threadIdx.x < ROW_STEP * CH) && (QT % ROW_STEP == 0 || row < QT)) {
        const bool ok = p0 + row < Sq;
        const long long o = off + j * ROW_STEP * row_stride;
        cp_async16(q_dst + j * ROW_STEP * LD, ok ? q + o : q, ok);
        cp_async16(do_dst + j * ROW_STEP * LD, ok ? dout + o : dout, ok);
      }
    }
    if (threadIdx.x < 2 * QT) {
      const bool ok = p0 + stat_i < Sq;
      float* stat_dst = reinterpret_cast<float*>(st + sizeof(bf16) * 2 * QT * LD) + threadIdx.x;
      cp_async4(stat_dst, ok ? stat_src + ((long long)b * H + h) * Sq + p0 + stat_i : stat_src, ok);
    }
    cp_async_commit();
  };
  for (int it = 0; it < kStages - 1; ++it) {
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

  cp_async_wait<kStages - 1>();  // K and V
  __syncthreads();
  const bf16* k_w = k_s + warp * 16 * LD;  // the warp's K and V rows, A operands of K·Qᵀ and V·dOᵀ
  const bf16* v_w = v_s + warp * 16 * LD;
  // c = (the warp's K or V rows at a_rows) · (rows at r)ᵀ over the depth D
  auto product_t = [&](float (&c)[NB][4], const bf16* a_rows, const bf16* r) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) c[nb][0] = c[nb][1] = c[nb][2] = c[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned a[4];
      load_a_frag(a, a_rows + kk * 16, LD, lane);
#pragma unroll
      for (int p = 0; p < NB / 2; ++p) {
        unsigned bf[4];
        load_k_frags(bf, r + p * 16 * LD + kk * 16, LD, lane);
        mma_bf16(c[2 * p], a, bf[0], bf[1]);
        mma_bf16(c[2 * p + 1], a, bf[2], bf[3]);
      }
    }
  };

  const int key_a = kw0 + group, key_b = key_a + 8;  // this thread's two keys
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kStages - 2>();  // q tile it landed
    __syncthreads();               // and every warp is done with q tile it - 1
    if (it + kStages - 1 < n_it) {
      load_q_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    } else {
      cp_async_commit();
    }
    const int p0 = (qt_lo + it % per_head) * QT;
    const int q_first = q_offset + p0;                          // the tile's first query position
    if (causal && kw0 > q_offset + min(p0 + QT, Sq) - 1) continue;  // every query before the warp's keys
    const unsigned char* st = ring + (it % kStages) * L::stage_bytes;
    const bf16* q_t = reinterpret_cast<const bf16*>(st);
    const bf16* do_t = q_t + QT * LD;
    const float* lse_t = reinterpret_cast<const float*>(st + sizeof(bf16) * 2 * QT * LD);
    const float* delta_t = lse_t + QT;
    // every (key, query) pair of the warp visible and every query real: no mask
    const bool full = (!causal || kw0 + 15 <= q_first) && p0 + QT <= Sq;

    // Pᵀ = exp(K·Qᵀ·scale − lse), 0 where masked or past Sq
    float pt[NB][4];
    product_t(pt, k_w, q_t);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int col = nb * 8 + tig * 2;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col + (e & 1);
        const bool ok = full || ((!causal || (e < 2 ? key_a : key_b) <= q_first + c) && p0 + c < Sq);
        pt[nb][e] = ok ? exp2f(fmaf(pt[nb][e], scale_log2, -kLog2e * ((e & 1) ? l2.y : l2.x))) : 0.f;
      }
    }
    // dV += bf16(Pᵀ)·dO
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) {
      const unsigned pa[4] = {pack_bf16(pt[2 * j][0], pt[2 * j][1]), pack_bf16(pt[2 * j][2], pt[2 * j][3]),
                              pack_bf16(pt[2 * j + 1][0], pt[2 * j + 1][1]),
                              pack_bf16(pt[2 * j + 1][2], pt[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DB / 2; ++dp) {
        unsigned bf[4];
        load_v_frags(bf, do_t + j * 16 * LD + dp * 16, LD, lane);
        mma_bf16(dv_acc[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(dv_acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    // dPᵀ = V·dOᵀ; dSᵀ = Pᵀ(dPᵀ − delta)·scale rounded to bf16; dK += dSᵀ·Q
    float dpt[NB][4];
    product_t(dpt, v_w, do_t);
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) {
      unsigned da[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nb = 2 * j + half;
        const float2 d2 = *reinterpret_cast<const float2*>(delta_t + nb * 8 + tig * 2);
        da[half * 2] = pack_bf16(pt[nb][0] * (dpt[nb][0] - d2.x) * scale, pt[nb][1] * (dpt[nb][1] - d2.y) * scale);
        da[half * 2 + 1] =
            pack_bf16(pt[nb][2] * (dpt[nb][2] - d2.x) * scale, pt[nb][3] * (dpt[nb][3] - d2.y) * scale);
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

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key_b : key_a;
    const long long off = (((long long)b * Sk + key) * HK + kv) * D + tig * 2;
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
  int B, Sq, Sk, H, HK, D, q_offset, causal;
  float scale() const { return (float)(1.0 / sqrt((double)D)); }
  float scale_log2() const { return (float)(1.4426950408889634 / sqrt((double)D)); }
  int row_tiles() const {  // q tiles of 64 group-major rows
    const int qpb = kRows / (H / HK);
    return (Sq + qpb - 1) / qpb;
  }
  dim3 row_grid() const { return dim3(row_tiles(), HK, B); }  // float32 K1 / K2a: (q tiles, kv heads, batch)
};

template <typename T>
constexpr bool is_bf16 = std::is_same<T, bf16>::value;

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse, const Dims& n, cudaStream_t st) {
  static std::atomic<bool> done[kMaxDevices];
  if constexpr (is_bf16<T>) {
    auto kernel = flash_fwd_kernel_tc<D>;
    constexpr size_t bytes = fwd_tc_bytes<D>();
    cudaError_t err = opt_in(kernel, bytes, done);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(n.B * n.HK, n.row_tiles()), kThreads, bytes, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o),
        lse, n.Sq, n.Sk, n.H, n.HK, n.q_offset, n.causal, n.scale_log2());
  } else {
    auto kernel = flash_fwd_kernel<T, D>;
    cudaError_t err = opt_in(kernel, FwdSmem<T, D>::bytes, done);
    if (err != cudaSuccess) return err;
    kernel<<<n.row_grid(), kThreads, FwdSmem<T, D>::bytes, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), lse, n.Sq,
        n.Sk, n.H, n.HK, n.q_offset, n.causal, n.scale());
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
               void* dq_out, float* delta, const Dims& n, cudaStream_t st) {
  static std::atomic<bool> done[kMaxDevices];
  if constexpr (is_bf16<T>) {
    auto kernel = flash_dq_kernel_tc<D>;
    constexpr size_t bytes = fwd_tc_bytes<D>();
    cudaError_t err = opt_in(kernel, bytes, done);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(n.B * n.HK, n.row_tiles()), kThreads, bytes, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq_out), delta, n.Sq,
        n.Sk, n.H, n.HK, n.q_offset, n.causal, n.scale(), n.scale_log2());
  } else {
    auto kernel = flash_dq_kernel<T, D>;
    cudaError_t err = opt_in(kernel, DqSmem<T, D>::bytes, done);
    if (err != cudaSuccess) return err;
    kernel<<<n.row_grid(), kThreads, DqSmem<T, D>::bytes, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
        static_cast<const T*>(dout), lse, static_cast<T*>(dq_out), delta, n.Sq, n.Sk, n.H, n.HK, n.q_offset,
        n.causal, n.scale());
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dk, void* dv, const Dims& n, cudaStream_t st) {
  static std::atomic<bool> done[kMaxDevices];
  if constexpr (is_bf16<T>) {
    auto kernel = flash_dkv_kernel_tc<D>;
    constexpr size_t bytes = DkvTc<D>::bytes;
    cudaError_t err = opt_in(kernel, bytes, done);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(n.B * n.HK, n.Sk / kRows), kThreads, bytes, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n.Sq, n.Sk, n.H,
        n.HK, n.q_offset, n.causal, n.scale(), n.scale_log2());
  } else {
    auto kernel = flash_dkv_kernel<T, D>;
    cudaError_t err = opt_in(kernel, DkvSmem<T, D>::bytes, done);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(n.Sk / kRows, n.HK, n.B), kThreads, DkvSmem<T, D>::bytes, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
        lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), n.Sq, n.Sk, n.H, n.HK, n.q_offset, n.causal,
        n.scale());
  }
  return cudaGetLastError();
}

// dtype 0 = float32, 1 = bfloat16; head dims 64, 80, 96 and 128
#define DS_FLASH_DISPATCH(FN, ...)                                                   \
  do {                                                                               \
    if (n.H % n.HK || n.H / n.HK > kRows || n.Sk % kRows) return (int)cudaErrorInvalidValue; \
    if (dtype == 1 && n.D == 64) return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__);    \
    if (dtype == 1 && n.D == 80) return (int)FN<__nv_bfloat16, 80>(__VA_ARGS__);    \
    if (dtype == 1 && n.D == 96) return (int)FN<__nv_bfloat16, 96>(__VA_ARGS__);    \
    if (dtype == 1 && n.D == 128) return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__);  \
    if (dtype == 0 && n.D == 64) return (int)FN<float, 64>(__VA_ARGS__);            \
    if (dtype == 0 && n.D == 80) return (int)FN<float, 80>(__VA_ARGS__);            \
    if (dtype == 0 && n.D == 96) return (int)FN<float, 96>(__VA_ARGS__);            \
    if (dtype == 0 && n.D == 128) return (int)FN<float, 128>(__VA_ARGS__);          \
    return (int)cudaErrorInvalidValue;                                               \
  } while (0)

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success).
int ds_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Sq, int Sk, int H,
                 int HK, int D, int q_offset, int causal, int dtype, void* stream) {
  const Dims n{B, Sq, Sk, H, HK, D, q_offset, causal};
  DS_FLASH_DISPATCH(fwd, q, k, v, o, static_cast<float*>(lse), n, static_cast<cudaStream_t>(stream));
}

int ds_flash_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
                void* dq_out, void* delta, int B, int Sq, int Sk, int H, int HK, int D, int q_offset, int causal,
                int dtype, void* stream) {
  const Dims n{B, Sq, Sk, H, HK, D, q_offset, causal};
  DS_FLASH_DISPATCH(dq, q, k, v, o, dout, static_cast<const float*>(lse), dq_out, static_cast<float*>(delta), n,
                    static_cast<cudaStream_t>(stream));
}

int ds_flash_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int B, int Sq, int Sk, int H, int HK, int D, int q_offset, int causal, int dtype,
                 void* stream) {
  const Dims n{B, Sq, Sk, H, HK, D, q_offset, causal};
  DS_FLASH_DISPATCH(dkv, q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta), dk, dv, n,
                    static_cast<cudaStream_t>(stream));
}

const char* ds_flash_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
