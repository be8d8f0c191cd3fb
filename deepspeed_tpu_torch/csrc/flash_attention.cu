// K1, K2a, K2b: flash attention forward and backward for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/flash_attention.py:
//   K1  flash_fwd_kernel  <- _fwd2_kernel (:162), driven by _flash_fwd2 (:207)
//   K2a flash_dq_kernel   <- _dq2_kernel  (:287), driven by _flash_bwd2 (:340)
//   K2b flash_dkv_kernel  <- _dkv2_kernel (:309), driven by _flash_bwd2 (:340)
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
//        dk = sum of ds^T q; accumulated in shared memory, no atomics, so the
//        result is deterministic.  A kv tile wholly above the causal diagonal
//        has no q tile to visit and writes zeros.
//
// Bound.  Each kernel does O(S·D) flops per row it must move (a causal q row
// meets S/2 keys on average).  At Llama-125M's training shapes (S = 1024,
// D = 64, bf16) that is ~250 flops per byte, just under the ~295 at which
// the H100 turns compute-bound: K1 and K2a are bound by HBM bytes by a hair,
// K2b by tensor-core operations.  At Llama-3-8B's (S = 4096, D = 128) all
// three are operations-bound.  Either way the bound is far below what these
// kernels take: their limit is the shared-memory round trips between the
// products and one or two 4-warp blocks per SM.
//
// Design, and what it does about the bound.  The TPU kernels run a
// sequential grid over a triangular (q block, kv block) table and carry the
// softmax state in VMEM scratch across grid steps.  Here blocks run in
// parallel and share nothing:
//   * K1 and K2a: one block per (q tile, kv head, batch) whose 64 rows are
//     the rep query heads of that kv head at 64/rep consecutive positions
//     (group-major rows), so each K/V tile is staged in shared memory once
//     for all rep heads; the loop over kv tiles stops at the causal diagonal
//     of the block's last row, so tiles above it are never read.  q tiles are
//     launched from the last (longest) to the first to balance the causal
//     triangle.
//   * K2b: one block per (kv tile of 64 keys, kv head, batch); it loops over
//     the rep query heads and the q tiles (32 rows) at or below the diagonal
//     and keeps dk and dv for its 64 keys in shared memory.
//   * Each of the 4 warps owns a 16-row strip of every tile product, so the
//     softmax between the two products of an iteration needs only the warp's
//     own rows: one __syncthreads per staged tile.
//   * The four products run on the tensor cores in bf16 with f32
//     accumulators (nvcuda::wmma 16x16x16 fragments); scores and
//     accumulators pass through shared memory in f32 between products.  The
//     float32 instantiations use plain f32 FMA on the CUDA cores, for
//     float32 training and for checking the algorithm at full precision.
// Later work: wgmma and TMA, register-resident accumulators, a pipelined
// ring of K/V tiles.

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
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;     // rows of a K1/K2a block; keys of a K1/K2a kv tile and of a K2b block
constexpr int kQTile = 32;    // query rows of a K2b q tile
constexpr float kMask = -0.7f * 3.402823466e+38f;

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
    constexpr int CPL = NF / 2;  // columns per lane: 16*NF columns over 32 lanes
    const int lane = threadIdx.x & 31;
    float acc[16][CPL];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i][c] = accumulate ? C[i * ldc + lane + 32 * c] : 0.f;
    for (int kk = 0; kk < KD; ++kk) {
      float b[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int n = lane + 32 * c;
        b[c] = B_COL ? B[n * ldb + kk] : B[kk * ldb + n];
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
      for (int c = 0; c < CPL; ++c) C[i * ldc + lane + 32 * c] = acc[i][c];
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

// ---------------------------------------------------------------- K2a

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
  dim3 row_grid() const {  // K1 / K2a: (q tiles, kv heads, batch)
    const int qpb = kRows / (H / HK);
    return dim3((Sq + qpb - 1) / qpb, HK, B);
  }
};

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse, const Dims& n, cudaStream_t st) {
  static std::atomic<bool> done[kMaxDevices];
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = opt_in(kernel, FwdSmem<T, D>::bytes, done);
  if (err != cudaSuccess) return err;
  kernel<<<n.row_grid(), kThreads, FwdSmem<T, D>::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), lse, n.Sq,
      n.Sk, n.H, n.HK, n.q_offset, n.causal, n.scale());
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
               void* dq_out, float* delta, const Dims& n, cudaStream_t st) {
  static std::atomic<bool> done[kMaxDevices];
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t err = opt_in(kernel, DqSmem<T, D>::bytes, done);
  if (err != cudaSuccess) return err;
  kernel<<<n.row_grid(), kThreads, DqSmem<T, D>::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dq_out), delta, n.Sq, n.Sk, n.H, n.HK, n.q_offset, n.causal,
      n.scale());
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dk, void* dv, const Dims& n, cudaStream_t st) {
  static std::atomic<bool> done[kMaxDevices];
  auto kernel = flash_dkv_kernel<T, D>;
  cudaError_t err = opt_in(kernel, DkvSmem<T, D>::bytes, done);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n.Sk / kRows, n.HK, n.B), kThreads, DkvSmem<T, D>::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
      lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), n.Sq, n.Sk, n.H, n.HK, n.q_offset, n.causal, n.scale());
  return cudaGetLastError();
}

// dtype 0 = float32, 1 = bfloat16; head dims 64 and 128
#define DS_FLASH_DISPATCH(FN, ...)                                                   \
  do {                                                                               \
    if (n.H % n.HK || n.H / n.HK > kRows || n.Sk % kRows) return (int)cudaErrorInvalidValue; \
    if (dtype == 1 && n.D == 64) return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__);    \
    if (dtype == 1 && n.D == 128) return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__);  \
    if (dtype == 0 && n.D == 64) return (int)FN<float, 64>(__VA_ARGS__);            \
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
