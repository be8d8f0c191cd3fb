#!/usr/bin/env python3
"""K5a's lane layouts and two probes of its time, on one CUDA GPU (Hopper;
the sources are built for sm_90a with ``nvcc``).

    python3 scripts/bench_int4_layouts.py

K5a (``deepspeed_tpu_torch/csrc/quant.cu`` ``q4_kernel_256``) packs byte i
of a 256-block's row from elements i and i + 128.  Two bf16 layouts give a
lane both elements of its bytes:

  * ``halves`` (the port's): lane l loads elements 4l..4l+3 and
    128+4l..128+4l+3 with two 8-byte loads (256 contiguous bytes a warp
    instruction) and packs its 4 bytes alone;
  * ``shfl`` (built here from ``quant.cu``'s helpers): lane l loads elements
    8l..8l+7 with one 16-byte load (512 contiguous bytes a warp
    instruction), K4a's bf16 layout, and trades 4 codes with lane l ^ 16,
    which holds the other half, through one ``__shfl_xor_sync``.

Two probes of what bounds ``q4_kernel_256``, in f32 and bf16, on the
``halves`` layout:

  * ``rows2``: two blocks a warp, all four (f32: 16-byte, bf16: 8-byte)
    loads issued before the first reduction, twice the bytes in flight a
    warp and half the CTAs;
  * ``rcp``: x times the rounded reciprocal of the scale in place of the
    correctly rounded divide (``__fdiv_rn``).  Not the port's arithmetic:
    its codes may differ from the plain version's at ties, so it is timed
    only, to show what the divide costs.

``halves``, ``shfl`` and ``rows2`` must give codes and scales identical to
the plain version.  Each variant is timed as ``chip_smoke.py`` times the
kernels (cold L2, mean of 20 launches) at the embedding gradient of
Llama-125M (n = 24,576,000), in turns forward then backward through the
list.  Prints the card's name and power limit, then one JSON object.
"""

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.ops.op_builder import BUILD_DIR, find_nvcc  # noqa: E402
from deepspeed_tpu_torch.ops.op_builder.builder import NVCC_FLAGS  # noqa: E402
from deepspeed_tpu_torch.ops.quant_kernels import quantize_int4_cuda  # noqa: E402
from deepspeed_tpu_torch.ops.quantizer import quantize_int4 as quantize_int4_plain  # noqa: E402

SOURCE = r"""
#include "quant.cu"

namespace {

// bf16 ``shfl``: lane l holds elements 8l..8l+7 (one 16-byte load).  Lanes
// l < 16 hold elements < 128 (the low nibbles of bytes 8l..8l+7), lane l ^ 16
// the elements 128 above them.  Each lane sends the 4 codes its partner
// packs (a low lane its last 4, a high lane its first 4): the low lane writes
// bytes 8l..8l+3, the high lane bytes 8l+4..8l+7, one 4-byte store each.
__global__ void q4_shfl(const __nv_bfloat16* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ scales,
                        long long nblocks) {
  const long long b = (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (b >= nblocks) return;
  const int lane = threadIdx.x & 31;
  float v[8];
  load8(x + b * 256, lane, 256, v);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
  const float scale = warp_absmax_scale(amax, 7.f);
  uint32_t c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = (uint32_t)((int)code(v[i], scale, 7.f) + 8);
  const bool low = lane < 16;
  uint32_t send = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) send |= (low ? c[4 + k] : c[k]) << (4 * k);
  const uint32_t got = __shfl_xor_sync(0xffffffffu, send, 16);
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t other = (got >> (4 * k)) & 0xFu;
    w |= (low ? (c[k] | other << 4) : (other | c[4 + k] << 4)) << (8 * k);
  }
  *reinterpret_cast<uint32_t*>(q + b * 128 + (low ? 8 * lane : 8 * (lane - 16) + 4)) = w;
  if (lane == 0) scales[b] = scale;
}

// ``rows2`` (ROWS = 2) and ``rcp`` (RCP) on the halves layout of q4_kernel_256.
template <typename T, int ROWS, bool RCP>
__global__ void q4_probe(const T* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ scales,
                         long long nblocks) {
  const long long b0 = ((long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5)) * ROWS;
  if (b0 >= nblocks) return;
  const int lane = threadIdx.x & 31;
  float v[ROWS][8];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (b0 + r < nblocks) load_halves(x + (b0 + r) * 256, lane, v[r]);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (b0 + r >= nblocks) break;   // the same on every lane
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[r][i]));
    const float scale = warp_absmax_scale(amax, 7.f);
    const float inv = __frcp_rn(scale);
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float a = RCP ? fminf(fmaxf(rintf(v[r][k] * inv), -7.f), 7.f) : code(v[r][k], scale, 7.f);
      const float c = RCP ? fminf(fmaxf(rintf(v[r][4 + k] * inv), -7.f), 7.f) : code(v[r][4 + k], scale, 7.f);
      w |= ((uint32_t)((int)a + 8) | (uint32_t)((int)c + 8) << 4) << (8 * k);
    }
    reinterpret_cast<uint32_t*>(q + (b0 + r) * 128)[lane] = w;
    if (lane == 0) scales[b0 + r] = scale;
  }
}

template <typename T, int ROWS, bool RCP>
int launch_probe(const void* x, void* q, void* scales, long long nblocks, cudaStream_t s) {
  q4_probe<T, ROWS, RCP><<<grid_for((nblocks + ROWS - 1) / ROWS), kWarpsPerCta * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<uint8_t*>(q), static_cast<float*>(scales), nblocks);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 = shfl (bf16 only), 1 = rows2, 2 = rcp; dtype 0 = f32, 1 = bf16
extern "C" int bench_q4(const void* x, int dtype, int variant, void* q, void* scales, long long nblocks,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((reinterpret_cast<uintptr_t>(x) & 15) != 0) return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    q4_shfl<<<grid_for(nblocks), kWarpsPerCta * 32, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                          static_cast<uint8_t*>(q), static_cast<float*>(scales),
                                                          nblocks);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) return variant == 1 ? launch_probe<float, 2, false>(x, q, scales, nblocks, s)
                                      : launch_probe<float, 1, true>(x, q, scales, nblocks, s);
  return variant == 1 ? launch_probe<__nv_bfloat16, 2, false>(x, q, scales, nblocks, s)
                      : launch_probe<__nv_bfloat16, 1, true>(x, q, scales, nblocks, s);
}
"""
VARIANTS = {"shfl": 0, "rows2": 1, "rcp": 2}


def build() -> ctypes.CDLL:
    """Compile ``SOURCE`` against ``csrc/quant.cu`` into the git-ignored
    build directory and load it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, so = BUILD_DIR / "bench_int4_layouts.cu", BUILD_DIR / f"bench_int4_layouts_{os.getpid()}.so"
    src.write_text(SOURCE)
    csrc = ROOT / "deepspeed_tpu_torch" / "csrc"
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", str(csrc), "-o", str(so), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    lib.bench_q4.argtypes = [p, ctypes.c_int, ctypes.c_int, p, p, ctypes.c_longlong, p]
    lib.bench_q4.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_int4_layouts: no CUDA GPU visible", file=sys.stderr)
        return 2
    smi = cs.card()
    lib = build()
    n, block = cs.QUANT_N, cs.QUANT_BLOCK
    nb = n // block
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    res = {"n": n, "card": smi}
    for dtype, name, seed in ((torch.float32, "f32", 10), (torch.bfloat16, "bf16", 11)):
        x = cs.quant_input(n, dtype, seed=seed)

        def variant(v, x=x):
            def run():
                q = torch.empty((nb, block // 2), dtype=torch.uint8, device="cuda")
                s = torch.empty((nb, ), dtype=torch.float32, device="cuda")
                status = lib.bench_q4(x.data_ptr(), int(x.dtype == torch.bfloat16), v, q.data_ptr(), s.data_ptr(),
                                      nb, torch.cuda.current_stream().cuda_stream)
                if status != 0:
                    raise RuntimeError(f"bench_q4 variant {v}: launch failed ({status})")
                return q, s
            return run

        runs = {"halves": lambda x=x: quantize_int4_cuda(x, block)}
        runs.update({k: variant(v) for k, v in VARIANTS.items() if k != "shfl" or dtype == torch.bfloat16})
        want_q, want_s = quantize_int4_plain(x, block)
        routes = dict(quantize_int4_cuda.routes)
        identical = {}
        for k, fn in runs.items():
            q, s = fn()
            torch.cuda.synchronize()
            identical[k] = torch.equal(q, want_q) and torch.equal(s, want_s)
        took = {k: v - routes[k] for k, v in quantize_int4_cuda.routes.items()}
        exact = [k for k in runs if k != "rcp"]
        if not all(identical[k] for k in exact) or took != {"q4_kernel_256": 1, "q4_kernel_any": 0}:
            raise AssertionError(f"{name}: a layout differs from the plain version {identical}, or K5a took {took}")
        order = list(runs) + list(runs)[::-1]
        ms = {k: [] for k in runs}
        for k in order:
            ms[k].append(cs.time_ms(runs[k], 20, flush))
        res[name] = {"identical_to_plain": identical, "ms": ms,
                     "bound_ms": cs.quant_bounds(n, 2 if dtype == torch.bfloat16 else 4)["quantize_int4"][0]}
        del x
    print(smi)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
