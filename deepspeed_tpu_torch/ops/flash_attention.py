"""Flash attention for training: the op, its plain versions and the wrappers
of the hand-written CUDA kernels ``csrc/flash_attention.cu``.

Port of ``deepspeed_tpu/ops/flash_attention.py``.  The kernels replace the
Pallas TPU kernels of that module:

  K1  ``flash_fwd_cuda``   ← ``_fwd2_kernel`` (:162), driven by ``_flash_fwd2``
  K2a ``flash_dq_cuda``    ← ``_dq2_kernel``  (:287), driven by ``_flash_bwd2``
  K2b ``flash_dkv_cuda``   ← ``_dkv2_kernel`` (:309), driven by ``_flash_bwd2``

``flash_attention`` takes q ``[B, Sq, H, D]`` and k/v ``[B, Sk, HK, D]`` (the
JAX layout; the kernels read the same memory as the packed ``[B, S, N·D]``
view), head dims 64, 80, 96 and 128.  GQA is native: query head ``h`` reads
kv head ``h // (H // HK)`` and K/V are not repeated, as long as a kv head's
query heads fit one block of the kernels (``MAX_REP`` = 64).  Beyond that
(Falcon-7B's 71 query heads on one kv head) each wrapper takes JAX's
repeated-KV route (``flash_attention.py:114-128``, ``:425-427``): K and V are
repeated to H heads before the kernel, and K2b's dk and dv are summed back
over each kv head's repeats (``:457``) in a fixed order.  Query row ``i``
sits at position ``q_offset + i``; with ``causal`` it sees the keys at
positions ``<= q_offset + i``.

The forward and the backward are ``torch.library`` custom ops
(``ds_torch::flash_fwd`` and ``ds_torch::flash_bwd``), so that a selective
activation-checkpoint policy can name the forward and save its ``(o, lse)``
(``models/llama.py`` remat policy ``flash_saveable``): the backward then
launches K2a and K2b against the saved outputs and K1 runs once per layer.

Each op dispatches on the device of its inputs: a CUDA tensor launches the
kernels or raises (an unsupported head dim or dtype included); a CPU tensor
runs the plain version.  The plain versions compute what the kernels
compute, with the same rounding points: p is rounded to v's dtype before the
PV and ``pᵀ·dO`` products, ``delta = rowsum(dO·O)`` and every product
accumulate in float32, ``ds = p·(dp − delta)·scale`` is rounded to the input
dtype before the dq and dk products.

lse is kept as ``[B, H, Sq]`` float32.  The JAX kernels store it
lane-broadcast as ``[B, H, Sq, 128]`` (in bf16 for bf16 inputs): that is a
tiling artifact of the TPU's 128-lane vector registers, not part of the
algorithm.
"""

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from .attention import chunked_attention
from .op_builder import load_kernel

#: finite mask value of the JAX kernels (``DEFAULT_MASK_VALUE``): a row with
#: every key masked in one tile never forms ``-inf − (−inf)``
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
#: sequence lengths the kernels take (``flash_attention.py:525-534``):
#: anything else goes to ``chunked_attention``
SEQ_MULTIPLE = 128
SUPPORTED_HEAD_DIMS = (64, 80, 96, 128)
#: query heads one kv head's block of K1/K2a/K2b takes (``kRows`` of
#: ``csrc/flash_attention.cu``); more take the repeated-KV route
MAX_REP = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# ---------------------------------------------------------------- plain versions


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int) -> torch.Tensor:
    """Scaled, masked float32 scores ``[B, HK, rep, Sq, Sk]``."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hk, h // hk, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * (1.0 / math.sqrt(d))
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        keep = torch.arange(sk, device=q.device)[None, :] <= qpos[:, None]
        s = torch.where(keep, s, MASK_VALUE)
    return s


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K1 computes: ``(o [B, Sq, H, D] in q's dtype, lse [B, H, Sq] f32)``."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    s = _scores(q, k, causal, q_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype).float(), v.float())
    o = (acc / l.permute(0, 3, 1, 2, 4)).reshape(b, sq, h, d).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b, h, sq)
    return o, lse


def flash_delta_plain(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO·O)`` as K2a writes it: ``[B, H, Sq]`` float32."""
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                    do: torch.Tensor, causal: bool = True,
                    q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What K2a and K2b compute: ``(dq, dk, dv)`` in the inputs' dtype; dk and
    dv are summed over the ``rep`` query heads of each kv head."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    rep = h // hk
    scale = 1.0 / math.sqrt(d)
    s = _scores(q, k, causal, q_offset)
    p = torch.exp(s - lse.reshape(b, hk, rep, sq, 1))
    dog = do.reshape(b, sq, hk, rep, d)
    delta = flash_delta_plain(o, do).reshape(b, hk, rep, sq, 1)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog.float(), v.float())
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, k.float()).reshape(b, sq, h, d).to(q.dtype)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, q.reshape(b, sq, hk, rep, d).float()).to(k.dtype)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p.to(v.dtype).float(), dog.float()).to(v.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------- kernel wrappers


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures."""
    lib = load_kernel("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    dims = [i] * 8   # B, Sq, Sk, H, HK, D, q_offset, causal
    lib.ds_flash_fwd.argtypes = [p] * 5 + dims + [i, p]
    lib.ds_flash_dq.argtypes = [p] * 8 + dims + [i, p]
    lib.ds_flash_dkv.argtypes = [p] * 8 + dims + [i, p]
    for fn in (lib.ds_flash_fwd, lib.ds_flash_dq, lib.ds_flash_dkv):
        fn.restype = i
    lib.ds_flash_error_string.argtypes = [i]
    lib.ds_flash_error_string.restype = ctypes.c_char_p
    return lib


def kernel_kv_heads(h: int, hk: int) -> int:
    """The kv heads K1/K2a/K2b run over for H query heads on HK kv heads:
    HK, or H on the repeated-KV route (more than ``MAX_REP`` query heads a
    kv head, as JAX's ``_gqa_native_ok`` sends Falcon-7B's 71:1 there)."""
    return hk if h // hk <= MAX_REP else h


def check_shapes(name: str, q_shape, k_shape, v_shape) -> None:
    """Raise ``ValueError`` on q/k/v shapes the kernels do not take, after
    the repeated-KV route: the head dim, GQA's H a multiple of HK, the key
    length a multiple of 64."""
    if len(q_shape) != 4 or len(k_shape) != 4 or tuple(k_shape) != tuple(v_shape):
        raise ValueError(f"{name}: q must be [B, Sq, H, D] and k/v [B, Sk, HK, D], "
                         f"got {tuple(q_shape)}, {tuple(k_shape)}, {tuple(v_shape)}")
    b, sq, h, d = q_shape
    _, sk, hk, dk = k_shape
    if k_shape[0] != b or dk != d or h % hk:
        raise ValueError(f"{name}: k/v {tuple(k_shape)} do not fit q {tuple(q_shape)} (GQA needs H a multiple "
                         f"of HK)")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if sk % 64:
        raise ValueError(f"{name}: key length {sk} is not a multiple of 64")


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *rest: torch.Tensor) -> None:
    """Raise on anything the kernels do not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{name} needs CUDA tensors, got q on {q.device}, k on {k.device}, v on {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes bfloat16 or float32 q/k/v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    check_shapes(name, q.shape, k.shape, v.shape)
    for t in (q, k, v) + rest:
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: every tensor must be contiguous, 16-byte aligned and on {q.device}")


def _launch(name: str, fn, *args) -> None:
    dev = torch.cuda.current_device()
    status = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name}: launch failed: {_lib().ds_flash_error_string(status).decode()}")


def _check_offset(name: str, q_offset: int) -> None:
    """A negative offset leaves causal rows with no visible key, which no
    route defines alike (the JAX table gives their block no kv block), so
    every wrapper refuses it."""
    if int(q_offset) < 0:
        raise ValueError(f"{name}: q_offset must be >= 0, got {q_offset}")


def _dims(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int):
    b, sq, h, d = q.shape
    return (b, sq, k.shape[1], h, k.shape[2], d, int(q_offset), int(bool(causal)), _DTYPE_CODES[q.dtype])


def _on_device(t: torch.Tensor):
    return torch.cuda.device(t.device)   # the kernels launch on the current device


def _kernel_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K and V as the kernels take them: repeated to H heads on the
    repeated-KV route (``kernel_kv_heads``), else unchanged."""
    h, hk = q.shape[2], k.shape[2]
    if kernel_kv_heads(h, hk) == hk:
        return k, v
    return k.repeat_interleave(h // hk, dim=2), v.repeat_interleave(h // hk, dim=2)


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                   q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1: ``(o [B, Sq, H, D], lse [B, H, Sq] f32)``."""
    _check_offset("flash_fwd_cuda", q_offset)
    _check("flash_fwd_cuda", q, k, v)
    k, v = _kernel_kv(q, k, v)
    b, sq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if q.numel():
        with _on_device(q):
            _launch("flash_fwd_cuda", _lib().ds_flash_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), *_dims(q, k, causal, q_offset))
        flash_fwd_cuda.launches += 1
    return o, lse


def flash_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                  do: torch.Tensor, causal: bool = True, q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2a: ``(dq [B, Sq, H, D], delta [B, H, Sq] f32)``; K2b reads delta."""
    _check_offset("flash_dq_cuda", q_offset)
    _check("flash_dq_cuda", q, k, v, o, lse, do)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (q.shape[0], q.shape[2], q.shape[1]) \
            or o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError("flash_dq_cuda: o and do must match q, lse must be [B, H, Sq] float32")
    k, v = _kernel_kv(q, k, v)
    b, sq, h, _ = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if q.numel():
        with _on_device(q):
            _launch("flash_dq_cuda", _lib().ds_flash_dq, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), *_dims(q, k, causal, q_offset))
        flash_dq_cuda.launches += 1
    return dq, delta


def flash_dkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                   delta: torch.Tensor, causal: bool = True,
                   q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2b: ``(dk, dv) [B, Sk, HK, D]``, summed over each kv head's
    query heads in the block (no atomics: deterministic); on the
    repeated-KV route the kernel's per-query-head dk and dv are then summed
    over each kv head's repeats (one reduction, a fixed order)."""
    _check_offset("flash_dkv_cuda", q_offset)
    _check("flash_dkv_cuda", q, k, v, do, lse, delta)
    stat = (q.shape[0], q.shape[2], q.shape[1])
    if do.shape != q.shape or do.dtype != q.dtype or lse.shape != stat or delta.shape != stat \
            or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError("flash_dkv_cuda: do must match q, lse and delta must be [B, H, Sq] float32")
    b, sk, hk, d = k.shape
    k, v = _kernel_kv(q, k, v)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if k.numel():
        with _on_device(q):
            _launch("flash_dkv_cuda", _lib().ds_flash_dkv, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_dims(q, k, causal, q_offset))
        flash_dkv_cuda.launches += 1
    if k.shape[2] != hk:   # the repeated-KV route: sum each kv head's repeats
        dk, dv = (t.view(b, sk, hk, -1, d).sum(dim=3) for t in (dk, dv))
    return dk, dv


#: launches of each kernel since its counter was last set to 0
flash_fwd_cuda.launches = 0
flash_dq_cuda.launches = 0
flash_dkv_cuda.launches = 0

# ---------------------------------------------------------------- custom ops


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention: unsupported device {t.device}")
    return t.device.type


@torch.library.custom_op("ds_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on a CUDA tensor, ``flash_fwd_plain`` on a CPU tensor."""
    _check_offset("flash_fwd", q_offset)
    if _device_kind(q) == "cuda":
        return flash_fwd_cuda(q, k, v, causal, q_offset)
    return flash_fwd_plain(q, k, v, causal, q_offset)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, causal, q_offset):
    b, sq, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, sq), dtype=torch.float32)


@torch.library.custom_op("ds_torch::flash_bwd", mutates_args=())
def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
              do: torch.Tensor, causal: bool, q_offset: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2a then K2b on a CUDA tensor, ``flash_bwd_plain`` on a CPU tensor."""
    _check_offset("flash_bwd", q_offset)
    if _device_kind(q) == "cuda":
        dq, delta = flash_dq_cuda(q, k, v, o, lse, do, causal, q_offset)
        dk, dv = flash_dkv_cuda(q, k, v, do, lse, delta, causal, q_offset)
        return dq, dk, dv
    return flash_bwd_plain(q, k, v, o, lse, do, causal, q_offset)


@flash_bwd.register_fake
def _flash_bwd_fake(q, k, v, o, lse, do, causal, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, q_offset = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.q_offset = causal, q_offset


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), ctx.causal, ctx.q_offset)
    return dq, dk, dv, None, None


flash_fwd.register_autograd(_backward, setup_context=_setup_context)

# ---------------------------------------------------------------- public op


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None, sliding_window: int = 0,
                    q_position_offset: int = 0) -> torch.Tensor:
    """Flash attention over q ``[B, Sq, H, D]``, k/v ``[B, Sk, HK, D]`` → ``[B, Sq, H, D]``.

    Dispatch follows the JAX op (``flash_attention.py:525-534``): a mask
    (``segment_ids``, ``sliding_window``) or a sequence length that is not a
    multiple of 128 takes ``chunked_attention``, and ``q_position_offset``
    with either raises, as does a negative offset.  Everything else goes through ``ds_torch::flash_fwd``
    (K1 on a GPU) with K2a/K2b as its gradient.
    """
    _check_offset("flash_attention", q_position_offset)
    if segment_ids is not None or (sliding_window and sliding_window > 0) \
            or q.shape[1] % SEQ_MULTIPLE or k.shape[1] % SEQ_MULTIPLE:
        if q_position_offset:
            raise ValueError("q_position_offset requires 128-aligned seq lens and no segment/window masks "
                             "(the chunked path has no offset)")
        return chunked_attention(q, k, v, causal=causal, segment_ids=segment_ids, sliding_window=sliding_window)
    return flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), causal, int(q_position_offset))[0]
