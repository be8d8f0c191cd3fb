"""K3 paged attention: the wrapper of the hand-written CUDA kernels in
``csrc/paged_attention.cu``, which replace the Pallas TPU kernel
``deepspeed_tpu/ops/paged_attention.py:40 _paged_kernel``.

``paged_attention`` is the op the serving path calls: a CUDA tensor goes
to the kernel (``paged_attention_cuda``), which launches or raises; a CPU
tensor goes to the plain PyTorch version
(``models/llama_cache.paged_attention``).  There is no fallback from one to
the other.

bfloat16 runs on the tensor cores.  Its CTA owns a tile of ``tile_rows``
query rows of one (sequence, kv head), position-major (``tile_row``); when
the grid is small the context is split over ``n_split`` CTAs per tile
(``choose_n_split``, from shapes only: the context lengths live on the
device), each writes a partial ``(m, l, O)`` and a second kernel merges them
(plain version ``merge_partials_plain``).  float32 runs the scalar kernel,
unsplit.

Head dims 64, 80, 96 and 128; any other raises (the Pallas kernel packs any
D: ROADMAP Queue 2).  ``sliding_window`` (Mistral) and ``alibi_slopes``
(Falcon-RW) select the kernels' masked variants, one per call, on both
routes: a split past a row's window writes an empty partial (m = -inf) and
the merge drops it, so windowed decodes split as full ones do.
"""

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from ..models.llama_cache import paged_attention as paged_attention_plain
from .op_builder import load_kernel

SUPPORTED_HEAD_DIMS = (64, 80, 96, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: keys of one KV tile; a split covers a multiple of it
KEYS_PER_TILE = 64
#: the context is split while the grid has fewer CTAs than this: three per
#: SM of an H100 SXM (132 SMs, two bf16 CTAs of 102 KB resident on each),
#: a wave and a half, as splits past a row's last key exit at once.  Of the
#: split counts 1-8, this rule picks within 2% of the fastest at 16 and 4
#: decode rows of mixed lengths and within 7% at 16 rows of 2000 keys each
#: (chip_smoke.py phase 2's sweep and PERF.md)
SPLIT_GRID_CTAS = 3 * 132
#: the fewest keys a split may cover, and the most scratch the partials may take
SPLIT_MIN_KEYS = 256
SPLIT_SCRATCH_BYTES = 64 << 20


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures."""
    lib = load_kernel("paged_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_paged_attention.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ll, ll, ll, i, i, i, i, i, p, p]
    lib.ds_paged_attention.restype = i
    lib.ds_paged_merge.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.ds_paged_merge.restype = i
    lib.ds_paged_mma_probe.argtypes = [p, p, p, p, p, p]
    lib.ds_paged_mma_probe.restype = i
    lib.ds_cuda_error_string.argtypes = [i]
    lib.ds_cuda_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------- shapes


def tile_rows(rep: int, c: int) -> int:
    """Query rows of one CTA: 16 when a (sequence, kv head) has at most 16
    rows (decode: the four warps then split each key tile), else 64 (one warp
    per 16 rows)."""
    return 16 if rep * c <= 16 else 64


def tile_row(tile: int, i: int, rep: int, rows: int) -> Tuple[int, int]:
    """Row ``i`` of row tile ``tile`` (position-major inside a kv group):
    its chunk position and its head's offset in the group, ``h = kv·rep + r``."""
    g = tile * rows + i
    return g // rep, g % rep


def choose_n_split(b: int, c: int, h: int, n_kv: int, d: int, max_keys: int) -> int:
    """How many CTAs share a row tile's context, from shapes only: grow while
    the grid is under SPLIT_GRID_CTAS CTAs, at most one split per
    SPLIT_MIN_KEYS keys of the block table's capacity, and within
    SPLIT_SCRATCH_BYTES of f32 partials."""
    rep = h // n_kv
    rows = tile_rows(rep, c)
    ctas = b * n_kv * -(-rep * c // rows)
    cap = max(1, min(max_keys // SPLIT_MIN_KEYS, SPLIT_SCRATCH_BYTES // (4 * b * c * h * (d + 2))))
    n = 1
    while n < cap and ctas * n < SPLIT_GRID_CTAS:
        n += 1
    return n


def split_len(max_keys: int, n_split: int) -> int:
    """Keys of one split: the block table's capacity over ``n_split``,
    rounded up to whole KV tiles."""
    per = -(-max(max_keys, 1) // n_split)
    return -(-per // KEYS_PER_TILE) * KEYS_PER_TILE


# ---------------------------------------------------------------- plain versions of the split route


def paged_attention_partials_plain(q: torch.Tensor, pages: torch.Tensor, block_table: torch.Tensor,
                                   start_pos: torch.Tensor, chunk_lens: Optional[torch.Tensor], page_size: int,
                                   n_split: int, sliding_window: int = 0,
                                   alibi_slopes: Optional[torch.Tensor] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The partials of the split route, plainly: split s covers keys
    [s·L, (s+1)·L) (``split_len``); for each row, m_s = max of its visible
    logits there in base 2 ((s + slope·k)·log2(e)/sqrt(D), -inf where it
    sees none; a window hides k <= qpos − window), l_s = Σ 2^(s − m_s) in
    f32, O_s = Σ p·v with p rounded to V's dtype.  Returns m, l [n_split,
    B, C, H] and O [n_split, B, C, H, D], float32; rows at c >= chunk_lens
    have m = -inf."""
    b, c, h, d = q.shape
    max_pages = block_table.shape[1]
    n_kv = pages.shape[3]
    s_kv = max_pages * page_size
    g = pages[block_table.reshape(-1).long()].reshape(b, s_kv, 2, n_kv, d)
    k = g[:, :, 0].repeat_interleave(h // n_kv, dim=2)
    v = g[:, :, 1].repeat_interleave(h // n_kv, dim=2)
    kpos = torch.arange(s_kv, device=q.device)
    logits = torch.einsum("bcnd,bknd->bcnk", q.float(), k.float())
    if alibi_slopes is not None:
        logits = logits + alibi_slopes.float()[:, None] * kpos.float()
    logits = logits * (math.log2(math.e) / math.sqrt(d))
    ar = torch.arange(c, device=q.device)
    qpos = start_pos.long()[:, None] + ar[None, :]                                     # [B, C]
    if chunk_lens is not None:
        qpos = torch.where(ar[None, :] < chunk_lens.long()[:, None], qpos, -1)
    visible = kpos[None, None, :] <= qpos[..., None]                                   # [B, C, S_kv]
    if sliding_window:
        visible = visible & (kpos[None, None, :] > qpos[..., None] - sliding_window)
    length = split_len(s_kv, n_split)
    ms, ls, os_ = [], [], []
    for s in range(n_split):
        keys = (kpos >= s * length) & (kpos < (s + 1) * length)
        vis = (visible & keys)[:, :, None, :]                                          # [B, C, 1, S_kv]
        lg = torch.where(vis, logits, -math.inf)
        m = lg.amax(-1)                                                                # [B, C, H]
        p = torch.where(vis, torch.exp2(lg - torch.where(m == -math.inf, 0.0, m)[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        os_.append(torch.einsum("bcnk,bknd->bcnd", p.to(v.dtype).float(), v.float()))
    return torch.stack(ms), torch.stack(ls), torch.stack(os_)


def merge_partials_plain(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                         chunk_lens: Optional[torch.Tensor]) -> torch.Tensor:
    """The merge kernel's function, plainly: out = Σ_s 2^(m_s − M) O_s /
    Σ_s 2^(m_s − M) l_s with M = max_s m_s; a split with m_s = -inf adds
    nothing (its O_s is not read); rows at c >= chunk_lens and rows that no
    split saw are zeros.  m, l [S, B, C, H], o [S, B, C, H, D]; float32 out
    [B, C, H, D]."""
    big = m.amax(0)                                                                    # [B, C, H]
    live = m != -math.inf
    w = torch.where(live, torch.exp2(m - torch.where(big == -math.inf, 0.0, big)), 0.0)
    den = (w * l).sum(0)
    num = (w[..., None] * torch.where(live[..., None], o, 0.0)).sum(0)
    valid = big != -math.inf
    if chunk_lens is not None:
        c = m.shape[2]
        valid = valid & (torch.arange(c, device=m.device)[None, :, None] < chunk_lens.long()[:, None, None])
    return torch.where(valid[..., None], num / torch.where(valid, den, 1.0)[..., None], 0.0)


# ---------------------------------------------------------------- the kernels


def _check_index(name: str, t: torch.Tensor, shape, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"paged_attention_cuda: {name} must be a contiguous int32 tensor of shape {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _raise_on(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: launch failed: {_lib().ds_cuda_error_string(status).decode()}")


def _on_device(dev: torch.device, launch) -> int:
    if dev.index == torch.cuda.current_device():
        return launch()
    with torch.cuda.device(dev):   # the kernels launch on the current device
        return launch()


def _checked(q, pages, block_table, start_pos, chunk_lens, page_size):
    """The shapes of a call, after checking what the kernels take."""
    if not (q.is_cuda and pages.is_cuda):
        raise ValueError(f"paged_attention_cuda needs CUDA tensors, got q on {q.device}, pages on {pages.device}")
    dev = q.device
    if pages.device != dev:
        raise ValueError(f"paged_attention_cuda: q on {dev} but pages on {pages.device}")
    if q.dtype not in _DTYPE_CODES or pages.dtype != q.dtype:
        raise ValueError(f"paged_attention_cuda takes bfloat16 or float32 q and pages of one dtype, "
                         f"got {q.dtype} and {pages.dtype}")
    if q.dim() != 4 or pages.dim() != 5:
        raise ValueError(f"paged_attention_cuda: q must be [B, C, H, D] and pages [P, page, 2, n_kv, D], "
                         f"got {tuple(q.shape)} and {tuple(pages.shape)}")
    b, c, h, d = q.shape
    _, ps, two, n_kv, pd = pages.shape
    if ps != page_size or two != 2 or pd != d or h % n_kv:
        raise ValueError(f"paged_attention_cuda: pages {tuple(pages.shape)} do not fit q {tuple(q.shape)} "
                         f"with page_size {page_size}")
    vec = 16 // q.element_size()   # the kernels copy 16-byte vectors of q and pages
    if (q.stride(-1) != 1 or any(s % vec for s in q.stride()[:3]) or q.data_ptr() % 16 or not pages.is_contiguous()
            or pages.data_ptr() % 16):
        raise ValueError("paged_attention_cuda: q needs a unit last stride, the others multiples of 16 bytes, "
                         "and q and pages 16-byte-aligned buffers, pages contiguous")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"paged_attention_cuda: head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    max_pages = block_table.shape[1] if block_table.dim() == 2 else -1
    _check_index("block_table", block_table, (b, max_pages), dev)
    _check_index("start_pos", start_pos, (b, ), dev)
    if chunk_lens is None:
        chunk_lens = torch.full((b, ), c, dtype=torch.int32, device=dev)
    _check_index("chunk_lens", chunk_lens, (b, ), dev)
    return dev, b, c, h, d, n_kv, max_pages, chunk_lens


def _check_masks(sliding_window: int, alibi_slopes: Optional[torch.Tensor], h: int, dev: torch.device) -> None:
    """A window and alibi slopes as the kernels take them: one or neither;
    slopes a contiguous float32 [H] tensor on the card."""
    if sliding_window < 0 or (sliding_window and alibi_slopes is not None):
        raise ValueError(f"paged_attention_cuda takes a sliding window >= 0 or alibi slopes, not both "
                         f"(window {sliding_window})")
    if alibi_slopes is not None and (alibi_slopes.device != dev or alibi_slopes.dtype != torch.float32
                                     or not alibi_slopes.is_contiguous() or tuple(alibi_slopes.shape) != (h, )):
        raise ValueError(f"paged_attention_cuda: alibi_slopes must be a contiguous float32 tensor of shape ({h},) "
                         f"on {dev}, got {alibi_slopes.dtype} {tuple(alibi_slopes.shape)} on {alibi_slopes.device}")


def _launch_attention(q, pages, block_table, start_pos, chunk_lens, page_size, shapes, out, partials, n_split,
                      sliding_window=0, alibi_slopes=None):
    """The first kernel on checked inputs: writes ``out`` (n_split 1) or
    the partials (m, l, O)."""
    dev, b, c, h, d, n_kv, max_pages = shapes
    lib = _lib()
    part_m, part_l, part_o = (t.data_ptr() for t in partials) if partials is not None else (None, None, None)
    length = split_len(max_pages * page_size, n_split)

    def launch() -> int:
        return lib.ds_paged_attention(q.data_ptr(), pages.data_ptr(), block_table.data_ptr(), start_pos.data_ptr(),
                                      chunk_lens.data_ptr(), None if out is None else out.data_ptr(), part_m, part_l,
                                      part_o, b, c, h, n_kv, d, page_size, max_pages, q.stride(0), q.stride(1),
                                      q.stride(2), _DTYPE_CODES[q.dtype], tile_rows(h // n_kv, c), n_split, length,
                                      sliding_window, None if alibi_slopes is None else alibi_slopes.data_ptr(),
                                      torch.cuda.current_stream(dev).cuda_stream)

    _raise_on(_on_device(dev, launch), "paged_attention_cuda")


def _empty_partials(b, c, h, d, n_split, dev):
    m = torch.empty((n_split, b, c, h), dtype=torch.float32, device=dev)
    return m, torch.empty_like(m), torch.empty((n_split, b, c, h, d), dtype=torch.float32, device=dev)


def _launch_merge(m, l, o, chunk_lens, out) -> None:
    """The merge kernel on checked inputs."""
    n_split, b, c, h, d = o.shape
    dev = o.device
    lib = _lib()
    _raise_on(
        _on_device(
            dev, lambda: lib.ds_paged_merge(m.data_ptr(), l.data_ptr(), o.data_ptr(), chunk_lens.data_ptr(),
                                            out.data_ptr(), n_split, b, c, h, d,
                                            torch.cuda.current_stream(dev).cuda_stream)), "merge_partials_cuda")


def paged_attention_partials_cuda(q: torch.Tensor, pages: torch.Tensor, block_table: torch.Tensor,
                                  start_pos: torch.Tensor, chunk_lens: Optional[torch.Tensor], page_size: int,
                                  n_split: int, sliding_window: int = 0,
                                  alibi_slopes: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first kernel of the split route alone (bfloat16, ``n_split`` > 1):
    the partials ``paged_attention_partials_plain`` computes, m and l
    [n_split, B, C, H] and O [n_split, B, C, H, D], float32."""
    dev, b, c, h, d, n_kv, max_pages, chunk_lens = _checked(q, pages, block_table, start_pos, chunk_lens, page_size)
    _check_masks(sliding_window, alibi_slopes, h, dev)
    if q.dtype != torch.bfloat16 or n_split < 2:
        raise ValueError(f"paged_attention_partials_cuda: the split route takes bfloat16 and n_split > 1, "
                         f"got {q.dtype} and {n_split}")
    partials = _empty_partials(b, c, h, d, n_split, dev)
    if partials[2].numel():
        _launch_attention(q, pages, block_table, start_pos, chunk_lens, page_size, (dev, b, c, h, d, n_kv, max_pages),
                          None, partials, n_split, sliding_window, alibi_slopes)
    return partials


def merge_partials_cuda(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, chunk_lens: torch.Tensor,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The merge kernel (plain version ``merge_partials_plain``): out [B, C,
    H, D] in bfloat16 from contiguous float32 partials."""
    n_split, b, c, h, d = o.shape
    dev = o.device
    if dtype != torch.bfloat16 or d not in SUPPORTED_HEAD_DIMS or not o.is_cuda:
        raise ValueError(f"merge_partials_cuda writes bfloat16 from CUDA partials of head dim "
                         f"{SUPPORTED_HEAD_DIMS}, got {dtype}, {d}, {dev}")
    for name, t, shape in (("m", m, (n_split, b, c, h)), ("l", l, (n_split, b, c, h)), ("o", o, o.shape)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
            raise ValueError(f"merge_partials_cuda: {name} must be a contiguous float32 tensor of shape "
                             f"{tuple(shape)} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    _check_index("chunk_lens", chunk_lens, (b, ), dev)
    out = torch.empty((b, c, h, d), dtype=dtype, device=dev)
    if out.numel():
        _launch_merge(m, l, o, chunk_lens, out)
    return out


def mma_probe_cuda(a: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One m16n8k16 product through the kernel's fragment loaders: a·kᵀ and
    a·v in float32 for bfloat16 a [16, 16], k [8, 16], v [16, 8] on the card."""
    shapes = {"a": (a, (16, 16)), "k": (k, (8, 16)), "v": (v, (16, 8))}
    for name, (t, shape) in shapes.items():
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"mma_probe_cuda: {name} must be a contiguous bfloat16 CUDA tensor of shape {shape}")
    c1 = torch.empty((16, 8), dtype=torch.float32, device=a.device)
    c2 = torch.empty_like(c1)
    lib = _lib()
    _raise_on(
        _on_device(
            a.device, lambda: lib.ds_paged_mma_probe(a.data_ptr(), k.data_ptr(), v.data_ptr(), c1.data_ptr(),
                                                     c2.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)),
        "mma_probe_cuda")
    return c1, c2


def paged_attention_cuda(q: torch.Tensor, pages: torch.Tensor, block_table: torch.Tensor, start_pos: torch.Tensor,
                         chunk_lens: Optional[torch.Tensor], page_size: int, n_split: Optional[int] = None,
                         sliding_window: int = 0, alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K3 on ``torch.cuda.current_stream()``.

    q: [B, C, H, D] (unit last stride, D in ``SUPPORTED_HEAD_DIMS``); pages:
    [P, page_size, 2, n_kv, D] contiguous, q's dtype (bfloat16 or float32);
    block_table: [B, max_pages], start_pos / chunk_lens: [B], int32.
    ``chunk_lens=None`` means every row is real.  ``n_split`` (bfloat16)
    overrides ``choose_n_split``; float32 takes 1 only.  ``sliding_window``
    > 0 hides keys k <= qpos − window; ``alibi_slopes`` (float32 [H] on the
    card) adds slope·k·scale to the scaled logits; not both.  Returns out
    [B, C, H, D].  Raises on anything the kernels do not take and on a
    launch that fails.  The block table's entries must be page ids below P;
    they stay on the device, unchecked, as checking them would synchronise
    with it.
    """
    dev, b, c, h, d, n_kv, max_pages, chunk_lens = _checked(q, pages, block_table, start_pos, chunk_lens, page_size)
    _check_masks(sliding_window, alibi_slopes, h, dev)
    if q.dtype == torch.float32:
        if n_split not in (None, 1):
            raise ValueError("paged_attention_cuda: float32 runs unsplit")
        n_split = 1
    elif n_split is None:
        n_split = choose_n_split(b, c, h, n_kv, d, max_pages * page_size)
    if n_split < 1:
        raise ValueError(f"paged_attention_cuda: n_split must be >= 1, got {n_split}")
    out = torch.empty((b, c, h, d), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    shapes = (dev, b, c, h, d, n_kv, max_pages)
    if n_split == 1:
        _launch_attention(q, pages, block_table, start_pos, chunk_lens, page_size, shapes, out, None, 1,
                          sliding_window, alibi_slopes)
    else:
        partials = _empty_partials(b, c, h, d, n_split, dev)
        _launch_attention(q, pages, block_table, start_pos, chunk_lens, page_size, shapes, None, partials, n_split,
                          sliding_window, alibi_slopes)
        _launch_merge(*partials, chunk_lens, out)
        paged_attention_cuda.split_calls += 1
    paged_attention_cuda.launches += 1
    return out


#: calls of K3 (one per layer per forward) since the counter was last set to 0
paged_attention_cuda.launches = 0
#: of those, the calls that took the split-and-merge route
paged_attention_cuda.split_calls = 0


def paged_attention(q: torch.Tensor, pages: torch.Tensor, block_table: torch.Tensor, start_pos: torch.Tensor,
                    chunk_lens: Optional[torch.Tensor], page_size: int, sliding_window: int = 0,
                    alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 on a CUDA tensor, the plain PyTorch version on a CPU tensor."""
    if q.is_cuda:
        return paged_attention_cuda(q, pages, block_table, start_pos, chunk_lens, page_size,
                                    sliding_window=sliding_window, alibi_slopes=alibi_slopes)
    if q.device.type == "cpu":
        return paged_attention_plain(q, pages, block_table, start_pos, chunk_lens, page_size,
                                     sliding_window=sliding_window, alibi_slopes=alibi_slopes)
    raise ValueError(f"paged_attention: unsupported device {q.device}")
