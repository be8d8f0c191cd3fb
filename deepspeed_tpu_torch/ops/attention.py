"""Plain attention in PyTorch ops: ``reference_attention`` (full scores) and
``chunked_attention`` (query chunks), ports of the JAX functions of
``deepspeed_tpu/models/llama.py``.

Both take q ``[B, Sq, H, D]`` and k/v ``[B, Sk, KV, D]`` and repeat each kv
head over its query group.  The cache-free Llama model selects them by
``attention_impl`` (``models/llama.py``); ``ops/flash_attention.py`` sends
its masked and unaligned inputs to ``chunked_attention``.
"""

import math
from typing import Optional

import torch


def _repeat_kv(k: torch.Tensor, v: torch.Tensor, nh: int):
    nkv = k.shape[2]
    if nkv == nh:
        return k, v
    return k.repeat_interleave(nh // nkv, dim=2), v.repeat_interleave(nh // nkv, dim=2)


def _mask_scores(s: torch.Tensor, qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, sliding_window: int,
                 q_seg: Optional[torch.Tensor], k_seg: Optional[torch.Tensor]) -> torch.Tensor:
    """Scores [B, N, Q, K] with the causal / window / segment masks at -1e30."""
    if causal:
        mask = qpos[:, None] >= kpos[None, :]
        if sliding_window and sliding_window > 0:
            mask = mask & (kpos[None, :] > qpos[:, None] - sliding_window)
        s = torch.where(mask, s, -1e30)
    if q_seg is not None:
        s = torch.where((q_seg[:, :, None] == k_seg[:, None, :])[:, None], s, -1e30)
    return s


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True, *,
                        segment_ids: Optional[torch.Tensor] = None, sliding_window: int = 0) -> torch.Tensor:
    """Plain softmax attention, q [B, Sq, H, D], k/v [B, Sk, KV, D], GQA by
    repeating each kv head over its query group; float32 logits, probs cast
    to v's dtype before the PV product.  ``sliding_window > 0`` restricts
    each query to the last W keys; ``segment_ids`` [B, S] masks across
    packed sequences."""
    _, sq, nh, hd = q.shape
    sk = k.shape[1]
    k, v = _repeat_kv(k, v, nh)
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
    logits = _mask_scores(logits, torch.arange(sq, device=q.device), torch.arange(sk, device=q.device), causal,
                          sliding_window, segment_ids, segment_ids)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bnqk,bknd->bqnd", probs.to(v.dtype), v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                      segment_ids: Optional[torch.Tensor] = None, sliding_window: int = 0, chunk_size: int = 256,
                      unroll_chunks: int = 16) -> torch.Tensor:
    """Query-chunked attention: the softmax over the full key axis per chunk
    of ``chunk_size`` queries, so the [B, N, S, S] scores never exist at
    once (port of the JAX ``chunked_attention``, ``llama.py:262-351``).

    Up to ``unroll_chunks`` chunks with Sq == Sk, chunk i reads only the keys
    it can see (``[0, (i+1)·C)`` under the causal mask, from a 128-aligned
    window start); longer inputs score each chunk against every key and
    mask.  A length that is not a multiple of ``chunk_size`` takes
    ``reference_attention``."""
    b, sq, nh, hd = q.shape
    sk = k.shape[1]
    k, v = _repeat_kv(k, v, nh)
    if sq % chunk_size != 0 or sq < chunk_size:
        return reference_attention(q, k, v, causal, segment_ids=segment_ids, sliding_window=sliding_window)
    scale = 1.0 / math.sqrt(hd)
    nc = sq // chunk_size
    unrolled = nc <= unroll_chunks and sq == sk
    outs = []
    for i in range(nc):
        q0, q1 = i * chunk_size, (i + 1) * chunk_size
        kstart, kend = 0, sk
        if unrolled:
            kend = q1 if causal else sk
            if causal and sliding_window and sliding_window > 0:
                kstart = max(0, ((q0 - sliding_window + 1) // 128) * 128)
        s = torch.einsum("bcnd,bknd->bnck", q[:, q0:q1].float(), k[:, kstart:kend].float()) * scale
        seg_q = seg_k = None
        if segment_ids is not None:
            seg_q, seg_k = segment_ids[:, q0:q1], segment_ids[:, kstart:kend]
        s = _mask_scores(s, torch.arange(q0, q1, device=q.device), torch.arange(kstart, kend, device=q.device),
                         causal, sliding_window, seg_q, seg_k)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bnck,bknd->bcnd", p.to(v.dtype), v[:, kstart:kend]))
    return torch.cat(outs, dim=1)
