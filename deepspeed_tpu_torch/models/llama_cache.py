"""Llama with paged KV cache (port of ``deepspeed_tpu/models/llama_cache.py``).

The arena is a list of per-layer tensors ``[P, page, 2, n_kv, hd]`` — the
unrolled layout of the JAX twin (``llama_cache.py:249-263``) — and page 0
is the reserved null page that unused block-table slots reference.  Where
JAX donates the arena through ``jit`` so XLA updates it in place, the port
writes it in place (``index_put_``): each forward mutates ``cache`` and
returns only the logits.

One forward serves prefill chunks, continuation chunks and decode (C=1) —
FastGen's Dynamic SplitFuse property that all phases are the same
computation at different chunk sizes.
"""

import dataclasses
import math
from typing import List, Optional

import torch

from .llama import LlamaAttention, LlamaBlock, LlamaConfig, LlamaForCausalLM


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    """Cache geometry (ref: inference/v2/ragged/manager_configs.py)."""
    num_pages: int = 128
    page_size: int = 16
    max_pages_per_seq: int = 8


def init_kv_cache(cfg: LlamaConfig, kv: PagedKVConfig, dtype=torch.bfloat16, device=None) -> List[torch.Tensor]:
    """One zeroed ``[P, page, 2, n_kv, hd]`` arena per layer."""
    shape = (kv.num_pages, kv.page_size, 2, cfg.num_key_value_heads, cfg.head_dim)
    return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_hidden_layers)]


def write_pages(pages: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor, block_table: torch.Tensor,
                start_pos: torch.Tensor, page_size: int, chunk_lens: Optional[torch.Tensor] = None) -> None:
    """Scatter a chunk's K/V into the arena pages, in place.

    pages: [P, page, 2, n_kv, hd] (one layer)   k/v_new: [B, C, n_kv, hd]
    block_table: [B, max_pages]  start_pos: [B]  chunk_lens: [B] or None —
    positions at/after a row's chunk_len are padding; their writes are
    redirected to the reserved null page 0.
    """
    c = k_new.shape[1]
    ar = torch.arange(c, device=k_new.device)
    positions = start_pos.long()[:, None] + ar[None, :]                          # [B, C]
    # the page lookup stays in bounds for the pad region too
    page_slot = torch.clamp(positions // page_size, max=block_table.shape[1] - 1)
    page_idx = torch.gather(block_table.long(), 1, page_slot)                    # [B, C]
    kv_chunk = torch.stack([k_new, v_new], dim=2)                                # [B, C, 2, n_kv, hd]
    if chunk_lens is not None:
        valid = ar[None, :] < chunk_lens.long()[:, None]                         # [B, C]
        page_idx = torch.where(valid, page_idx, 0)
        # ALSO zero the redirected values: pad-region activations can be
        # non-finite (e.g. out-of-range learned-position lookups fill NaN),
        # and a NaN-poisoned null page turns masked attention into NaN via
        # 0 * NaN in the probs @ V product
        kv_chunk = torch.where(valid[:, :, None, None, None], kv_chunk, 0)
    slot_idx = positions % page_size
    pages.index_put_((page_idx.reshape(-1), slot_idx.reshape(-1)),
                     kv_chunk.reshape((-1, ) + kv_chunk.shape[2:]).to(pages.dtype))


def paged_attention(q: torch.Tensor, pages: torch.Tensor, block_table: torch.Tensor, start_pos: torch.Tensor,
                    chunk_lens: Optional[torch.Tensor], page_size: int) -> torch.Tensor:
    """Attention of a chunk's queries against (history + chunk) keys — the
    plain PyTorch version of the K3 kernel (``ops/paged_attention.py``).

    q: [B, C, H, hd] (RoPE applied); pages: [P, page, 2, n_kv, hd] with the
    chunk's K/V already written; block_table: [B, max_pages]; start_pos: [B]
    = context length before this chunk; chunk_lens: [B] or None — query rows
    at/after a row's chunk_len (ragged padding) get zero output.
    """
    b, c, h, d = q.shape
    max_pages = block_table.shape[1]
    n_kv = pages.shape[3]
    gathered = pages[block_table.reshape(-1).long()]                           # [B*maxp, page, 2, n_kv, hd]
    gathered = gathered.reshape(b, max_pages * page_size, 2, n_kv, d)
    k = gathered[:, :, 0]                                                      # [B, S_kv, n_kv, hd]
    v = gathered[:, :, 1]
    if n_kv != h:
        k = k.repeat_interleave(h // n_kv, dim=2)
        v = v.repeat_interleave(h // n_kv, dim=2)
    logits = torch.einsum("bcnd,bknd->bnck", q.float(), k.float()) * (1.0 / math.sqrt(d))
    ar = torch.arange(c, device=q.device)
    qpos = start_pos.long()[:, None] + ar[None, :]                             # [B, C]
    kpos = torch.arange(max_pages * page_size, device=q.device)                # [S_kv]
    mask = kpos[None, None, :] <= qpos[..., None]                              # [B, C, S_kv]
    logits = torch.where(mask[:, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnck,bknd->bcnd", probs.to(v.dtype), v)
    if chunk_lens is not None:
        valid = ar[None, :] < chunk_lens.long()[:, None]                       # [B, C]
        out = torch.where(valid[..., None, None], out, 0)
    return out


def paged_attention_core(q, k, v, pages, block_table, start_pos, chunk_lens, page_size,
                         attention_impl: str = "reference") -> torch.Tensor:
    """Write this chunk's K/V into the arena (in place), then attend the
    chunk's queries against (history + chunk).  q/k/v are post-projection,
    post-RoPE [B, C, N(H|KV), D].  Returns out [B, C, H, D].

    ``attention_impl="flash"`` goes through the K3 kernel's wrapper, which
    launches the CUDA kernel for a GPU tensor and runs the plain version
    only for a CPU tensor; ``"reference"`` runs the plain version."""
    write_pages(pages, k, v, block_table, start_pos, page_size, chunk_lens)
    if attention_impl == "flash":
        from ..ops.paged_attention import paged_attention as paged_attention_op
        return paged_attention_op(q, pages, block_table, start_pos, chunk_lens, page_size)
    if attention_impl != "reference":
        raise ValueError(f"unknown attention_impl {attention_impl!r} (flash | reference)")
    return paged_attention(q, pages, block_table, start_pos, chunk_lens, page_size)


class LlamaAttentionCache(LlamaAttention):

    def __init__(self, cfg: LlamaConfig, page_size: int = 16, device=None):
        super().__init__(cfg, device=device)
        self.page_size = page_size

    def forward(self, x, positions, pages, block_table, start_pos, chunk_lens=None):
        q, k, v = self.qkv(x, positions)
        out = paged_attention_core(q, k, v, pages, block_table, start_pos, chunk_lens, self.page_size,
                                   attention_impl=self.cfg.attention_impl)
        return self.out(out)


class LlamaBlockCache(LlamaBlock):

    def __init__(self, cfg: LlamaConfig, page_size: int = 16, device=None):
        super().__init__(cfg, device=device, self_attn=LlamaAttentionCache(cfg, page_size, device=device))

    def forward(self, x, positions, pages, block_table, start_pos, chunk_lens=None):
        h = x + self.self_attn(self.input_layernorm(x), positions, pages, block_table, start_pos, chunk_lens)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaForCausalLMWithCache(LlamaForCausalLM):
    """Chunked forward with paged KV: ``model(input_ids, start_pos,
    block_table, cache, chunk_lens)`` → logits [B, C, V]; ``cache`` (one
    arena per layer) is updated in place.  ``hidden`` + ``logits`` split the
    same forward so the engine can take the LM head over each row's last
    real token only."""

    def __init__(self, cfg: LlamaConfig, page_size: int = 16, device="cuda"):
        self.page_size = page_size
        super().__init__(cfg, device=device)

    def _make_block(self, cfg, device):
        return LlamaBlockCache(cfg, self.page_size, device=device)

    def hidden(self, input_ids, start_pos, block_table, cache, chunk_lens=None) -> torch.Tensor:
        if len(cache) != len(self.layers):
            raise ValueError(f"cache holds {len(cache)} layer arenas, model has {len(self.layers)} layers")
        positions = start_pos.long()[:, None] + torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = self.embed(input_ids)
        for layer, pages in zip(self.layers, cache):
            x = layer(x, positions, pages, block_table, start_pos, chunk_lens)
        return x

    def forward(self, input_ids, start_pos, block_table, cache, chunk_lens=None) -> torch.Tensor:
        return self.logits(self.hidden(input_ids, start_pos, block_table, cache, chunk_lens))
