"""Block-sparse attention layout configs.

The port's own copy of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``
(numpy only, so it is copied rather than imported: the port imports nothing
of the JAX package).  The same numpy gives bit-identical layouts, the random
blocks of ``Variable``/``BigBird`` included (``np.random.default_rng(seed)``).

ref: deepspeed/ops/sparse_attention/sparsity_config.py (SparsityConfig:10,
Dense:63, Fixed:95, Variable:239, BigBird:411, BSLongformer:546,
LocalSlidingWindow:674).  Layouts are [num_heads, num_blocks, num_blocks]
0/1 numpy arrays built host-side; ``kernel.py`` turns them into the row and
column index tables the CUDA kernels walk.

Construction is vectorized numpy rather than the reference's per-cell loops,
but each pattern reproduces the same semantics (local windows, global
rows/columns, random blocks, uni/bidirectional masking).
"""

import numpy as np


class SparsityConfig:
    """ref: sparsity_config.py:10."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(f"sequence length {seq_len} must be divisible by block {self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), dtype=np.int64)

    def check_and_propagate_first_head_layout(self, layout):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len):
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All-ones layout (ref: sparsity_config.py:63) — for testing parity."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        super().__init__(num_heads, block, different_layout_per_head)

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


def _sliding_window(layout, h, w_blocks, attention):
    nb = layout.shape[1]
    half = w_blocks // 2
    rows = np.arange(nb)[:, None]
    cols = np.arange(nb)[None, :]
    if attention == "bidirectional":
        win = (cols >= rows - half) & (cols <= rows + half)
    else:
        win = (cols >= rows - half) & (cols <= rows)
    layout[h] |= win.astype(layout.dtype)
    return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformer style fixed local+global pattern
    (ref: sparsity_config.py:95)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False, num_local_blocks=4,
                 num_global_blocks=1, attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(f"num_local_blocks {num_local_blocks} must be divisible by "
                             f"num_global_blocks {num_global_blocks}")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError("only uni/bidirectional attention supported")
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError("horizontal global attention requires bidirectional attention")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("num_different_global_patterns>1 requires different_layout_per_head")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError("num_different_global_patterns too large")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def _local(self, layout, h):
        nb = layout.shape[1]
        rows = np.arange(nb)[:, None]
        cols = np.arange(nb)[None, :]
        same_window = (rows // self.num_local_blocks) == (cols // self.num_local_blocks)
        if self.attention == "unidirectional":
            same_window &= cols <= rows
        layout[h] |= same_window.astype(layout.dtype)
        return layout

    def _global(self, layout, h):
        nb = layout.shape[1]
        first = self.num_local_blocks - (1 + h % self.num_different_global_patterns) * self.num_global_blocks
        end = nb - (nb % self.num_local_blocks)
        starts = list(range(first, end, self.num_local_blocks))
        if end < nb:  # short tail window
            starts.append(min(end + first, nb - self.num_global_blocks))
        for i in starts:
            sl = slice(i, i + self.num_global_blocks)
            # vertical global stripe; the final np.tril in make_layout
            # enforces causality for unidirectional attention
            layout[h, :, sl] = 1
            if self.horizontal_global_attention:
                layout[h, sl, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self._local(layout, h)
            layout = self._global(layout, h)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Variable local-window + indexed global blocks + random blocks
    (ref: sparsity_config.py:239)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False, num_random_blocks=0,
                 local_window_blocks=None, global_block_indices=None, global_block_end_indices=None,
                 attention="bidirectional", horizontal_global_attention=False, seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError("only uni/bidirectional attention supported")
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError("horizontal global attention requires bidirectional attention")
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices if global_block_indices is not None else [0]
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None and len(global_block_end_indices) != len(self.global_block_indices):
            raise ValueError("global_block_end_indices must pair with global_block_indices")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.rng = np.random.default_rng(seed)

    def _local(self, layout, h):
        nb = layout.shape[1]
        # consecutive windows of the listed sizes; last size repeats
        start = 0
        sizes = list(self.local_window_blocks)
        while start < nb:
            size = sizes.pop(0) if sizes else self.local_window_blocks[-1]
            end = min(start + size, nb)
            rows = np.arange(start, end)[:, None]
            cols = np.arange(start, end)[None, :]
            sub = np.ones((end - start, end - start), layout.dtype) if self.attention == "bidirectional" \
                else (cols <= rows).astype(layout.dtype)
            layout[h, start:end, start:end] |= sub
            start = end
        return layout

    def _global(self, layout, h):
        nb = layout.shape[1]
        pairs = []
        if self.global_block_end_indices is None:
            pairs = [(i, i + 1) for i in self.global_block_indices]
        else:
            pairs = list(zip(self.global_block_indices, self.global_block_end_indices))
        rows = np.arange(nb)[:, None]
        for s, e in pairs:
            if s >= nb:
                continue
            e = min(e, nb)
            if self.attention == "bidirectional":
                layout[h, :, s:e] = 1
            else:
                layout[h, :, s:e] = np.where(rows >= s, 1, layout[h, :, s:e])
            if self.horizontal_global_attention:
                layout[h, s:e, :] = 1
        return layout

    def _random(self, layout, h):
        nb = layout.shape[1]
        for row in range(nb):
            hi = nb if self.attention == "bidirectional" else row + 1
            k = min(self.num_random_blocks, hi)
            cols = self.rng.choice(hi, size=k, replace=False)
            layout[h, row, cols] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            if self.num_random_blocks:
                layout = self._random(layout, h)
            layout = self._local(layout, h)
            layout = self._global(layout, h)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """random + sliding window + global first blocks
    (ref: sparsity_config.py:411)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False, num_random_blocks=1,
                 num_sliding_window_blocks=3, num_global_blocks=1, attention="bidirectional", seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError("only uni/bidirectional attention supported")
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.rng = np.random.default_rng(seed)

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        for name, n in (("random", self.num_random_blocks), ("sliding", self.num_sliding_window_blocks),
                        ("global", self.num_global_blocks)):
            if nb < n:
                raise ValueError(f"num_{name}_blocks {n} exceeds number of block rows {nb}")
        for h in range(self.num_layout_heads):
            for row in range(nb):
                hi = nb if self.attention == "bidirectional" else row + 1
                cols = self.rng.choice(hi, size=min(self.num_random_blocks, hi), replace=False)
                layout[h, row, cols] = 1
            layout = _sliding_window(layout, h, self.num_sliding_window_blocks, self.attention)
            g = self.num_global_blocks
            layout[h, 0:g, :] = 1
            layout[h, :, 0:g] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """sliding window + indexed global blocks (ref: sparsity_config.py:546)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False, num_sliding_window_blocks=3,
                 global_block_indices=None, global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices if global_block_indices is not None else [0]
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None and len(global_block_end_indices) != len(self.global_block_indices):
            raise ValueError("global_block_end_indices must pair with global_block_indices")
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        pairs = [(i, i + 1) for i in self.global_block_indices] if self.global_block_end_indices is None \
            else list(zip(self.global_block_indices, self.global_block_end_indices))
        for h in range(self.num_layout_heads):
            layout = _sliding_window(layout, h, self.num_sliding_window_blocks, self.attention)
            for s, e in pairs:
                if s >= nb:
                    continue
                e = min(e, nb)
                layout[h, :, s:e] = 1  # global columns
                layout[h, s:e, :] = 1  # global rows
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """purely-local sliding window (ref: sparsity_config.py:674)."""

    def __init__(self, num_heads, block=16, num_sliding_window_blocks=3, attention="unidirectional"):
        super().__init__(num_heads, block)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = _sliding_window(layout, h, self.num_sliding_window_blocks, self.attention)
        return self.check_and_propagate_first_head_layout(layout)


SPARSITY_CONFIG_REGISTRY = {
    "dense": DenseSparsityConfig,
    "fixed": FixedSparsityConfig,
    "variable": VariableSparsityConfig,
    "bigbird": BigBirdSparsityConfig,
    "bslongformer": BSLongformerSparsityConfig,
    "local_sliding_window": LocalSlidingWindowSparsityConfig,
}


def make_sparsity_config(mode_or_dict, num_heads=None, **kwargs):
    """Factory from the ds-config ``sparse_attention`` block
    (ref: runtime/config.py get_sparse_attention → mode dispatch)."""
    if isinstance(mode_or_dict, dict):
        d = dict(mode_or_dict)
        mode = d.pop("mode", "fixed")
        d.pop("enabled", None)
        num_heads = d.pop("num_heads", num_heads)
        return SPARSITY_CONFIG_REGISTRY[mode](num_heads=num_heads, **d)
    return SPARSITY_CONFIG_REGISTRY[mode_or_dict](num_heads=num_heads, **kwargs)
