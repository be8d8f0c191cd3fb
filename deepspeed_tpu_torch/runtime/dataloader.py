"""Data loaders (port of ``deepspeed_tpu/runtime/dataloader.py``; ref:
``deepspeed/runtime/dataloader.py``).

``RepeatingLoader`` is API-identical.  ``DeepSpeedDataLoader`` batches an
indexable dataset into numpy pytrees of the **global** micro-batch, in the
JAX package's order: indices in order, or shuffled by
``np.random.default_rng(seed + epoch)``; ``drop_last`` drops a short tail.
The engine's ``train_batch`` takes ``gradient_accumulation_steps`` of them
per optimizer step, and each data-parallel rank takes its rows of the
global batch, as the JAX step shards it.
"""

from typing import Callable, Optional

import numpy as np


class RepeatingLoader:
    """ref: runtime/dataloader.py RepeatingLoader — wraps an iterator to
    restart on StopIteration."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)

    def __len__(self):
        return len(self.loader)


class DeepSpeedDataLoader:
    """Batches an indexable dataset into numpy pytrees of ``batch_size``
    (the global micro-batch over the data-parallel ranks)."""

    def __init__(self,
                 dataset,
                 batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 drop_last: bool = True,
                 shuffle: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        self.epoch += 1
        for start in range(0, len(idx) - (self.batch_size - 1 if self.drop_last else 0), self.batch_size):
            chunk = idx[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            yield self.collate_fn([self.dataset[int(i)] for i in chunk])


def default_collate(samples):
    """Stack a list of dict/tuple/array samples into a batched pytree."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([s[i] for s in samples]) for i in range(len(first)))
    return np.stack(samples)
