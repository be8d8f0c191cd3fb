"""Progressive Layer Dropping (port of
``deepspeed_tpu/runtime/progressive_layer_drop.py``; ref:
``deepspeed/runtime/progressive_layer_drop.py``).

The schedule is JAX's: ``theta(t) = (1 − p)·exp(−gamma·t) + p``, and layer
``l`` of ``L`` keeps with probability ``1 − (l + 1)/L·(1 − theta)`` (PLD
eq. 6: deeper layers drop more often).  A kept layer's residual deltas are
scaled by ``1/keep_p`` (``pld_scale = mask·inv``), which the model casts to
its compute dtype before the multiply, as JAX does.

The random bits cannot be JAX's: JAX draws
``bernoulli(fold_in(PRNGKey(17), step), keep_p)`` with threefry.  Here the
mask is drawn on the CPU from a ``torch.Generator`` seeded from the step
alone (``pld_generator``), so the CPU and the card draw the same mask, and a
run resumed from a checkpoint draws the masks of the run it continues.
"""

import numpy as np
import torch

from ..utils.logging import log_dist

#: the JAX engine's PLD key (``engine.py:672``: ``PRNGKey(17)``), here the
#: high word of each step's generator seed
PLD_SEED = 17


class ProgressiveLayerDrop:
    """ref: progressive_layer_drop.py:10."""

    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0
        log_dist(f"Enabled progressive layer dropping (theta = {self.theta})", ranks=[0])

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self):
        return self.current_theta

    def update_state(self, global_step: int):
        self.current_theta = (1.0 - self.theta) * float(np.exp(-self.gamma * global_step)) + self.theta
        return self.current_theta

    def step_theta(self, step: int) -> torch.Tensor:
        """theta at ``step`` in float32, as the JAX step computes it from its
        int32 step (``engine.py:671``)."""
        t = torch.tensor(step, dtype=torch.int32).float()
        return (1.0 - self.theta) * torch.exp(-self.gamma * t) + self.theta


def pld_keep_prob(num_layers: int, theta) -> torch.Tensor:
    """float32 ``[L]``: ``1 − (l + 1)/L·(1 − theta)``."""
    depth = (torch.arange(num_layers, dtype=torch.float32) + 1.0) / num_layers
    return 1.0 - depth * (1.0 - torch.as_tensor(theta, dtype=torch.float32))


def pld_generator(step: int) -> torch.Generator:
    """The CPU generator of step ``step``'s mask: a function of the step alone."""
    return torch.Generator().manual_seed((PLD_SEED << 32) + int(step))


def pld_layer_mask(generator: torch.Generator, num_layers: int, theta, dtype=torch.float32):
    """(mask[L], inv_keep[L]) on the CPU: keep mask and 1/keep_prob scaling
    (``uniform < keep_p``, as ``jax.random.bernoulli`` draws).  Multiply a
    block's residual delta by ``mask[l]·inv_keep[l]`` to apply."""
    keep_p = pld_keep_prob(num_layers, theta)
    mask = (torch.rand(num_layers, generator=generator, dtype=torch.float32) < keep_p).to(dtype)
    return mask, (1.0 / keep_p).to(dtype)


def pld_scale_for_step(pld: ProgressiveLayerDrop, num_layers: int, step: int) -> torch.Tensor:
    """``mask·inv`` (float32 ``[L]``, on the CPU) for the train step that
    starts with ``step`` steps taken: theta at that step, the step's mask."""
    mask, inv = pld_layer_mask(pld_generator(step), num_layers, pld.step_theta(step))
    return mask * inv
