"""Mixture-of-Experts gating, dispatch and combine (port of
``deepspeed_tpu/moe/sharded_moe.py``; ref: ``deepspeed/moe/sharded_moe.py``
``top1gating:183``, ``top2gating:290``, ``topkgating:374``).

One device holds one group of tokens, ``[S, d]``.  The gating decides, for
each token's choice ``i`` of ``k``, its expert, its slot in that expert's
buffer of ``capacity`` rows and its combine weight, with JAX's rules:

  * capacity = max(ceil(k·S/E·capacity_factor), min_capacity) (``_capacity``);
    a choice whose slot is at or past it is dropped (or none is, with
    ``drop_tokens=False``: the caller sizes capacity to S);
  * slots are given choice-major: every token's first choice in token
    order, then the second choices, so first choices win capacity first;
  * the top-k weights are renormalised over the k choices before the
    drops; a dropped choice weighs 0 and the others are not renormalised;
  * ``l_aux`` = E·Σ(mean gates × mean top-1 mask), from the choices before
    the drops; ``exp_counts`` counts top-k's choices before the drops and
    top-1's after them, as JAX's do;
  * top-k orders equal gates by the lower expert index (``jax.lax.top_k``).

Where JAX builds the ``[S, E, C]`` combine and dispatch one-hots and
contracts them by einsum, the port keeps the per-choice slots (``Gating``)
and moves the rows by index: ``dispatch_combine`` puts each kept choice's
token into its ``[E, C, d]`` slot and takes the expert outputs back by the
same index, static shapes throughout, the same slots as JAX's.
"""

import math
from typing import Callable, NamedTuple, Optional

import torch


class Gating(NamedTuple):
    """One group's routing; the choice dimension comes first (``[k, S]``)."""
    l_aux: torch.Tensor        # () float32, the load-balancing loss
    experts: torch.Tensor      # [k, S] int64, each choice's expert
    slots: torch.Tensor        # [k, S] int64, its row in that expert's buffer
    keep: torch.Tensor         # [k, S] bool, dispatched (within capacity)
    weights: torch.Tensor      # [k, S] float32, its combine weight (0 where dropped)
    exp_counts: torch.Tensor   # [E] float32


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float, min_capacity: int, k: int) -> int:
    """ceil(k·S/E · factor), at least ``min_capacity`` (ref: ``_capacity``)."""
    cap = int(math.ceil(k * num_tokens / num_experts * capacity_factor))
    return max(cap, min_capacity)


def top_k(x: torch.Tensor, k: int):
    """The k largest values of the last dim and their indices, equal values
    in index order (``jax.lax.top_k``; ``torch.topk`` promises no order for
    ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _slots(experts: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each choice's arrival position at its expert, counting ``experts``
    ([k, S] or [S]) flattened in order (choice-major)."""
    flat = experts.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, num_experts)
    before = torch.cumsum(onehot, dim=0) - onehot
    return torch.gather(before, 1, flat[:, None])[:, 0].reshape(experts.shape)


def _counts(experts: torch.Tensor, num_experts: int, counted: torch.Tensor) -> torch.Tensor:
    """Per expert, the sum of ``counted`` over the choices routed to it
    (float32 as JAX's; no host sync, unlike ``torch.bincount`` on CUDA)."""
    zeros = torch.zeros(num_experts, dtype=torch.float32, device=experts.device)
    return zeros.index_add_(0, experts.reshape(-1), counted.reshape(-1).float())


def _l_aux(gates: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """E·Σ(mean gates × mean top-1 mask) over the group."""
    e = gates.shape[-1]
    mask = torch.nn.functional.one_hot(first, e).float()
    return (gates.mean(0) * mask.mean(0)).sum() * e


def top1_gating(logits: torch.Tensor, capacity: int, noisy_gate_policy: Optional[str] = None,
                generator: Optional[torch.Generator] = None) -> Gating:
    """Top-1 gating (ref ``top1gating:183``; JAX ``:37``) of float32 logits
    [S, E].  ``noisy_gate_policy="RSample"`` picks the expert by the logits
    plus Gumbel noise drawn from ``generator`` (the gates stay the clean
    softmax).  The combine weight is the chosen expert's gate, not
    renormalised."""
    s, e = logits.shape
    noisy = logits
    if noisy_gate_policy == "RSample" and generator is not None:
        # −log(Exp(1)) is a standard Gumbel draw
        expo = torch.empty_like(logits).exponential_(generator=generator)
        noisy = logits - torch.log(expo)
    gates = torch.softmax(logits, dim=-1)
    idx = torch.argmax(noisy, dim=-1)                                   # first index on ties, as jnp.argmax
    l_aux = _l_aux(gates, idx)
    slots = _slots(idx, e)
    keep = slots < capacity
    gate = torch.gather(gates, 1, idx[:, None])[:, 0]
    weights = torch.where(keep, gate, torch.zeros_like(gate))
    exp_counts = _counts(idx, e, keep.float())
    return Gating(l_aux, idx[None], slots[None], keep[None], weights[None], exp_counts)


def topk_gating(logits: torch.Tensor, k: int, capacity: int, drop_tokens: bool = True,
                normalize: bool = True) -> Gating:
    """Top-k gating (ref ``top2gating:290`` and ``topkgating:374``; JAX
    ``:76``) of float32 logits [S, E]: the k largest gates, renormalised over
    the k when ``normalize``, slots given choice-major."""
    s, e = logits.shape
    gates = torch.softmax(logits, dim=-1)
    vals, idx = top_k(gates, k)                                         # [S, k]
    if normalize:
        vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    experts, vals = idx.T, vals.T                                       # [k, S]
    l_aux = _l_aux(gates, experts[0])
    slots = _slots(experts, e)
    keep = slots < capacity if drop_tokens else torch.ones_like(slots, dtype=torch.bool)
    weights = torch.where(keep, vals, torch.zeros_like(vals))
    exp_counts = _counts(experts, e, torch.ones_like(weights))
    return Gating(l_aux, experts, slots, keep, weights, exp_counts)


def dispatch_combine(x: torch.Tensor, gating: Gating, num_experts: int, capacity: int,
                     expert_fn: Callable[[torch.Tensor], torch.Tensor], ep_group=None,
                     ep_size: int = 1) -> torch.Tensor:
    """Dispatch → experts → combine for one group (JAX ``:112``).

    x [S, d]; ``expert_fn`` maps the dispatched ``[E, C, d]`` (zeros in the
    empty slots) to ``[E, C, d]``.  At ``ep_size`` > 1 it holds this rank's
    E/ep experts: the buffer's chunk of each rank's experts goes to that
    rank of ``ep_group`` (``comm.AllToAll``), which runs its experts over
    ``[E/ep, ep·C, d]`` (every rank's slots of them, in rank order), and
    the outputs come back by the reverse all-to-all; JAX reshards its
    ``[G, E, C, d]`` the same way.  Each kept choice's token is written to
    row ``expert·C + slot`` (a dropped one to a spare row past the buffer),
    and its expert's output is read back from the same row.  The routing
    weights are cast to the experts' output dtype before they weigh the
    outputs, which are summed over the choices in float32 and returned
    unrounded: the caller rounds it once to the experts' dtype, as JAX's
    einsum over ``combine.astype(expert_out.dtype)`` does
    (``sharded_moe.py:138``), after summing the partial sums of a bank cut
    over the tensor axis."""
    s, d = x.shape
    k = gating.experts.shape[0]
    spare = num_experts * capacity
    rows = torch.where(gating.keep, gating.experts * capacity + gating.slots, spare).reshape(-1)   # [k*S]
    buf = x.new_zeros(spare + 1, d).index_put((rows, ), x.repeat(k, 1))
    if ep_size == 1:
        out = expert_fn(buf[:spare].view(num_experts, capacity, d)).reshape(spare, -1)
    else:
        out = _expert_parallel(buf[:spare].view(num_experts, capacity, d), expert_fn, ep_group, ep_size)
    out = torch.cat([out, out.new_zeros(1, out.shape[1])])
    picked = out[rows].view(k, s, -1).float()
    weights = gating.weights.to(out.dtype).float()
    return (picked * weights[..., None]).sum(0)


def _expert_parallel(buf: torch.Tensor, expert_fn, ep_group, ep_size: int) -> torch.Tensor:
    """``[E, C, d]`` through the experts spread over the expert group: the
    dispatch all-to-all, this rank's experts over ``[E/ep, ep·C, d]``, the
    combine all-to-all back; ``[E·C, d_out]`` in global expert order."""
    from ..comm import comm
    e, c, d = buf.shape
    local = e // ep_size
    got = comm.AllToAll.apply(buf, ep_group, "dispatch")                     # [ep·E/ep, C, d], by source rank
    mine = got.view(ep_size, local, c, d).transpose(0, 1).reshape(local, ep_size * c, d)
    out = expert_fn(mine)
    back = out.view(local, ep_size, c, -1).transpose(0, 1).reshape(e, c, -1)  # by destination rank
    return comm.AllToAll.apply(back, ep_group, "combine").reshape(e * c, -1)
