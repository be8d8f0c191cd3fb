"""``TiledLinear``: a linear layer split into tiles (port of
``deepspeed_tpu/runtime/zero/tiling.py``; ref: ``runtime/zero/tiling.py``).

One stacked parameter ``weight`` ``[in_splits, out_splits, in/i, out/o]``
(JAX's ``kernel``, in the same ``[in, out]`` orientation within a tile),
contracted tile by tile: input tile i against its row of output tiles, one
``torch.matmul`` each, summed in the compute dtype as JAX's scan sums them.
The JAX layer computes this with ``einsum`` outside any Pallas kernel.
Each tile is initialised on its own, lecun normal over its fan-in, as the
reference's sub-linears.
"""

import math
from typing import Optional

import torch
from torch import nn


class TiledLinear(nn.Module):
    """``y = x @ W + b`` computed tile by tile (ref: tiling.py TiledLinear)."""

    def __init__(self, in_features: int, out_features: int, in_splits: int = 1, out_splits: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if in_features % in_splits or out_features % out_splits:
            raise ValueError(f"in_features {in_features} % in_splits {in_splits} and out_features {out_features} % "
                             f"out_splits {out_splits} must be 0")
        self.in_features, self.out_features = in_features, out_features
        self.in_splits, self.out_splits = in_splits, out_splits
        ti, to = in_features // in_splits, out_features // out_splits
        self.weight = nn.Parameter(torch.empty(in_splits, out_splits, ti, to, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=dtype, device=device)) if bias else None

    @torch.no_grad()
    def init_weights_(self, generator: Optional[torch.Generator] = None) -> "TiledLinear":
        """Each tile lecun normal over its fan-in (untruncated, as the port's
        ``init_weights_``), the bias zero."""
        self.weight.normal_(0.0, 1.0 / math.sqrt(self.weight.shape[2]), generator=generator)
        if self.bias is not None:
            self.bias.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ti, to = self.weight.shape[2:]
        xt = x.to(self.weight.dtype).reshape(x.shape[:-1] + (self.in_splits, ti))
        acc = x.new_zeros(x.shape[:-1] + (self.out_splits, to), dtype=self.weight.dtype)
        for i in range(self.in_splits):
            # one input tile against all its output tiles: [*, 1, 1, ti] @ [O, ti, to] → [*, O, to]
            acc = acc + torch.matmul(xt[..., i, None, None, :], self.weight[i]).squeeze(-2)
        y = acc.reshape(x.shape[:-1] + (self.out_features, ))
        return y if self.bias is None else y + self.bias

    def copy_params_from(self, other: nn.Linear) -> "TiledLinear":
        """The weights of a dense ``nn.Linear`` (ref: TiledLinear.copy_params_from)."""
        return copy_params_from_dense(self, other.weight, other.bias)


@torch.no_grad()
def copy_params_from_dense(tiled: TiledLinear, dense_weight: torch.Tensor,
                           dense_bias: Optional[torch.Tensor] = None) -> TiledLinear:
    """Load a dense weight, ``nn.Linear``'s ``[out, in]`` (the transpose of
    JAX's ``[in, out]`` kernel), into the tiled layout (JAX :62)."""
    in_splits, out_splits, ti, to = tiled.weight.shape
    w = dense_weight.t().reshape(in_splits, ti, out_splits, to).permute(0, 2, 1, 3)
    tiled.weight.copy_(w)
    if dense_bias is not None and tiled.bias is not None:
        tiled.bias.copy_(dense_bias)
    return tiled
