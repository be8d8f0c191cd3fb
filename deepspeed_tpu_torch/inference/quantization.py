"""Weight-only int8 quantization for serving (port of
``deepspeed_tpu/inference/quantization.py``; ref:
``deepspeed/inference/quantization/``).

Every floating tensor of a state dict with at least ``min_size`` elements
(the weights) is kept as int8 codes in groups of ``group`` values (128 by
default) with one float32 scale a group; smaller tensors (norms, most
biases) stay as they are.  The arithmetic is the JAX package's numpy, bit
for bit: ``scale = (amax + 1e-12) / 127`` in float32, ``code =
clip(round_half_even(x / scale), -128, 127)``, the tensor padded with zeros
to a whole group.  A tensor may be quantized on the card: the divides are
true divides by tensors, so the codes and scales are the same there.

The groups run over each tensor in the JAX package's layout, so that they
cover the same values as JAX's: an ``nn.Linear`` weight ``[out, in]`` is
quantized as its transpose, the flax kernel ``[in, out]``
(``quantize_inference_params`` finds them in ``cfg``'s serving twin, which
it therefore requires).  JAX's serving trees stack each layer tensor over the
layers, so a layer tensor is quantized when its stack holds ``min_size``
values, and its codes are the stack's where a layer holds whole groups
(every served model's does; elsewhere JAX's groups straddle two layers and
the port pads each layer's).  ``QuantizedParams.dequantize`` gives the state dict back in
torch's layout, each tensor as ``.to(dtype)`` of the float32 product
(``_dequantize_leaf``: one rounding).

``InferenceEngineV2`` takes a ``QuantizedParams`` (``LayerDequantizer``):
the codes and scales stay resident on the card, and each step dequantizes
the weights with K4b (``ops/quant_kernels.dequantize_int8``, the block-128
bf16 store) into scratch buffers that the model's parameters are views of:
the embedding, the final norm and the LM head (everything outside the
layer stack) into their own buffers when the step starts, and each layer's
weights into one set of buffers that every layer shares, just before that
layer runs (a forward pre-hook).  So one layer's bf16 weights exist at a
time, every launch is on the step's stream, and the step is still one CUDA
graph.
"""

import math
import re
from typing import Dict, Iterable, Mapping, Optional, Set, Tuple

import torch
from torch import nn

from ..ops.quant_kernels import dequantize_int8

#: a layer's parameters: ``layers.{i}.`` or ``h.{i}.`` + the rest of the name
LAYER_KEY = re.compile(r"^(layers|h)\.(\d+)\.(.+)$")


def _slot(name: str) -> str:
    """A layer tensor's name with its layer index as ``*``; any other name as it is."""
    return LAYER_KEY.sub(r"\1.*.\3", name)


def _quantize_leaf(x: torch.Tensor, group: int) -> Dict[str, torch.Tensor]:
    """``{"q": int8 [n/group, group], "scale": float32 [n/group]}`` of the
    flattened ``x`` padded with zeros to whole groups (JAX ``:21``)."""
    flat = x.detach().float().reshape(-1)
    pad = (-flat.numel()) % group
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    g = flat.view(-1, group)
    amax = g.abs().amax(dim=1) + 1e-12
    # tensor divisors: on CUDA, a divide by a Python scalar is a product with
    # its reciprocal, which can differ from numpy's divide in the last bit
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(g / scale[:, None]), -128, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _dequantize_leaf(node: Mapping[str, torch.Tensor], shape, dtype: torch.dtype) -> torch.Tensor:
    """The float32 product, cut to ``shape`` and cast once to ``dtype`` (JAX ``:34``)."""
    n = math.prod(shape)
    return (node["q"].float() * node["scale"][:, None]).reshape(-1)[:n].reshape(shape).to(dtype)


class QuantizedParams:
    """A state dict whose quantized tensors are ``{"q", "scale"}`` nodes.

    ``shapes`` maps each quantized name to the shape it was quantized in
    (the JAX layout); the names in ``transposed`` are ``nn.Linear`` weights
    held as their transposes.  ``dtype`` is the dtype that ``dequantize``
    gives (the serving dtype)."""

    def __init__(self, tree: Dict[str, object], shapes: Dict[str, Tuple[int, ...]], dtype=torch.bfloat16,
                 group: int = 128, transposed: Iterable[str] = ()):
        self.tree = tree
        self.shapes = shapes
        self.dtype = dtype
        self.group = group
        self.transposed: Set[str] = set(transposed)

    def dequantize(self, tree: Optional[Mapping[str, object]] = None) -> Dict[str, torch.Tensor]:
        """The whole state dict at once, in torch's layout."""
        tree = self.tree if tree is None else tree
        out = {}
        for name, node in tree.items():
            if name in self.shapes:
                t = _dequantize_leaf(node, self.shapes[name], self.dtype)
                out[name] = t.t() if name in self.transposed else t
            else:
                out[name] = node
        return out

    def to(self, device) -> "QuantizedParams":
        """The same codes, scales and tensors on ``device``."""

        def move(node):
            if isinstance(node, dict):
                return {k: t.to(device) for k, t in node.items()}
            return torch.as_tensor(node).to(device)

        return QuantizedParams({k: move(v) for k, v in self.tree.items()}, self.shapes, self.dtype, self.group,
                               self.transposed)

    @property
    def nbytes(self) -> int:
        """Bytes of every code, scale and unquantized tensor."""
        total = 0
        for v in self.tree.values():
            for t in (v.values() if isinstance(v, dict) else (torch.as_tensor(v), )):
                total += t.numel() * t.element_size()
        return total


def quantize_inference_params(variables: Mapping[str, object], cfg, bits: int = 8, group: int = 128,
                              min_size: int = 4096, dtype=torch.bfloat16) -> QuantizedParams:
    """Quantize every floating tensor of ``variables`` (a state dict, or
    ``{"params": state_dict}``) with at least ``min_size`` elements (JAX
    ``:65``).  The ``nn.Linear`` weights of ``cfg``'s serving twin are
    quantized in the flax kernel layout."""
    if bits != 8:
        raise ValueError(f"bits={bits}: weight-only int8 only (int4 is ops/quantizer for the ZeRO++ wire)")
    from ..models.cache_zoo import build_cache_model
    twin = build_cache_model(cfg, 16, device="meta")
    linear = {f"{name}.weight" for name, m in twin.named_modules() if isinstance(m, nn.Linear)}
    state = variables["params"] if "params" in variables else variables
    # JAX's scanned trees stack each layer tensor over the layers: a layer
    # tensor is quantized when its stack reaches min_size
    stacked: Dict[str, int] = {}
    for name, value in state.items():
        stacked[_slot(name)] = stacked.get(_slot(name), 0) + torch.as_tensor(value).numel()
    tree: Dict[str, object] = {}
    shapes: Dict[str, Tuple[int, ...]] = {}
    transposed = set()
    for name, value in state.items():
        t = torch.as_tensor(value)
        if t.is_floating_point() and stacked[_slot(name)] >= min_size:
            if name in linear and t.dim() == 2:
                t = t.t()
                transposed.add(name)
            shapes[name] = tuple(t.shape)
            tree[name] = _quantize_leaf(t, group)
        else:
            tree[name] = t
    return QuantizedParams(tree, shapes, dtype=dtype, group=group, transposed=transposed)


class LayerDequantizer:
    """The per-layer dequantization of an engine's step (see the module
    docstring).  ``params`` lives on the model's device; ``state()`` is the
    model's state dict with each quantized weight a view of its scratch
    buffer, for ``load_state_dict(assign=True)``; ``attach(model)`` registers
    the layer hooks; ``before_step()`` dequantizes the tensors outside the
    layers."""

    def __init__(self, params: QuantizedParams, device: torch.device):
        self.params = params.to(device)
        self.device = torch.device(device)
        #: scratch buffer of each slot: a layer tensor's name within its layer, or a global tensor's name
        self.scratch: Dict[str, torch.Tensor] = {}
        #: layer index → [(name, slot)] of its quantized tensors; the globals'
        self.layer_leaves: Dict[int, list] = {}
        self.global_leaves: list = []
        for name, shape in self.params.shapes.items():
            m, slot = LAYER_KEY.match(name), _slot(name)
            buf = self.scratch.get(slot)
            if buf is None:
                buf = self.scratch[slot] = torch.empty(math.prod(shape), dtype=params.dtype, device=self.device)
            elif buf.numel() != math.prod(shape):
                raise ValueError(f"{name}: its layers' shapes differ ({buf.numel()} vs {math.prod(shape)} values)")
            (self.layer_leaves.setdefault(int(m.group(2)), []) if m else self.global_leaves).append((name, slot))

    def state(self) -> Dict[str, torch.Tensor]:
        """The model's state dict: the unquantized tensors, and each
        quantized one as a view of its scratch buffer in torch's layout."""
        out = {}
        for name, node in self.params.tree.items():
            if name not in self.params.shapes:
                out[name] = node
                continue
            view = self.scratch[_slot(name)].view(self.params.shapes[name])
            out[name] = view.t() if name in self.params.transposed else view
        return out

    def _dequantize(self, leaves) -> None:
        for name, slot in leaves:
            node = self.params.tree[name]
            dequantize_int8(node["q"], node["scale"], self.params.shapes[name], out=self.scratch[slot])

    def before_step(self) -> None:
        self._dequantize(self.global_leaves)

    def attach(self, layers: nn.ModuleList) -> None:
        """A forward pre-hook on each layer that dequantizes its weights."""
        for i, layer in enumerate(layers):
            leaves = self.layer_leaves.get(i, [])
            layer.register_forward_pre_hook(lambda module, args, leaves=leaves: self._dequantize(leaves))

    @property
    def scratch_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.scratch.values())
