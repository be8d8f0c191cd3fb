"""CLIP: the causal text tower, the patch-conv vision tower and the dual
encoder over them (port of ``deepspeed_tpu/models/clip.py``).

Pre-LN towers with quick-GELU MLPs and plain attention (causal in the text
tower, bidirectional in the vision tower); the text tower pools the hidden
state at the first EOS token, the vision tower the post-LN class token.
Pixels come in NHWC, as the JAX model takes them.  Parameter names mirror
the JAX tree (``text_model.layers.{i}.self_attn.q_proj``, the raw
``position_embedding`` and ``class_embedding`` tensors, ...) with torch's
``[out, in]`` weights and a ``Conv2d`` ``[E, C, ph, pw]`` patch kernel.
"""

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import DeviceLike, resolve_device
from .bert import bidirectional_attention
from .llama import LayerNorm, dense


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    intermediate_size: int = 2048
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    """The dual encoder's config; ``dtype`` is the serving dtype of both towers."""
    text: ClipTextConfig = ClipTextConfig()
    vision: ClipVisionConfig = ClipVisionConfig()
    projection_dim: int = 512
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _lin(cfg, fan_in, fan_out, device) -> nn.Linear:
    return nn.utils.skip_init(nn.Linear, fan_in, fan_out, bias=True, device=device, dtype=cfg.param_dtype)


class ClipAttention(nn.Module):

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (_lin(cfg, e, e, device) for _ in range(4))

    def forward(self, x, causal: bool):
        cfg = self.cfg
        b, s, _ = x.shape
        heads = lambda proj: dense(x, proj, cfg.dtype).view(b, s, cfg.num_attention_heads, -1)
        out = bidirectional_attention(heads(self.q_proj), heads(self.k_proj), heads(self.v_proj), causal=causal)
        return dense(out.reshape(b, s, -1), self.out_proj, cfg.dtype)


class ClipEncoderLayer(nn.Module):

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        ln = lambda: LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, cfg.param_dtype, device)
        self.self_attn = ClipAttention(cfg, device)
        self.layer_norm1, self.layer_norm2 = ln(), ln()
        self.fc1 = _lin(cfg, cfg.hidden_size, cfg.intermediate_size, device)
        self.fc2 = _lin(cfg, cfg.intermediate_size, cfg.hidden_size, device)

    def forward(self, x, causal: bool):
        dt = self.cfg.dtype
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + dense(quick_gelu(dense(self.layer_norm2(x), self.fc1, dt)), self.fc2, dt)


class ClipTextModel(nn.Module):
    """The causal text tower: ``input_ids`` [B, S] → (last hidden state,
    the hidden state at each row's first EOS)."""

    def __init__(self, cfg: ClipTextConfig, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.token_embedding = nn.utils.skip_init(nn.Embedding, cfg.vocab_size, cfg.hidden_size, device=dev,
                                                  dtype=cfg.param_dtype)
        self.position_embedding = nn.Parameter(torch.empty(cfg.max_position_embeddings, cfg.hidden_size, device=dev,
                                                           dtype=cfg.param_dtype))
        self.layers = nn.ModuleList([ClipEncoderLayer(cfg, dev) for _ in range(cfg.num_hidden_layers)])
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, cfg.param_dtype, dev)

    def forward(self, input_ids):
        cfg = self.cfg
        x = F.embedding(input_ids.long(), self.token_embedding.weight).to(cfg.dtype) + \
            self.position_embedding[None, :input_ids.shape[1]].to(cfg.dtype)
        for layer in self.layers:
            x = layer(x, causal=True)
        x = self.final_layer_norm(x)
        eos = torch.argmax((input_ids == cfg.eos_token_id).int(), dim=1)
        return x, x[torch.arange(x.shape[0], device=x.device), eos]


class ClipVisionModel(nn.Module):
    """The vision tower: pixels [B, H, W, C] → (last hidden state, the
    post-LN class token)."""

    def __init__(self, cfg: ClipVisionConfig, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        e, p = cfg.hidden_size, cfg.patch_size
        self.patch_embedding = nn.utils.skip_init(nn.Conv2d, cfg.num_channels, e, p, stride=p, bias=False,
                                                  device=dev, dtype=cfg.param_dtype)
        self.class_embedding = nn.Parameter(torch.empty(e, device=dev, dtype=cfg.param_dtype))
        grid = cfg.image_size // p
        self.position_embedding = nn.Parameter(torch.empty(grid * grid + 1, e, device=dev, dtype=cfg.param_dtype))
        ln = lambda: LayerNorm(e, cfg.layer_norm_eps, cfg.dtype, cfg.param_dtype, dev)
        self.pre_layrnorm = ln()    # the HF checkpoint's own spelling
        self.layers = nn.ModuleList([ClipEncoderLayer(cfg, dev) for _ in range(cfg.num_hidden_layers)])
        self.post_layernorm = ln()

    def forward(self, pixel_values):
        cfg = self.cfg
        x = pixel_values.permute(0, 3, 1, 2).to(cfg.dtype)
        patches = F.conv2d(x, self.patch_embedding.weight.to(cfg.dtype), stride=cfg.patch_size)   # [B, E, gh, gw]
        b, e = patches.shape[:2]
        x = patches.flatten(2).transpose(1, 2)                                                      # [B, gh·gw, E]
        x = torch.cat([self.class_embedding.to(cfg.dtype).expand(b, 1, e), x], dim=1)
        x = self.pre_layrnorm(x + self.position_embedding[None].to(cfg.dtype))
        for layer in self.layers:
            x = layer(x, causal=False)
        return x, self.post_layernorm(x[:, 0])


class ClipModel(nn.Module):
    """The dual encoder (HF ``CLIPModel``): ``(input_ids, pixel_values)`` →
    ``(logits_per_image, logits_per_text, text_embeds, image_embeds)``."""

    def __init__(self, text_cfg: ClipTextConfig, vision_cfg: ClipVisionConfig, projection_dim: int = 512,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.text_model = ClipTextModel(text_cfg, dev)
        self.vision_model = ClipVisionModel(vision_cfg, dev)
        proj = lambda fan_in: nn.utils.skip_init(nn.Linear, fan_in, projection_dim, bias=False, device=dev,
                                                 dtype=torch.float32)
        self.text_projection = proj(text_cfg.hidden_size)
        self.visual_projection = proj(vision_cfg.hidden_size)
        self.logit_scale = nn.Parameter(torch.full((), 2.6592, device=dev))

    def forward(self, input_ids, pixel_values):
        _, tpool = self.text_model(input_ids)
        _, vpool = self.vision_model(pixel_values)
        t = F.linear(tpool.float(), self.text_projection.weight)
        v = F.linear(vpool.float(), self.visual_projection.weight)
        t = t / torch.linalg.norm(t, dim=-1, keepdim=True)
        v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
        logits_per_text = t @ v.T * torch.exp(self.logit_scale)
        return logits_per_text.T, logits_per_text, t, v
