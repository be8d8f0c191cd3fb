"""The logical axis names of the JAX package's parameters (port of
``deepspeed_tpu/axes.py``): ``models/convert.py`` tags each port parameter
with those of its JAX leaf, and ``module_inject/tp_rules.py`` maps them to
mesh axes per ZeRO stage."""

# dense transformer axes (models/llama.py et al.)
EMBED = "embed"
MLP = "mlp"
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
VOCAB = "vocab"
LAYERS = "layers"
POSITIONS = "positions"   # a learned position table (GPT-2's wpe; replicated)

# MoE axes (moe/experts.py, moe/layer.py)
EXPERTS = "experts"
EXPERT_EMBED = "expert_embed"
EXPERT_MLP = "expert_mlp"
EXPERTS_GATE = "experts_gate"
