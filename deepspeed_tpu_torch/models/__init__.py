"""The port's model zoo (port of ``deepspeed_tpu/models``): the training
forwards of Llama, Mixtral and Qwen2-MoE, and the paged serving twins of
every served family (``llama_cache.py``, ``mixtral_cache.py``,
``cache_zoo.py``)."""

from .llama import LlamaConfig, LlamaForCausalLM, causal_lm_loss  # noqa: F401
from .mixtral import MixtralConfig, MixtralForCausalLM, make_mixtral_loss_fn, mixtral_lm_loss  # noqa: F401
