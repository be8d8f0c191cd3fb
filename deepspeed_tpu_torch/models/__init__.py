"""The port's model zoo (port of ``deepspeed_tpu/models``): the training
forwards of Llama (Mistral, Qwen2, InternLM and Phi-3 through its config),
Falcon, OPT, Phi, Mixtral and Qwen2-MoE, the paged serving twins of the
families the v2 engine serves (``llama_cache.py``, ``mixtral_cache.py``,
``cache_zoo.py``), and the cache-free models of the v1-only families
(``gpt_family.py``, ``gpt2.py``, ``bert.py``, ``clip.py``)."""

from .llama import LlamaConfig, LlamaForCausalLM, causal_lm_loss  # noqa: F401
from .mixtral import MixtralConfig, MixtralForCausalLM, make_mixtral_loss_fn, mixtral_lm_loss  # noqa: F401
