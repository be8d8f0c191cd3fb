"""Per-architecture inference policies (port of
``deepspeed_tpu/inference/v2/model_implementations``)."""

from .policies import (POLICY_REGISTRY, FalconPolicy, InferenceV2Policy, InternLMPolicy, LlamaPolicy, MistralPolicy,
                       MixtralPolicy, OPTPolicy, Phi3Policy, PhiPolicy, Qwen2MoePolicy, Qwen2Policy,
                       convert_hf_state_dict, policy_for)

__all__ = ["POLICY_REGISTRY", "FalconPolicy", "InferenceV2Policy", "InternLMPolicy", "LlamaPolicy", "MistralPolicy",
           "MixtralPolicy", "OPTPolicy", "Phi3Policy", "PhiPolicy", "Qwen2MoePolicy", "Qwen2Policy",
           "convert_hf_state_dict", "policy_for"]
