"""The shared harness of the serving-stack parity tests
(``tests/test_torch_serving_*.py``).

The tiny float32 Llama of the JAX package's serving tests (vocab 128, hidden
64, 2 layers, 4/2 heads, page 8) is built twice from one set of seeded
weights: the JAX engine on its params, and the port's
``build_engine(device="cpu")`` on ``models/convert.py::jax_llama_to_state_dict``
of the same params.  A :class:`Backend` wraps either package behind one
interface (engines, the serving frontend, KV transfer, the host tier,
sessions), so each scenario runs unchanged over both and its observables —
tokens, request states, stats counters, page accounting — are compared.
Request states are compared by name: the two packages have their own enums.
"""

import dataclasses
import importlib

import numpy as np

PAGE = 8
#: the scheduler of the JAX serving tests
SCHED = dict(token_budget=64, max_seqs=8, prefill_chunk=8, decode_bucket=4)


class Backend:
    """One package's serving stack over the tiny Llama.  ``generate`` is
    memoised: a golden is computed once per backend and key."""

    def __init__(self, name: str, cfg, params, dtype):
        self.name = name
        root = "deepspeed_tpu" if name == "jax" else "deepspeed_tpu_torch"
        self.serving = importlib.import_module(f"{root}.serving")
        self.kvtransfer = importlib.import_module(f"{root}.serving.kvtransfer")
        self.kvtier = importlib.import_module(f"{root}.serving.kvtier")
        self.sessions = importlib.import_module(f"{root}.serving.sessions")
        self.telemetry = importlib.import_module(f"{root}.telemetry")
        self.fault_injection = importlib.import_module(f"{root}.resilience.fault_injection")
        self.v2 = importlib.import_module(f"{root}.inference.v2")
        self.sched = importlib.import_module(f"{root}.inference.v2.scheduler")
        self.cache_mod = importlib.import_module(f"{root}.models.llama_cache")
        self.cfg, self.params, self.dtype = cfg, params, dtype
        self.RequestState = self.serving.RequestState
        self._goldens = {}

    def engine(self, num_pages=64, max_seqs=8, prefill_chunk=8, max_pages_per_seq=8, decode_bucket=4, **overrides):
        kv = self.cache_mod.PagedKVConfig(num_pages=num_pages, page_size=PAGE, max_pages_per_seq=max_pages_per_seq)
        sched = self.sched.SchedulerConfig(**{**SCHED, "max_seqs": max_seqs, "prefill_chunk": prefill_chunk,
                                              "decode_bucket": decode_bucket})
        overrides.setdefault("decode_steps_per_dispatch", 1)
        overrides.setdefault("kv_dtype", self.dtype)
        econf = self.v2.RaggedInferenceEngineConfig(kv=kv, scheduler=sched, **overrides)
        if self.name == "jax":
            return self.v2.build_engine(self.cfg, self.params, econf)
        return self.v2.build_engine(self.cfg, self.params, econf, device="cpu")

    def serve(self, config=None, tier_config=None, tier=False, monitor=None, **engine_kw):
        """A ``ServingEngine`` on a ``VirtualClock`` (every step costs 1.0
        virtual second), with a ``TieredKVManager`` when ``tier`` or
        ``tier_config`` is given; returns ``(serve, tier or None)``."""
        serve = self.serving.ServingEngine(self.engine(**engine_kw), clock=self.serving.VirtualClock(),
                                           config=config or self.serving.ServingConfig(), monitor=monitor)
        mgr = None
        if tier or tier_config is not None:
            mgr = self.kvtier.TieredKVManager(serve.engine, config=tier_config)
            serve.attach_tier(mgr)
        return serve, mgr

    def generate(self, prompts, max_new_tokens, **engine_kw):
        key = (tuple(tuple(p) for p in prompts), max_new_tokens, tuple(sorted(engine_kw.items())))
        if key not in self._goldens:
            self._goldens[key] = self.engine(**engine_kw).generate([list(p) for p in prompts],
                                                                   max_new_tokens=max_new_tokens)
        return self._goldens[key]


def make_backends(max_pos: int = 128):
    """``{"jax": Backend, "port": Backend}`` over one set of weights (the
    JAX model's ``init`` at ``PRNGKey(0)``, as the JAX serving tests seed
    it)."""
    import jax
    import jax.numpy as jnp
    import torch

    from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from deepspeed_tpu_torch.models.convert import jax_llama_to_state_dict
    from deepspeed_tpu_torch.models.llama import LlamaConfig

    shape = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=max_pos, rope_theta=1e4)
    jcfg = JaxLlamaConfig(**shape, dtype=jnp.float32, scan_layers=True, remat=False)
    tcfg = LlamaConfig(**shape, dtype=torch.float32, attention_impl="flash")
    variables = JaxLlama(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    state = jax_llama_to_state_dict(jax.tree.map(np.asarray, variables), tcfg)
    return {"jax": Backend("jax", jcfg, variables, jnp.float32),
            "port": Backend("port", tcfg, state, torch.float32)}


def request_view(req) -> dict:
    """A request's observables, comparable across the two packages."""
    return {"state": req.state.name, "tokens": list(req.tokens),
            "history": [s.name for s, _ in req.history], "preemptions": req.preemptions,
            "ttft": req.ttft, "tpot": req.tpot, "queue_wait": req.queue_wait,
            "met_deadline": req.met_deadline, "reject_reason": req.reject_reason,
            "finish_ts": req.finish_ts, "admitted_ts": req.admitted_ts}


def page_view(engine) -> dict:
    """Page accounting: free pages, prefix-cached pages, arena size, live
    sequences."""
    pc = engine.kv.prefix_cache
    return {"free": engine.kv.allocator.free_pages, "cached": pc.cached_pages if pc is not None else 0,
            "num_pages": engine.kv.num_pages, "live": sorted(engine.state.seqs)}


def serve_view(serve, reqs=()) -> dict:
    """The frontend's summary, its requests, page accounting and clock."""
    return {"summary": serve.summary(), "requests": [request_view(r) for r in reqs],
            "pages": page_view(serve.engine), "clock": serve.clock.now(),
            "stats": {f.name: getattr(serve.stats, f.name) for f in dataclasses.fields(serve.stats)
                      if f.name != "finished"}}


def assert_clean(engine) -> None:
    """No live sequence, and after dropping the prefix cache every page but
    the reserved null page is free."""
    assert not engine.state.seqs
    if engine.kv.prefix_cache is not None:
        engine.kv.prefix_cache.evict(engine.kv.num_pages)
    assert engine.kv.allocator.free_pages == engine.kv.num_pages - 1
