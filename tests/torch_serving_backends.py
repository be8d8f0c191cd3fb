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
The fleet tests run the JAX package's own test functions over both packages
instead (``unit_scenario``, below).
"""

import builtins
import dataclasses
import enum
import functools
import importlib
import inspect
import re
import sys
import types
from pathlib import Path

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
        self.fleet = importlib.import_module(f"{root}.serving.fleet")
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


# ------------------------------------------------------------------------
# The JAX package's own fleet tests, run over either package.
#
# A fleet scenario is a whole test function of ``tests/unit/`` (its helpers,
# its fixtures, its assertions).  ``unit_scenario`` executes that test
# module's source once per package: for the port, its ``deepspeed_tpu``
# imports resolve to ``deepspeed_tpu_torch`` (module level and inside the
# test bodies alike), ``jax.numpy``'s dtypes to torch's, ``build_engine`` to
# the port's on the CPU and ``LlamaConfig`` to the port's of the same shape;
# the weights are the JAX fixture's, converted.  The test body is unchanged
# and makes its own assertions on either package.  Every object of
# ``RECORDED_CLASSES`` the scenario builds and every result of
# ``RECORDED_FUNCTIONS`` is recorded, and ``unit_scenario`` returns their
# observables — for a router each request's tokens, state and history
# (names, not enums) and ``router.summary()`` whole; for a pool the health
# history, page accounting of every live replica, the metrics snapshot and
# the clock; for a state machine its history and stats — for the caller to
# compare across the two packages.
# ------------------------------------------------------------------------

UNIT = Path(__file__).resolve().parent / "unit"


def _port_name(name: str) -> str:
    return "deepspeed_tpu_torch" + name[len("deepspeed_tpu"):]


def _port_overrides(name: str, module) -> dict:
    """What a test written against the JAX package needs changed to call the
    port: the engine factory's device (the port defaults to the card) and the
    model config (the JAX one carries scan/remat layout fields)."""
    if name == "deepspeed_tpu_torch.inference.v2":
        return {"build_engine": functools.partial(module.build_engine, device="cpu")}
    if name == "deepspeed_tpu_torch.models.llama":
        fields = {f.name for f in dataclasses.fields(module.LlamaConfig)}

        def LlamaConfig(**kw):
            return module.LlamaConfig(**{k: v for k, v in kw.items() if k in fields})
        return {"LlamaConfig": LlamaConfig}
    return {}


_UNIT_MODULES = {}


#: what a scenario's observables are read from: every instance of these
#: classes and every value these functions return, as the test module builds
#: them
RECORDED_CLASSES = ("Router", "ReplicaPool", "ServingEngine", "HealthTracker", "FleetHealthView",
                    "ControlTransport", "OverloadController", "Autoscaler", "PrefixDirectory", "FlightRecorder",
                    "SLOBurnMonitor", "MetricsRegistry", "TenantRegistry", "Counter", "Gauge", "Histogram",
                    "StepWatchdog", "FleetSessionCoordinator", "Tracer")
RECORDED_FUNCTIONS = ("poisson_mixed_arrivals", "heavy_tail_arrivals", "diurnal_arrivals", "flash_crowd_arrivals",
                      "session_arrivals", "prefix_chain_hashes", "classify_fatal")


def _recording(obj, log):
    if isinstance(obj, type):
        class Recorded(obj):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                log.append(self)
        Recorded.__name__ = Recorded.__qualname__ = obj.__name__
        return Recorded

    @functools.wraps(obj)
    def recorded(*a, **kw):
        out = obj(*a, **kw)
        log.append(("returned", obj.__name__, out))
        return out
    return recorded


def _import_hook(package: str, log: list):
    """The ``__import__`` of a JAX test module executed over ``package``.
    Every ``from deepspeed_tpu... import`` gets a copy of the module in which
    the names of ``RECORDED_CLASSES``/``RECORDED_FUNCTIONS`` log into
    ``log``; over the port, ``deepspeed_tpu`` is ``deepspeed_tpu_torch``
    (with ``_port_overrides``) and ``jax.numpy`` names torch's dtypes."""
    import torch
    jax_shim = types.SimpleNamespace(
        numpy=types.SimpleNamespace(float32=torch.float32, bfloat16=torch.bfloat16, int32=torch.int32))
    proxies, wrapped = {}, {}

    def proxy(real):
        if real.__name__ not in proxies:
            mod = types.ModuleType(real.__name__)
            mod.__dict__.update(real.__dict__)
            if package == "port":
                mod.__dict__.update(_port_overrides(real.__name__, real))
            for attr in RECORDED_CLASSES + RECORDED_FUNCTIONS:
                obj = mod.__dict__.get(attr)
                if obj is not None:
                    if id(obj) not in wrapped:
                        wrapped[id(obj)] = _recording(obj, log)
                    mod.__dict__[attr] = wrapped[id(obj)]
            proxies[real.__name__] = mod
        return proxies[real.__name__]

    def hook(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and package == "port":
            if name == "jax" or name.startswith("jax."):
                return jax_shim
            if name == "deepspeed_tpu" or name.startswith("deepspeed_tpu."):
                name = _port_name(name)
        module = builtins.__import__(name, globals, locals, fromlist, level)
        if level == 0 and fromlist and name.split(".")[0] in ("deepspeed_tpu", "deepspeed_tpu_torch"):
            return proxy(module)
        return module

    return hook


def unit_module(relpath: str, package: str):
    """The test module ``tests/unit/<relpath>`` executed over ``package``
    ("jax" or "port"), once per process, through ``_import_hook``: each
    instance of ``RECORDED_CLASSES`` it builds and each result of
    ``RECORDED_FUNCTIONS`` it takes is logged into its ``_RECORDED``."""
    key = (relpath, package)
    if key not in _UNIT_MODULES:
        path = UNIT / relpath
        name = f"_unit_{package}_{path.stem}"
        mod = types.ModuleType(name)
        mod.__file__ = str(path)
        mod._RECORDED = []
        mod._FIXTURES = {}
        bt = dict(builtins.__dict__)
        bt["__import__"] = _import_hook(package, mod._RECORDED)
        mod.__dict__["__builtins__"] = bt
        sys.modules[name] = mod
        exec(compile(path.read_text(), str(path), "exec"), mod.__dict__)
        _UNIT_MODULES[key] = mod
    return _UNIT_MODULES[key]


class _TmpPathFactory:
    def __init__(self, root: Path):
        self.root, self.n = root, 0

    def mktemp(self, name: str) -> Path:
        self.n += 1
        p = self.root / f"{name}{self.n}"
        p.mkdir(parents=True)
        return p


def _fixture(mod, name: str, tmp_path: Path, jax_mod):
    """A module-scoped fixture of the test module, computed once per
    package.  The port's ``trained_params`` are the JAX fixture's weights
    through ``jax_llama_to_state_dict``."""
    if name in mod._FIXTURES:
        return mod._FIXTURES[name]
    if name == "tmp_path_factory":
        value = _TmpPathFactory(tmp_path / "factory")
    elif name == "trained_params" and mod is not jax_mod:
        import jax
        from deepspeed_tpu_torch.models.convert import jax_llama_to_state_dict
        variables = _fixture(jax_mod, "trained_params", tmp_path, jax_mod)
        value = jax_llama_to_state_dict(jax.tree.map(np.asarray, variables), mod.CFG)
    else:
        fn = getattr(mod, name)._get_wrapped_function()
        value = fn(**{p: _fixture(mod, p, tmp_path, jax_mod) for p in inspect.signature(fn).parameters})
    mod._FIXTURES[name] = value
    return value


_TMP_PATH = re.compile(r"^/.*?/(jax|port)/")


def plain(x):
    """Enums by name, tuples as lists, sets sorted, numpy values as Python
    values, and a path under a scenario's per-package temporary directory
    relative to it: a value comparable across the two packages."""
    if isinstance(x, enum.Enum):
        return x.name
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, str):
        return _TMP_PATH.sub("<tmp>/", x)
    return x


def fleet_request_view(fr) -> dict:
    return {f.name: getattr(fr, f.name) for f in dataclasses.fields(fr) if not f.name.startswith("_")}


def pool_view(pool) -> dict:
    """Health history, page accounting of every live replica, the metrics
    snapshot and the clock."""
    return {"health": pool.health.history, "clock": pool.clock.now(),
            "pages": {rid: page_view(rep.serve.engine) for rid, rep in sorted(pool.replicas.items())
                      if rep.serve is not None},
            "generations": {rid: rep.generation for rid, rep in sorted(pool.replicas.items())},
            "metrics": pool.metrics.snapshot() if pool.metrics is not None else None}


def router_view(router) -> dict:
    return {"summary": router.summary(), "requests": [fleet_request_view(r) for r in router.requests],
            "stats": router.stats, "kill_records": router.kill_records, "recovery_times": router.recovery_times}


def span_view(span) -> dict:
    return {attr: getattr(span, attr) for attr in span.__slots__}


def recorded_view(obj):
    """The observables of one recorded object (see ``RECORDED_CLASSES``)."""
    if isinstance(obj, tuple) and obj[:1] == ("returned", ):
        return {"returned": obj[1], "value": obj[2]}
    kind = type(obj).__name__
    if kind == "Router":
        view = router_view(obj)
    elif kind == "ReplicaPool":
        view = pool_view(obj)
    elif kind == "ServingEngine":
        view = {"summary": obj.summary(), "pages": page_view(obj.engine), "clock": obj.clock.now()}
    elif kind == "FleetSessionCoordinator":
        view = {"stats": obj.stats, "transcripts": obj.transcripts(),
                "sessions": [(s.state, s.turn_records) for s in obj.sessions]}
    elif kind == "Tracer":
        view = {"spans": [span_view(sp) for sp in obj.spans], "dropped": obj.dropped_spans}
    elif kind == "MetricsRegistry":
        view = {"snapshot": obj.snapshot()}
    elif kind == "TenantRegistry":
        view = {"specs": {n: dataclasses.asdict(obj.spec(n)) for n in obj.names()}, "passes": obj._pass}
    else:
        view = {"summary": obj.summary()} if hasattr(obj, "summary") else {}
        for attr in ("history", "stats", "moves", "decisions", "resizes", "alerts", "dump_log", "value", "counts",
                     "clamped_negative", "hangs"):
            value = getattr(obj, attr, None)
            if value is not None and not callable(value):
                view[attr] = value
    return {"kind": kind, **view}


def unit_fixture(relpath: str, package: str, name: str, tmp_path: Path):
    """A fixture of the test module ``tests/unit/<relpath>`` over
    ``package`` (``trained_params``: the port's are the JAX weights
    converted)."""
    return _fixture(unit_module(relpath, package), name, tmp_path / package / "fixtures",
                    unit_module(relpath, "jax"))


def unit_scenario(relpath: str, test: str, package: str, tmp_path: Path, **params) -> list:
    """Run the test function ``test`` of ``tests/unit/<relpath>`` over
    ``package`` with the given parameters (its fixtures resolved as pytest
    would, module-scoped) and return the observables of every object it built of
    ``RECORDED_CLASSES`` and every result of ``RECORDED_FUNCTIONS``, in
    order.  Fault injection is disarmed and the ``resilience/*`` event
    ring cleared afterwards, as the JAX test modules' autouse fixtures do."""
    jax_mod = unit_module(relpath, "jax")
    mod = unit_module(relpath, package)
    del mod._RECORDED[:]
    fn = getattr(mod, test)
    tmp = tmp_path / package
    tmp.mkdir(parents=True, exist_ok=True)
    kwargs = {}
    for p in inspect.signature(fn).parameters:
        if p in params:
            kwargs[p] = params[p]
        elif p == "tmp_path":
            kwargs[p] = tmp
        else:
            kwargs[p] = _fixture(mod, p, tmp / "fixtures", jax_mod)
    root = "deepspeed_tpu" if package == "jax" else "deepspeed_tpu_torch"
    try:
        fn(**kwargs)
    finally:
        importlib.import_module(f"{root}.resilience.fault_injection").configure_fault_injection(None)
        importlib.import_module(f"{root}.resilience.events").clear()
    out = [plain(recorded_view(obj)) for obj in mod._RECORDED]
    del mod._RECORDED[:]
    return out
