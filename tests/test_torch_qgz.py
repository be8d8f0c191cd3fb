"""Data-parallel training over two gloo ranks on the CPU, with the ZeRO++
quantized gradient wire (``deepspeed_tpu_torch/runtime/comm/compressed.py``,
the engine's qgZ and LoCo steps), against the JAX package on a
``MeshSpec(data=2)`` mesh of two of the eight CPU devices.

  (a) the four collective functions on identical per-rank inputs, bits 8
      and 4, sizes that need padding, and the grouped exchange over a list
      of tensors (with and without a LoCo error): bit-identical to the JAX
      functions under ``shard_map`` (the grouped exchange to
      ``padded_quant_allreduce`` of each tensor), evaluated op by op
      (compiled, XLA rewrites the divide by qmax and contracts products
      into sums: last-bit differences, see ``tests/test_torch_quant.py``);
  (b) 3 qgZ steps, 3 LoCo steps and 3 float32-wire steps (without and with
      a ``loss_mask`` that hides 3/4 of rank 1's tokens) of the engine (the
      tiny Llama of ``tests/unit/runtime/test_onebit_transport.py``, f32,
      AdamW lr 1e-3, clipping 1.0) against the JAX engine on the same
      weights: losses within rtol 1e-4; parameters within 1e-5 on all but
      0.1% of the elements and within 2·lr·steps on the rest (Adam moves a
      parameter by about lr whatever its gradient, so a code that flips on a
      rounding boundary of x/scale can move it by up to lr either way).  On
      the float32 wire JAX takes one token mean over the global batch, so
      with the mask a per-rank mean would be wrong;
  (c) the two ranks' parameters are bit-identical after the steps;
  (d) qgZ within 5e-2 of the port's float32-wire control;
  (e) the CommsLogger's whole record of the steps equals the JAX engine's:
      one ``all_to_all_quant_reduce`` entry of the JAX formula's bytes per
      qgZ or LoCo step after the first, nothing for the float32 wire;
  (f) stage 2 over two ranks trains partitioned and matches the float32
      wire; qgZ with gas 2 warns once and runs the float32 wire;
  (g) a qgZ step makes 4 collectives for the wire (2 all-to-alls, 2
      all-gathers) besides its loss and norm all-reduces;
  (h) the collectives of (a) at W = 3 (three ranks, three CPU devices),
      where the mean's sum · fl(1/3) and a true divide by 3 differ, and
      ``comm.all_reduce(AVG)`` against JAX's eager ``pmean``; on a card,
      three ranks sharing it: the grouped exchange against the per-tensor
      route, and AVG against SUM then a divide by a tensor, bit for bit.

Each test spawns its ranks (``torch.multiprocessing``, spawn) that
rendezvous through a file under ``tmp_path``; the rank functions are in this
module, which imports no JAX at its top (JAX is imported inside the tests),
so a rank starts without it.  A rank that fails or hangs fails its test
within ``RANK_TIMEOUT_S``.
"""

import logging
import math
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

WORLD = 2
RANK_TIMEOUT_S = 240
LR, STEPS, BATCH, SEQ = 1e-3, 3, 8, 32


def _rank_entry(rank, world, init_method, fn, args, queue):
    import deepspeed_tpu_torch.comm.comm as comm
    torch.set_num_threads(2)
    try:
        comm.init_distributed(dist_backend="gloo", init_method=init_method, rank=rank, world_size=world,
                              timeout=RANK_TIMEOUT_S // 2, verbose=False)
        queue.put((rank, fn(rank, *args), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if comm.is_initialized():
            torch.distributed.destroy_process_group()


def run_ranks(tmp_dir, fn, *args, world=WORLD):
    """``fn(rank, *args)`` on each of ``world`` gloo ranks; returns their
    results in rank order, or raises with a failed rank's traceback."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init = f"file://{tmp_dir}/rendezvous"
    procs = [ctx.Process(target=_rank_entry, args=(r, world, init, fn, args, queue)) for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, out, err = queue.get(timeout=RANK_TIMEOUT_S)
            if err is not None:
                raise AssertionError(f"rank {rank} failed:\n{err}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    assert [p.exitcode for p in procs] == [0] * world
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------- (a) collectives

#: the tensors of the grouped exchange (int8 only): sizes that need padding,
#: 2-D shapes, and an all-zero tensor (the last)
GROUPED_SHAPES = ((768, ), (40, 25), (64, 64), (256, 256), (3, 100))
#: the same without the 256 × 256 tensor, for W = 3 (the eager JAX reference
#: takes seconds per thousand blocks)
GROUPED_SHAPES_SMALL = ((768, ), (40, 25), (64, 64), (3, 100))


def _collective_table(world, grouped_shapes):
    """name → (function, bits, elements per rank, with an error state, the
    grouped exchange's shapes or None) at ``world`` ranks."""
    table = {
        f"{fn}-int{bits}": (fn, bits, n, err, None)
        for bits in (8, 4)
        for fn, n, err in (("all_to_all_quant_reduce", 3 * world * 256, False), ("quantized_all_gather", 3 * 256, False),
                           ("padded_quant_allreduce", 1000, False), ("padded_quant_allreduce_error", 1000, True),
                           ("loco_all_to_all_quant_reduce", 2 * world * 256, True))
    }
    table.update({f"{fn}-int8": (fn, 8, sum(math.prod(s) for s in grouped_shapes), err, grouped_shapes)
                  for fn, err in (("grouped_quant_allreduce", False), ("grouped_quant_allreduce_error", True))})
    return table


COLLECTIVES = _collective_table(WORLD, GROUPED_SHAPES)
#: W = 3: a mean over 3 copies is where sum / 3 and sum · fl(1/3) differ
COLLECTIVES_W3 = _collective_table(3, GROUPED_SHAPES_SMALL)


def _collective_inputs(spec, world=WORLD):
    """Per-rank gradients ``[world, n]`` with block scales from 1e-4 to 1e2,
    and an error state (or None)."""
    fn, bits, n, err, shapes = spec
    rng = np.random.default_rng(bits * 100 + n)
    scales = np.repeat(10.0**rng.uniform(-4, 2, size=(world, -(-n // 64))), 64, axis=1)[:, :n]
    x = (rng.normal(size=(world, n)) * scales).astype(np.float32)
    if fn.startswith("grouped"):
        x[:, -math.prod(shapes[-1]):] = 0.0
    e = (rng.normal(size=(world, n)) * 1e-2).astype(np.float32) if err else None
    return x, e


def _grouped(flat, shapes):
    """A rank's flat ``[n]`` as the grouped exchange's list of tensors."""
    return [t.reshape(s) for t, s in zip(flat.split([math.prod(s) for s in shapes]), shapes)]


def _port_collective(spec, x, e):
    from deepspeed_tpu_torch.runtime.comm import compressed as tc
    fn, bits, _, _, shapes = spec
    x = torch.from_numpy(x)
    e = None if e is None else torch.from_numpy(e)
    if fn == "all_to_all_quant_reduce":
        out = tc.all_to_all_quant_reduce(x, bits=bits)
    elif fn == "quantized_all_gather":
        out = tc.quantized_all_gather(x, bits=bits)
    elif fn == "padded_quant_allreduce":
        out = tc.padded_quant_allreduce(x, bits=bits)
    elif fn == "padded_quant_allreduce_error":
        out = tc.padded_quant_allreduce(x, bits=bits, error=e, err_beta=0.8)
    elif fn == "grouped_quant_allreduce":
        wire = tc.GroupedQuantAllreduce(shapes, x.dtype, bits=bits)
        out = torch.cat([t.reshape(-1) for t in wire(_grouped(x, shapes))])
    elif fn == "grouped_quant_allreduce_error":
        wire = tc.GroupedQuantAllreduce(shapes, x.dtype, bits=bits)
        full, err = wire(_grouped(x, shapes), errors=_grouped(e, shapes), err_beta=0.8)
        out = tuple(torch.cat([t.reshape(-1) for t in ts]) for ts in (full, err))
    else:
        out = tc.loco_all_to_all_quant_reduce(x, e, bits=bits, err_beta=0.8)
    return [t.numpy() for t in (out if isinstance(out, tuple) else (out, ))]


def _collectives_rank(rank, table, inputs):
    return {name: _port_collective(table[name], x[rank], None if e is None else e[rank])
            for name, (x, e) in inputs.items()}


def _jax_collective(spec, x, e, world=WORLD):
    """The JAX function under an eager (op by op) shard_map over ``world``
    CPU devices: outputs ``[world, ...]``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    from deepspeed_tpu.runtime.comm import compressed as jc
    fn, bits, _, _, shapes = spec
    mesh = create_mesh(MeshSpec(data=world), devices=jax.devices()[:world])

    def body(xs, es):
        xv, ev = xs[0], es[0]
        if fn == "all_to_all_quant_reduce":
            out = jc.all_to_all_quant_reduce(xv, "data", bits=bits)
        elif fn == "quantized_all_gather":
            out = jc.quantized_all_gather(xv, "data", bits=bits)
        elif fn == "padded_quant_allreduce":
            out = jc.padded_quant_allreduce(xv, "data", world, bits=bits)
        elif fn == "padded_quant_allreduce_error":
            out = jc.padded_quant_allreduce(xv, "data", world, bits=bits, error=ev, err_beta=0.8)
        elif fn.startswith("grouped"):   # the JAX engine's tree.map of padded_quant_allreduce
            starts = np.cumsum([0] + [math.prod(s) for s in shapes])
            pieces = [(xv[a:b].reshape(s), ev[a:b].reshape(s)) for a, b, s in zip(starts, starts[1:], shapes)]
            if fn == "grouped_quant_allreduce":
                out = jnp.concatenate([jc.padded_quant_allreduce(xt, "data", world).reshape(-1) for xt, _ in pieces])
            else:
                pairs = [jc.padded_quant_allreduce(xt, "data", world, error=et, err_beta=0.8) for xt, et in pieces]
                out = tuple(jnp.concatenate([p[i].reshape(-1) for p in pairs]) for i in range(2))
        else:
            out = jc.loco_all_to_all_quant_reduce(xv, ev, "data", bits=bits, err_beta=0.8)
        return tuple(o[None] for o in (out if isinstance(out, tuple) else (out, )))

    run = jax.shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P("data"), check_vma=False)
    return [np.asarray(o) for o in run(x, np.zeros_like(x) if e is None else e)]


@pytest.fixture(scope="module")
def collective_results(tmp_path_factory):
    inputs = {name: _collective_inputs(spec) for name, spec in COLLECTIVES.items()}
    return inputs, run_ranks(tmp_path_factory.mktemp("qgz_collectives"), _collectives_rank, COLLECTIVES, inputs)


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collectives_are_bit_identical_to_jax(name, collective_results):
    inputs, ranks = collective_results
    x, e = inputs[name]
    want = _jax_collective(COLLECTIVES[name], x, e)
    for rank, got in enumerate(ranks):
        assert len(got[name]) == len(want)
        for g, w in zip(got[name], want):
            np.testing.assert_array_equal(g, w[rank], err_msg=f"{name}, rank {rank}")


def _avg_input(world, n=4096):
    """Per-rank ``[world, n]`` multiples of 2^-10 below 2^10: every sum of
    them is exact, so gloo's ring order (at W = 3 it is not JAX's
    ((x0 + x1) + x2)) cannot show and the test sees only the divide."""
    rng = np.random.default_rng(world)
    return (rng.integers(-2**20, 2**20, size=(world, n)) * 2.0**-10).astype(np.float32)


def _world3_rank(rank, table, inputs, avg):
    from deepspeed_tpu_torch.comm import comm
    out = _collectives_rank(rank, table, inputs)
    out["all_reduce_avg"] = comm.all_reduce(torch.from_numpy(avg[rank].copy()), comm.ReduceOp.AVG).numpy()
    return out


@pytest.fixture(scope="module")
def collective_results_w3(tmp_path_factory):
    inputs = {name: _collective_inputs(spec, 3) for name, spec in COLLECTIVES_W3.items()}
    avg = _avg_input(3)
    ranks = run_ranks(tmp_path_factory.mktemp("qgz_collectives_w3"), _world3_rank, COLLECTIVES_W3, inputs, avg,
                      world=3)
    return inputs, avg, ranks


@pytest.mark.parametrize("name", list(COLLECTIVES_W3))
def test_collectives_at_world_3_are_bit_identical_to_jax(name, collective_results_w3):
    """At W = 3 the mean over the received copies is ``jnp.mean``'s
    sum · fl(1/3), which a true divide by 3 misses in the last bit on about
    a fifth of the values."""
    inputs, _, ranks = collective_results_w3
    x, e = inputs[name]
    want = _jax_collective(COLLECTIVES_W3[name], x, e, world=3)
    for rank, got in enumerate(ranks):
        assert len(got[name]) == len(want)
        for g, w in zip(got[name], want):
            np.testing.assert_array_equal(g, w[rank], err_msg=f"{name}, rank {rank}")


def test_all_reduce_avg_at_world_3_matches_jax_pmean(collective_results_w3):
    """``comm.all_reduce(AVG)`` over 3 gloo ranks equals JAX's eager
    ``jax.lax.pmean`` over 3 CPU devices: a true divide of the sum by 3."""
    import jax
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    _, avg, ranks = collective_results_w3
    mesh = create_mesh(MeshSpec(data=3), devices=jax.devices()[:3])
    run = jax.shard_map(lambda xs: jax.lax.pmean(xs, "data"), mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                        check_vma=False)
    want = np.asarray(run(avg))
    assert not np.array_equal(want[0], avg.sum(axis=0) * np.float32(1 / 3))   # the two forms differ here
    for rank, got in enumerate(ranks):
        np.testing.assert_array_equal(got["all_reduce_avg"], want[rank], err_msg=f"rank {rank}")


def _card_world3_rank(rank, x, e, avg):
    """On the one card (cuda:0, shared by the 3 gloo ranks): the grouped
    exchange against ``padded_quant_allreduce`` of each tensor, without and
    with LoCo's error, and AVG against SUM then a divide by a tensor.
    Returns the count of values that differ in each comparison."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.runtime.comm import compressed as tc
    x, e, avg = (torch.from_numpy(a[rank]).cuda() for a in (x, e, avg))
    xs, es = _grouped(x, GROUPED_SHAPES), _grouped(e, GROUPED_SHAPES)
    wire = tc.GroupedQuantAllreduce(GROUPED_SHAPES, torch.float32, device="cuda")
    grouped = torch.cat([t.reshape(-1) for t in wire(xs)])
    per_tensor = torch.cat([tc.padded_quant_allreduce(t).reshape(-1) for t in xs])
    full, err = wire(xs, errors=es, err_beta=0.8)
    pairs = [tc.padded_quant_allreduce(t, error=et, err_beta=0.8) for t, et in zip(xs, es)]
    got_avg = comm.all_reduce(avg.clone(), comm.ReduceOp.AVG)
    total = comm.all_reduce(avg.clone(), comm.ReduceOp.SUM)
    torch.cuda.synchronize()
    return {"grouped": int((grouped != per_tensor).sum()),
            "grouped_loco": int((torch.cat([t.reshape(-1) for t in full]) !=
                                 torch.cat([p[0].reshape(-1) for p in pairs])).sum()),
            "grouped_loco_error": int((torch.cat([t.reshape(-1) for t in err]) !=
                                       torch.cat([p[1].reshape(-1) for p in pairs])).sum()),
            "avg": int((got_avg != total / torch.full_like(total, 3)).sum()),
            "avg_vs_scalar_divide": int((got_avg != total / 3).sum()), "n": grouped.numel()}


@pytest.mark.cuda
def test_world_3_on_the_card(tmp_path):
    """Three gloo ranks on the one card: the grouped exchange equals the
    per-tensor route bit for bit at W = 3 (each sums its ``[3, ·]`` copies
    with CUDA's ``sum(dim=0)``), and AVG is a true divide by 3 (CUDA turns a
    divide by a Python number into a product with its reciprocal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from deepspeed_tpu_torch.ops.op_builder import build_kernel
    build_kernel("quant")   # once, before the ranks load it
    x, e = _collective_inputs(_collective_table(3, GROUPED_SHAPES)["grouped_quant_allreduce_error-int8"], 3)
    avg = np.random.default_rng(3).normal(size=(3, 100_000)).astype(np.float32)
    ranks = run_ranks(tmp_path, _card_world3_rank, x, e, avg, world=3)
    print("W = 3 on the card, values that differ per rank:", ranks)
    for got in ranks:
        assert got["grouped"] == got["grouped_loco"] == got["grouped_loco_error"] == got["avg"] == 0, got


# ---------------------------------------------------------------- (b)-(f) the engine

DS_BASE = {"train_batch_size": BATCH, "gradient_clipping": 1.0, "steps_per_print": 0,
           "optimizer": {"type": "AdamW", "params": {"lr": LR}}}
QGZ = {"stage": 0, "zero_quantized_gradients": True}
RUNS = {"qgz": {**DS_BASE, "zero_optimization": QGZ},
        "loco": {**DS_BASE, "zero_optimization": {**QGZ, "zeropp_loco_param": {"err_beta": 0.8}}},
        "fp32_wire": {**DS_BASE, "zero_optimization": {"stage": 0}},
        "fp32_wire_masked": {**DS_BASE, "zero_optimization": {"stage": 0}},
        "qgz_gas2": {**DS_BASE, "gradient_accumulation_steps": 2, "zero_optimization": QGZ},
        "fp32_wire_gas2": {**DS_BASE, "gradient_accumulation_steps": 2, "zero_optimization": {"stage": 0}},
        "stage2": {**DS_BASE, "zero_optimization": {"stage": 2}}}


def _tiny_port_cfg():
    from deepspeed_tpu_torch.models import llama as tl
    return tl.LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64, rope_theta=1e4,
                          dtype=torch.float32, param_dtype=torch.float32, attention_impl="reference")


#: the runs whose batches carry a loss_mask
MASKED = ("fp32_wire_masked", )
#: the runs held against the JAX engine
JAX_RUNS = ("qgz", "loco", "fp32_wire", "fp32_wire_masked")


def _batches(masked=False):
    """The global batch, repeated; rank r takes rows [4r, 4r + 4).  With
    ``masked``, a loss_mask that keeps all of rank 0's tokens and the first
    quarter of each of rank 1's rows."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32)
    batch = {"input_ids": ids, "labels": ids}
    if masked:
        mask = np.ones((BATCH, SEQ), np.float32)
        mask[BATCH // WORLD:, SEQ // 4:] = 0
        batch["loss_mask"] = mask
    return [batch] * STEPS


def _comms_counts(comms_dict):
    """A CommsLogger's record without its times: {name: {bytes: count}}."""
    return {name: {size: entry[0] for size, entry in sizes.items()} for name, sizes in comms_dict.items()}


class _Warnings(logging.Handler):

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _engine_rank(rank, state):
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import llama as tl
    from deepspeed_tpu_torch.utils.logging import logger
    out = {}
    for name, ds_config in RUNS.items():
        warned = _Warnings()
        logger.addHandler(warned)
        model = tl.LlamaForCausalLM(_tiny_port_cfg(), device="cpu")
        eng = tds.initialize(model=model, config=ds_config, params=state, device="cpu")[0]
        comm.configure(enabled=True)   # a fresh logger: the record of the steps alone
        calls = comm.call_counts.copy()
        losses = [float(eng.train_batch(batch=b)) for b in _batches(name in MASKED)]
        calls = comm.call_counts - calls
        logger.removeHandler(warned)
        out[name] = {"losses": losses, "qgz": eng.qgz, "warnings": warned.messages, "partitioned": eng.zero is not None,
                     "params": {k: v.numpy().copy() for k, v in eng.module_state_dict().items()},
                     "wire_bytes": eng._compressed_wire_bytes,
                     "comms": _comms_counts(comm.comms_logger().comms_dict),
                     "collectives": dict(calls), "n_params": len(eng.params),
                     "loco_error_abs_max": None if eng.loco_error is None else
                     max(float(t.abs().max()) for t in eng.loco_error)}
    return out


def _jax_engine(name):
    """The JAX engine's run ``name`` on MeshSpec(data=2): its initial
    variables, losses, final parameters and CommsLogger record."""
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu as jds
    from deepspeed_tpu.comm import comm as jcomm
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    from deepspeed_tpu.models import llama as jl
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    cfg = jl.LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64, rope_theta=1e4,
                         dtype=jnp.float32, param_dtype=jnp.float32, scan_layers=False)
    model = jl.LlamaForCausalLM(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))
    mesh = create_mesh(MeshSpec(data=WORLD), devices=jax.devices()[:WORLD])
    eng, _, _, _ = jds.initialize(model=model, mesh=mesh, params=variables["params"], dist_init_required=False,
                                  config=JaxConfig(RUNS[name], dp_world_size=WORLD))
    saved = jcomm._COMMS_LOGGER
    jcomm.configure(enabled=True)
    try:
        losses = [float(eng.train_batch(batch=b)) for b in _batches(name in MASKED)]
        comms = _comms_counts(jcomm.comms_logger().comms_dict)
    finally:
        jcomm._COMMS_LOGGER = saved
    return variables, losses, jax.tree.map(np.asarray, eng.state.params), comms


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    """The JAX engine's qgZ, LoCo and float32-wire runs, and the port's runs
    on two ranks from the same initial weights."""
    import jax

    from deepspeed_tpu_torch.models.convert import jax_llama_to_state_dict
    jax_runs = {name: _jax_engine(name) for name in JAX_RUNS}
    variables = jax_runs["qgz"][0]
    cfg = _tiny_port_cfg()
    state = {k: v.numpy() for k, v in jax_llama_to_state_dict(jax.tree.map(np.asarray, variables), cfg).items()}
    ranks = run_ranks(tmp_path_factory.mktemp("qgz_engine"), _engine_rank, state)
    return jax_runs, ranks, cfg


@pytest.mark.parametrize("name", JAX_RUNS)
def test_engine_trajectory_matches_jax(name, engine_runs):
    """(b) losses within rtol 1e-4; parameters within 1e-5 on all but 0.1%
    of the elements and within 2·lr·steps on every one."""
    from deepspeed_tpu_torch.models.convert import jax_llama_to_state_dict
    jax_runs, ranks, cfg = engine_runs
    _, want_losses, jparams, _ = jax_runs[name]
    got = ranks[0][name]
    assert got["qgz"] == (name in ("qgz", "loco"))
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4)
    want = jax_llama_to_state_dict({"params": jparams}, cfg)
    diff = np.concatenate([np.abs(got["params"][k] - want[k].numpy()).ravel() for k in want])
    beyond = int((diff > 1e-5).sum())
    print(f"{name}: {beyond} of {diff.size} parameter elements differ from JAX by more than 1e-5 "
          f"(max {diff.max():.3g})")
    assert beyond <= 1e-3 * diff.size
    assert diff.max() <= 2 * LR * STEPS


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_stay_bit_identical(name, engine_runs):
    """(c) the replicated state does not fork: identical losses and
    parameters on both ranks."""
    _, ranks, _ = engine_runs
    a, b = ranks[0][name], ranks[1][name]
    assert a["losses"] == b["losses"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)


def test_qgz_and_loco_track_the_fp32_wire(engine_runs):
    """(d) the bound of ``test_onebit_transport.py:104``; LoCo's error state
    is live."""
    _, ranks, _ = engine_runs
    base = ranks[0]["fp32_wire"]["losses"]
    for name in ("qgz", "loco"):
        np.testing.assert_allclose(ranks[0][name]["losses"], base, rtol=5e-2, atol=5e-2)
    assert ranks[0]["loco"]["loco_error_abs_max"] > 0
    assert ranks[0]["qgz"]["loco_error_abs_max"] is None


def test_comms_logger_counts_the_jax_formula(engine_runs):
    """(e) per step: 2·(padded + 4·padded/256) bytes per tensor, the padding
    to world·256 included (JAX ``engine.py:1016-1026``); every step but the
    first (which loads the kernels) is recorded, once: the collectives inside
    the step (the wire's all-to-alls and all-gathers, the loss and norm
    reductions, the float32 wire) record nothing, as in the JAX engine's
    jitted step.  The whole record, names, sizes and counts, equals the JAX
    engine's."""
    jax_runs, ranks, cfg = engine_runs
    unit = WORLD * 256
    shapes = [v.shape for v in ranks[0]["qgz"]["params"].values()]
    want = sum(2 * (p + 4 * (p // 256)) for p in (-(-int(np.prod(s)) // unit) * unit for s in shapes))
    for name in ("qgz", "loco"):
        for rank in ranks:
            assert rank[name]["wire_bytes"] == want
            assert rank[name]["comms"] == {"all_to_all_quant_reduce": {want: STEPS - 1}} == jax_runs[name][3]
    for name in ("fp32_wire", "fp32_wire_masked"):
        assert ranks[0][name]["comms"] == {} == jax_runs[name][3]


def test_unsupported_layouts_raise_or_fall_back(engine_runs):
    """(f) ZeRO stage 2 over two ranks trains partitioned
    (``runtime/zero``) and matches the float32-wire run: the same losses,
    the parameters within 1e-6 (the gradients reduce-scattered rather than
    all-reduced: a sum in another order); qgZ with gas 2 warns and keeps the
    float32 wire, step for step the same as the float32-wire run."""
    _, ranks, _ = engine_runs
    for rank in ranks:
        stage2, wire = rank["stage2"], rank["fp32_wire"]
        assert stage2["partitioned"] and not stage2["qgz"] and not stage2["warnings"]
        np.testing.assert_allclose(stage2["losses"], wire["losses"], rtol=1e-6)
        for k, v in stage2["params"].items():
            np.testing.assert_allclose(v, wire["params"][k], atol=1e-6, rtol=0)
    gas2 = ranks[0]["qgz_gas2"]
    assert not gas2["qgz"]
    assert sum("zero_quantized_gradients needs" in m for m in gas2["warnings"]) == 1
    assert gas2["losses"] == ranks[0]["fp32_wire_gas2"]["losses"]
    for k, v in gas2["params"].items():
        np.testing.assert_array_equal(v, ranks[0]["fp32_wire_gas2"]["params"][k])
    assert not ranks[0]["qgz"]["warnings"]


def test_qgz_step_takes_4_collectives(engine_runs):
    """(g) per qgZ step the grouped exchange's 2 all-to-alls (codes, scales)
    and 2 all-gathers, besides the loss and grad-norm all-reduces (444 per
    step for Llama-125M's 111 tensors on the per-tensor route); LoCo adds
    its per-tensor pmean of the new error."""
    _, ranks, _ = engine_runs
    wire = {"all_to_all_single": 2 * STEPS, "all_gather_into_tensor": 2 * STEPS}
    for rank in ranks:
        assert rank["qgz"]["collectives"] == {**wire, "all_reduce": 2 * STEPS}
        assert rank["loco"]["collectives"] == {**wire, "all_reduce": (2 + rank["loco"]["n_params"]) * STEPS}


def test_mesh_spec_takes_the_data_axis_only():
    """The data, expert and tensor axes resolve as JAX's (``expert`` and
    ``tensor`` take their sizes, ``data`` the rest); pipe and seq raise
    naming item 6."""
    from deepspeed_tpu_torch.comm.mesh import MeshSpec, process_world_size
    assert MeshSpec().resolve(2) == (1, 2, 1, 1, 1) and MeshSpec(data=4).resolve(4)[1] == 4
    assert process_world_size() == 1
    assert MeshSpec(tensor=2).resolve(2) == (1, 1, 1, 1, 2) and MeshSpec(tensor=2).resolve(6)[1] == 3
    for spec in (MeshSpec(pipe=2), MeshSpec(seq=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6"):
            spec.resolve(2)
    assert MeshSpec(expert=2).resolve(2) == (1, 1, 2, 1, 1)
    assert MeshSpec(expert=2).resolve(4)[1:3] == (2, 2) and MeshSpec(data=2, expert=2).resolve(4)[1:3] == (2, 2)
    with pytest.raises(ValueError, match="does not cover"):
        MeshSpec(data=2).resolve(4)
    with pytest.raises(ValueError, match="not divisible"):
        MeshSpec(expert=3).resolve(4)


def test_nccl_takes_one_card_per_rank(monkeypatch):
    """NCCL with more ranks on a host than cards raises before any
    rendezvous; without a card it raises too; so does a mesh with an axis
    other than data."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm.mesh import MeshSpec
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="one card per rank"):
        comm.init_distributed(dist_backend="nccl", rank=0, world_size=2, init_method="tcp://127.0.0.1:1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        comm.init_distributed(dist_backend="nccl", rank=0, world_size=1, init_method="tcp://127.0.0.1:1")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6"):
        comm.init_distributed(dist_backend="gloo", rank=0, world_size=2, mesh_spec=MeshSpec(data=1, pipe=2))
    assert not comm.is_initialized()
