"""Host-staged KV migration in the port (``BlockedKVCache.export_pages`` /
``import_pages`` on the per-layer arena, ``serving/kvtransfer``) against the
JAX package, scenario by scenario.

The scenarios of ``tests/unit/inference/test_kv_migration.py:84-290`` run
over both engines on the same weights (``tests/torch_serving_backends.py``):
the export/import roundtrip and its validation, the snapshot's crc and
completeness, the abort when the source changes mid-export, import
rejections that leak no page, a byte-identical resume on a second engine,
the serving frontend's migration roundtrip, the recompute fallback on a torn
chunk, a paused sequence's stable pages, and the migration windows.  Each
run makes the JAX test's assertions; tokens, states, stats and page
accounting must be equal across the two.

The staged blocks themselves: the port's export of a sequence has the JAX
block's shape ``[L, n, page, 2, n_kv, hd]`` and dtype name, and its float32
values agree within ``BLOCK_RTOL``/``BLOCK_ATOL``.  They are K/V that two
implementations computed in float32 (matmuls summed in different orders,
RoPE in different op sequences): each value is a sum of 64 products of O(1)
terms, whose rounding is bounded by about 64·2^-24 ≈ 4e-6 of the terms'
scale, and layer 2 carries layer 1's differences, so 1e-5 absolute (plus
1e-5 relative) is the scale of the expected difference, not of an error in
the staging; the greedy tokens stay exact.  A bfloat16 arena stages its bits as
``uint16`` under the name ``"bfloat16"`` and round-trips exactly.
"""

import numpy as np
import pytest
import torch
from torch_serving_backends import PAGE, assert_clean, make_backends, serve_view

#: float32 K/V of two implementations: |port - jax| <= ATOL + RTOL·|jax|
BLOCK_RTOL, BLOCK_ATOL = 1e-5, 1e-5
PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8], [1, 2, 3, 4, 5, 6, 7, 8, 9], [11, 4, 4]]
ENGINE = dict(max_pages_per_seq=16)


@pytest.fixture(scope="module")
def backends():
    return make_backends(max_pos=256)


def _arena_name(be, eng):
    if be.name == "jax":
        return str(eng.cache.dtype)
    from deepspeed_tpu_torch.inference.v2.ragged import arena_dtype_name
    return arena_dtype_name(eng.cache)


def _arena_pages(be, arena, pages):
    """The arena's ``pages`` as a host block, read without ``export_pages``."""
    if be.name == "jax":
        return np.asarray(arena[:, pages])
    return np.stack([layer[pages].numpy() for layer in arena])


def _export_all(exporter):
    while not exporter.step_chunk():
        pass
    return exporter.snapshot


def _run_until(serve, pred, max_ticks=200):
    for _ in range(max_ticks):
        if pred():
            return
        serve.tick()
    raise AssertionError("condition never reached")


def _steps(be, prompt, max_new, steps):
    eng = be.engine(**ENGINE)
    eng.put([0], [prompt], max_new_tokens=max_new)
    for _ in range(steps):
        eng.step()
    return eng


def _roundtrip_and_validation(be):
    eng = be.engine(**ENGINE)
    eng.put([0], [PROMPTS[2]])
    for _ in range(4):
        eng.step()
    pages = list(eng.state.seqs[0].pages[:2])
    block = eng.kv.export_pages(eng.cache, pages)
    assert block.shape[1] == 2 and str(block.dtype) == _arena_name(be, eng) == "float32"
    arena2 = eng.kv.import_pages(eng.cache, pages, block)   # the same slots: a no-op
    np.testing.assert_array_equal(_arena_pages(be, arena2, pages), block)
    errors = []
    for call, match in ((lambda: eng.kv.export_pages(eng.cache, [0]), "out of range"),
                        (lambda: eng.kv.export_pages(eng.cache, [eng.kv.num_pages]), "out of range"),
                        (lambda: eng.kv.import_pages(eng.cache, pages, block[:, :1]), "block shape"),
                        (lambda: eng.kv.import_pages(eng.cache, pages, block.astype(np.float16)), "dtype")):
        with pytest.raises(ValueError, match=match):
            call()
        errors.append(match)
    return {"shape": block.shape, "pages": pages, "errors": errors, "block": block}


def _crc_and_completeness(be):
    eng = _steps(be, PROMPTS[2], 6, 6)
    eng.state.seqs[0].paused = True
    exporter = be.kvtransfer.KVExporter(eng, 0, chunk_pages=1)
    exporter.step_chunk()
    with pytest.raises(be.kvtransfer.SnapshotIntegrityError, match="incomplete"):
        exporter.snapshot.verify()
    snap = _export_all(exporter)
    snap.verify()
    crcs = list(snap.crcs)
    snap.chunks[0] = snap.chunks[0].copy()
    snap.chunks[0].flat[3] += 1.0
    with pytest.raises(be.kvtransfer.SnapshotIntegrityError, match="crc mismatch"):
        snap.verify()
    return {"n_chunks": len(snap.chunks), "block_shape": tuple(snap.block_shape), "dtype": snap.dtype,
            "n_pages": snap.n_pages, "seen": snap.seen_tokens, "tokens": snap.tokens, "n_crcs": len(crcs)}


def _exporter_aborts(be):
    eng = _steps(be, PROMPTS[2], 6, 6)
    eng.state.seqs[0].paused = True
    exporter = be.kvtransfer.KVExporter(eng, 0, chunk_pages=1)
    exporter.step_chunk()
    eng.flush(0)
    with pytest.raises(be.kvtransfer.SnapshotAborted):
        exporter.step_chunk()
    return {"staged": exporter.snapshot.n_pages}


def _import_rejections_leak_nothing(be):
    kvt = be.kvtransfer
    src = _steps(be, PROMPTS[2], 6, 6)
    seq = src.state.seqs[0]
    seq.paused = True
    snap = _export_all(kvt.KVExporter(src, 0, chunk_pages=2))
    dst = be.engine(**ENGINE)
    free_before = dst.kv.allocator.free_pages
    with pytest.raises(kvt.KVImportError, match="token history mismatch"):
        kvt.import_snapshot(dst, 1, seq.tokens + [7], snap, max_new_tokens=4)
    bad = type(snap)(tokens=list(seq.tokens), seen_tokens=snap.seen_tokens, page_size=PAGE * 2,
                     block_shape=snap.block_shape, dtype=snap.dtype, chunks=snap.chunks, crcs=snap.crcs,
                     complete=True)
    with pytest.raises(kvt.KVImportError, match="page_size mismatch"):
        kvt.import_snapshot(dst, 1, seq.tokens, bad, max_new_tokens=4)
    wrong_dtype = type(snap)(tokens=list(seq.tokens), seen_tokens=snap.seen_tokens, page_size=PAGE,
                             block_shape=snap.block_shape, dtype="bfloat16", chunks=snap.chunks, crcs=snap.crcs,
                             complete=True)
    with pytest.raises(kvt.KVImportError, match="dtype mismatch"):
        kvt.import_snapshot(dst, 1, seq.tokens, wrong_dtype, max_new_tokens=4)
    dst.put([9], [PROMPTS[0]])
    with pytest.raises(kvt.KVImportError, match="already live"):
        kvt.import_snapshot(dst, 9, seq.tokens, snap, max_new_tokens=4)
    dst.flush(9)
    assert dst.kv.allocator.free_pages == free_before
    tiny = be.engine(num_pages=2, **ENGINE)
    with pytest.raises(kvt.KVImportError, match="short"):
        kvt.import_snapshot(tiny, 1, seq.tokens, snap, max_new_tokens=4)
    assert tiny.kv.allocator.free_pages == tiny.kv.num_pages - 1
    return {"free": dst.kv.allocator.free_pages, "snapshot": (snap.n_pages, snap.seen_tokens, snap.dtype)}


def _resume_byte_identical(be):
    max_new = 10
    golden = be.generate([PROMPTS[2]], max_new, **ENGINE)[0]
    src = be.engine(**ENGINE)
    src.put([0], [PROMPTS[2]], max_new_tokens=max_new)
    while len(src.state.seqs[0].generated) < 4:
        src.step()
    seq = src.state.seqs[0]
    head = list(seq.generated)
    seq.paused = True
    snap = _export_all(be.kvtransfer.KVExporter(src, 0, chunk_pages=2))
    dst = be.engine(**ENGINE)
    be.kvtransfer.import_snapshot(dst, 7, seq.tokens, snap, max_new_tokens=max_new - len(head))
    out = []
    while 7 in dst.state.seqs and not dst.state.seqs[7].done:
        out.extend(dst.step().get(7, []))
    assert head + out == golden
    return {"head": head, "out": out, "pages": snap.n_pages}


def _serving_migration_roundtrip(be):
    max_new = 8
    golden = be.generate([PROMPTS[2]], max_new, **ENGINE)[0]
    a, _ = be.serve(**ENGINE)
    b, _ = be.serve(**ENGINE)
    req = a.submit(PROMPTS[2], max_new_tokens=max_new)
    _run_until(a, lambda: req.state is be.RequestState.DECODE)
    exporter = a.begin_migration(req.uid, chunk_pages=2)
    assert exporter is not None and req.state is be.RequestState.MIGRATING
    snap = _export_all(exporter)
    closed = a.complete_migration(req.uid)
    assert closed.state is be.RequestState.MIGRATED and a.stats.migrated == 1
    view_a = serve_view(a, [req])
    assert_clean(a.engine)
    req2 = b.submit(PROMPTS[2], max_new_tokens=max_new, resume_tokens=list(req.tokens), kv_snapshot=snap)
    b.drain()
    assert req2.state is be.RequestState.DONE and req2.tokens == golden
    assert b.stats.kv_imports == 1 and b.stats.kv_import_fallbacks == 0
    return {"a": view_a, "b": serve_view(b, [req2])}


def _torn_chunk_falls_back(be):
    max_new = 8
    golden = be.generate([PROMPTS[2]], max_new, **ENGINE)[0]
    a, _ = be.serve(**ENGINE)
    b, _ = be.serve(**ENGINE)
    req = a.submit(PROMPTS[2], max_new_tokens=max_new)
    _run_until(a, lambda: req.state is be.RequestState.DECODE)
    snap = _export_all(a.begin_migration(req.uid, chunk_pages=2))
    a.complete_migration(req.uid)
    snap.chunks[0] = snap.chunks[0].copy()
    snap.chunks[0].flat[0] += 1.0
    req2 = b.submit(PROMPTS[2], max_new_tokens=max_new, resume_tokens=list(req.tokens), kv_snapshot=snap)
    b.drain()
    assert req2.state is be.RequestState.DONE and req2.tokens == golden
    assert b.stats.kv_imports == 0 and b.stats.kv_import_fallbacks == 1
    view = serve_view(b, [req2])
    assert not b._active and not b._queue
    assert_clean(b.engine)
    return view


def _paused_pages_stay_stable(be):
    a, _ = be.serve(**ENGINE)
    victim = a.submit(PROMPTS[2], max_new_tokens=12)
    _run_until(a, lambda: victim.state is be.RequestState.DECODE)
    exporter = a.begin_migration(victim.uid, chunk_pages=1)
    at_pause = list(victim.tokens)
    first = exporter.step_chunk()
    ref = a.engine.kv.export_pages(a.engine.cache, exporter._pages)
    others = [a.submit(p, max_new_tokens=6) for p in (PROMPTS[0], PROMPTS[1])]
    for _ in range(30):
        a.tick()
    assert all(o.state is be.RequestState.DONE for o in others)
    assert victim.tokens == at_pause
    np.testing.assert_array_equal(a.engine.kv.export_pages(a.engine.cache, exporter._pages), ref)
    assert not first or exporter.snapshot.complete
    a.abort_migration(victim.uid)
    assert victim.state is be.RequestState.DECODE
    a.drain()
    assert victim.tokens == be.generate([PROMPTS[2]], 12, **ENGINE)[0]
    return serve_view(a, [victim] + others)


def _migration_windows(be):
    a, _ = be.serve(prefill_chunk=8, **ENGINE)
    assert a.begin_migration(999) is None
    long_prompt = [int(x) for x in np.random.default_rng(3).integers(1, 100, 40)]
    req = a.submit(long_prompt, max_new_tokens=6)
    a.tick()
    seq = a.engine.state.seqs[req.uid]
    assert req.state is be.RequestState.PREFILL and seq.remaining_prefill > 8
    assert a.begin_migration(req.uid) is None and not seq.paused
    while seq.remaining_prefill > 8:
        a.tick()
    if req.state is be.RequestState.PREFILL:
        exporter = a.begin_migration(req.uid, chunk_pages=8)
        assert exporter is not None and req.state is be.RequestState.MIGRATING
        a.abort_migration(req.uid)
        assert req.state is be.RequestState.PREFILL
    a.drain()
    assert req.tokens == be.generate([long_prompt], 6, **ENGINE)[0]
    return serve_view(a, [req])


SCENARIOS = {
    "crc_and_completeness": _crc_and_completeness,
    "exporter_aborts_on_source_change": _exporter_aborts,
    "import_rejections_leak_nothing": _import_rejections_leak_nothing,
    "resume_byte_identical": _resume_byte_identical,
    "serving_migration_roundtrip": _serving_migration_roundtrip,
    "torn_chunk_falls_back": _torn_chunk_falls_back,
    "paused_pages_stay_stable": _paused_pages_stay_stable,
    "migration_windows": _migration_windows,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_migration_scenario_matches_jax(backends, name):
    want = SCENARIOS[name](backends["jax"])
    got = SCENARIOS[name](backends["port"])
    assert got == want


def test_export_import_roundtrip_and_staged_block_match_jax(backends):
    """The roundtrip and its validation on both engines; the port's staged
    block has the JAX block's shape and dtype, and its values within the
    tolerance of two float32 implementations (module docstring)."""
    want = _roundtrip_and_validation(backends["jax"])
    got = _roundtrip_and_validation(backends["port"])
    jblock, tblock = want.pop("block"), got.pop("block")
    assert got == want
    assert tblock.shape == jblock.shape and tblock.dtype == jblock.dtype
    np.testing.assert_allclose(tblock, jblock, rtol=BLOCK_RTOL, atol=BLOCK_ATOL)
    assert np.abs(tblock).max() > 0.1     # real K/V, not an empty page


def test_snapshot_blocks_match_jax(backends):
    """A whole sequence's snapshot (3 pages in chunks of up to 2): geometry,
    dtype name and token history equal, every chunk within the tolerance."""
    snaps = {}
    for name, be in backends.items():
        eng = _steps(be, PROMPTS[2] + PROMPTS[0] + PROMPTS[3], 12, 10)
        eng.state.seqs[0].paused = True
        snaps[name] = _export_all(be.kvtransfer.KVExporter(eng, 0, chunk_pages=2))
    j, t = snaps["jax"], snaps["port"]
    assert (t.block_shape, t.dtype, t.tokens, t.seen_tokens, t.n_pages, t.n_bytes) == \
        (j.block_shape, j.dtype, j.tokens, j.seen_tokens, j.n_pages, j.n_bytes)
    assert t.n_pages == 3 and len(t.chunks) == len(j.chunks) == 2
    for tc, jc in zip(t.chunks, j.chunks):
        np.testing.assert_allclose(tc, jc, rtol=BLOCK_RTOL, atol=BLOCK_ATOL)


def _bf16_export(be):
    """A bfloat16 arena's staged pages and its snapshot, after 4 steps."""
    import jax.numpy as jnp
    eng = be.engine(kv_dtype=jnp.bfloat16 if be.name == "jax" else torch.bfloat16, **ENGINE)
    eng.put([0], [PROMPTS[2] + PROMPTS[0]], max_new_tokens=6)
    for _ in range(4):
        eng.step()
    seq = eng.state.seqs[0]
    block = eng.kv.export_pages(eng.cache, list(seq.pages))
    seq.paused = True
    return eng, block, _export_all(be.kvtransfer.KVExporter(eng, 0, chunk_pages=8))


def _bf16_bits_as_float32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def test_bfloat16_arena_stages_uint16_bits(backends):
    """A bfloat16 arena's block is its bits as ``uint16`` (numpy has no
    bfloat16), named ``"bfloat16"`` in its snapshot as the JAX package names
    it, with the JAX block's geometry; it round-trips exactly (exported,
    imported into other pages, exported again: equal bit for bit), and a
    float32 block is refused.  Against JAX's block the values agree within
    one bfloat16 ulp (2^-8 relative): both round float32 K/V that differ by
    a few float32 ulps, which can move a value across a rounding boundary."""
    eng, block, snap = _bf16_export(backends["port"])
    _, jblock, jsnap = _bf16_export(backends["jax"])
    assert block.dtype == np.uint16 and snap.chunks[0].dtype == np.uint16
    assert snap.dtype == jsnap.dtype == "bfloat16" and str(jblock.dtype) == "bfloat16"
    assert (snap.block_shape, snap.n_pages, snap.tokens) == (jsnap.block_shape, jsnap.n_pages, jsnap.tokens)
    assert block.shape == jblock.shape and block.nbytes == jblock.nbytes
    pages = list(eng.state.seqs[0].pages)
    want = np.stack([layer[pages].view(torch.int16).numpy() for layer in eng.cache]).view(np.uint16)
    np.testing.assert_array_equal(block, want)
    assert np.count_nonzero(block)
    np.testing.assert_allclose(_bf16_bits_as_float32(block), jblock.astype(np.float32), rtol=2.0**-8, atol=1e-5)
    others = eng.kv.allocator.allocate(len(pages))
    eng.kv.import_pages(eng.cache, others, block)
    np.testing.assert_array_equal(eng.kv.export_pages(eng.cache, others), block)
    with pytest.raises(ValueError, match="dtype"):
        eng.kv.import_pages(eng.cache, others, block.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_staging_on_the_card(dtype):
    """``export_pages``/``import_pages`` on a CUDA arena (the K3 serving
    layout, ``[P, page, 2, n_kv, hd]`` per layer): the staged block is the
    pages' bytes in the reference layout, and an import writes exactly
    those bytes into other pages, leaving every other page untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from deepspeed_tpu_torch.inference.v2.ragged import BlockedKVCache
    gen = torch.Generator(device="cuda").manual_seed(0)
    arena = [torch.randn((16, PAGE, 2, 8, 128), generator=gen, device="cuda").to(dtype) for _ in range(3)]
    before = [a.clone() for a in arena]
    kv = BlockedKVCache(16, PAGE, 8)
    src, dst = [3, 1, 7], [2, 5, 9]
    block = kv.export_pages(arena, src)
    assert block.shape == (3, 3, PAGE, 2, 8, 128)
    host = [a[src].cpu() for a in before]
    if dtype == torch.bfloat16:
        assert block.dtype == np.uint16
        want = np.stack([h.view(torch.int16).numpy() for h in host]).view(np.uint16)
    else:
        want = np.stack([h.numpy() for h in host])
    np.testing.assert_array_equal(block, want)
    kv.import_pages(arena, dst, block)
    torch.cuda.synchronize()
    for a, b in zip(arena, before):
        assert torch.equal(a[dst], b[src])
        keep = [p for p in range(16) if p not in dst]
        assert torch.equal(a[keep], b[keep])
