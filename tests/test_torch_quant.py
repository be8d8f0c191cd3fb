"""The port's block quantization (``deepspeed_tpu_torch/ops/quantizer.py``,
the plain versions of K4a/K4b/K5a/K5b, and the dispatch and checks of
``ops/quant_kernels.py``) against the JAX package's
``deepspeed_tpu.ops.quantizer`` and its Pallas kernels in interpret mode,
on the CPU.  Against the jnp functions evaluated op by op, codes, scales and
dequantized values are bit-identical: both sides divide in float32, round
half to even and multiply once.  XLA's compiled programs (the Pallas
kernels in interpret mode among them) turn the divide by the constant qmax
into a product with ``fl(1/qmax)``; the interpret-mode test pins that
difference down instead of loosening the comparison."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import quant_kernels as jqk
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu_torch.ops import quant_kernels as tqk
from deepspeed_tpu_torch.ops import quantizer as tq


def _values(block: int, qmax: float, seed: int) -> np.ndarray:
    """24 blocks: random normals at scales from 1e-6 to 1e3 per block, an
    all-zero block, a block whose scale is exactly 1 holding x/scale ties
    at ±k.5 (round half to even must pick the even code), a block of one
    nonzero value, and a block with ties at a scale that is not a power of
    two."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(24, block)) * (10.0**rng.uniform(-6, 3, size=(24, 1)))
    x[3] = 0.0
    ties = np.resize(np.arange(qmax) + 0.5, block) * np.resize([1.0, -1.0], block)
    ties[0] = qmax                                                 # absmax = qmax: scale exactly 1
    x[5] = ties
    x[7] = 0.0
    x[7, block // 3] = -2.5
    x[11] = ties * 0.75                                            # scale 0.75: ties of x/scale again
    return x.reshape(-1).astype(np.float32)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor: float32, or
    bfloat16 rounded from float32 on both sides (round to nearest even)."""
    if dtype == "f32":
        return jnp.asarray(x), torch.from_numpy(x.copy())
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x.copy()).to(torch.bfloat16)


CODECS = {8: (jq.quantize_int8, jq.dequantize_int8, tq.quantize_int8, tq.dequantize_int8, 127.0),
          4: (jq.quantize_int4, jq.dequantize_int4, tq.quantize_int4, tq.dequantize_int4, 7.0)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("block", [64, 256, 1024])
@pytest.mark.parametrize("bits", [8, 4])
def test_codec_is_bit_identical_to_jax(bits, block, dtype):
    jquant, jdequant, tquant, tdequant, qmax = CODECS[bits]
    x = _values(block, qmax, seed=block + bits)
    jx, tx = _pair(x, dtype)
    jcodes, jscale = jquant(jx, block)
    tcodes, tscale = tquant(tx, block)
    assert tcodes.dtype == (torch.int8 if bits == 8 else torch.uint8) and tscale.dtype == torch.float32
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(tdequant(tcodes, tscale, tx.shape).numpy(),
                                  np.asarray(jdequant(jcodes, jscale, jx.shape)))
    np.testing.assert_array_equal(tq.quantization_error(tx.float(), bits, block).numpy(),
                                  np.asarray(jq.quantization_error(jx.astype(jnp.float32), bits, block)))
    # the properties the ties and the zero block are there for
    scale = tscale.numpy()
    assert scale[3] == 1.0 and scale[5] == 1.0
    codes = tcodes.numpy().astype(np.int32)
    if bits == 4:
        codes = np.concatenate([codes & 0xF, codes >> 4], axis=1) - 8       # the halves layout
    assert not codes[3].any()
    tie = np.round(x.reshape(24, block)[5]).astype(np.int32)                # numpy rounds half to even
    np.testing.assert_array_equal(codes[5], np.clip(tie, -qmax, qmax))
    assert codes[7, block // 3] == -qmax and np.count_nonzero(codes[7]) == 1


def test_codec_against_the_pallas_kernels_in_interpret_mode():
    """K4a/K4b/K5a/K5b as the JAX package's Pallas kernels compute them
    (interpret mode, compiled by XLA on the CPU) at nb = 256 blocks of 256,
    the tiling the Pallas wrappers take.  XLA computes the scale as
    ``absmax · fl(1/qmax)``, the port as ``absmax / qmax``: the two agree
    or differ by one ulp; codes agree wherever the scales do and differ by
    at most one step elsewhere; the dequantize kernels, given the same
    codes and scales, agree bit for bit."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(256, 256)) * 10.0**rng.uniform(-6, 3, size=(256, 1))).astype(np.float32)
    x[:24] = _values(256, 127.0, seed=3).reshape(24, 256)
    x = x.reshape(-1)
    absmax = np.abs(x.reshape(256, 256)).max(-1)
    jx, tx = jnp.asarray(x), torch.from_numpy(x.copy())
    for bits, qmax in ((8, 127.0), (4, 7.0)):
        jquant, jdequant = ((jqk.quantize_int8_pallas, jqk.dequantize_int8_pallas) if bits == 8 else
                            (jqk.quantize_int4_pallas, jqk.dequantize_int4_pallas))
        _, _, tquant, tdequant, _ = CODECS[bits]
        jcodes, jscale = (np.asarray(a) for a in jquant(jx, 256, interpret=True))
        tcodes, tscale = (t.numpy() for t in tquant(tx, 256))
        live = absmax > 0
        np.testing.assert_array_equal(jscale[live], absmax[live] * np.float32(1.0 / qmax))
        np.testing.assert_array_equal(tscale[live], absmax[live] / np.float32(qmax))
        assert np.all(np.abs(jscale.view(np.int32) - tscale.view(np.int32)) <= 1)
        same = jscale == tscale
        np.testing.assert_array_equal(tcodes[same], jcodes[same])
        if bits == 8:
            assert np.abs(tcodes.astype(np.int32) - jcodes).max() <= 1
        else:
            for shift in (0, 4):
                nib = lambda c: (c.astype(np.int32) >> shift) & 0xF  # noqa: E731
                assert np.abs(nib(tcodes) - nib(jcodes)).max() <= 1
        print(f"int{bits}: the compiled Pallas scale differs from absmax / {qmax:g} in {int((~same).sum())} of 256 "
              f"blocks")
        want = np.asarray(jdequant(jnp.asarray(tcodes), jnp.asarray(tscale), (x.size, ), interpret=True))
        np.testing.assert_array_equal(tdequant(torch.from_numpy(tcodes), torch.from_numpy(tscale), (x.size, )).numpy(),
                                      want)
    print(f"interpret-mode comparison took {time.perf_counter() - t0:.2f} s")


def test_dispatch_runs_the_plain_versions_on_cpu_tensors():
    x = torch.from_numpy(_values(256, 127.0, seed=4))
    counts = [f.launches for f in (tqk.quantize_int8_cuda, tqk.dequantize_int8_cuda, tqk.quantize_int4_cuda,
                                   tqk.dequantize_int4_cuda)]
    for quant, dequant, plain in ((tqk.quantize_int8, tqk.dequantize_int8, tq.quantize_int8),
                                  (tqk.quantize_int4, tqk.dequantize_int4, tq.quantize_int4)):
        q, s = quant(x, 256)
        want_q, want_s = plain(x, 256)
        assert torch.equal(q, want_q) and torch.equal(s, want_s)
        assert dequant(q, s, (2, -1)).shape == (2, x.numel() // 2)
    assert counts == [f.launches for f in (tqk.quantize_int8_cuda, tqk.dequantize_int8_cuda,
                                           tqk.quantize_int4_cuda, tqk.dequantize_int4_cuda)]


def test_wrappers_raise_on_what_they_do_not_take():
    x = torch.zeros(1024)
    with pytest.raises(ValueError, match="not divisible"):
        tqk.quantize_int8(x, 300)
    with pytest.raises(ValueError, match="even"):
        tqk.quantize_int4(x, 255)
    with pytest.raises(ValueError, match="unsupported device"):
        tqk.quantize_int8(torch.zeros(1024, device="meta"), 256)
    # the kernel wrappers check the block, the size, the dtype and the
    # layout, and take nothing but a CUDA tensor: no fallback to the plain
    # version
    with pytest.raises(ValueError, match="block 2048"):
        tqk.quantize_int8_cuda(torch.zeros(4096), 2048)
    with pytest.raises(ValueError, match="even"):
        tqk.quantize_int4_cuda(x, 255)
    with pytest.raises(ValueError, match="multiple of block"):
        tqk.quantize_int8_cuda(torch.zeros(1000), 256)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tqk.quantize_int8_cuda(torch.zeros(1024, dtype=torch.float16), 256)
    with pytest.raises(ValueError, match="contiguous"):
        tqk.quantize_int8_cuda(torch.zeros(64, 32).t(), 256)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        tqk.quantize_int8_cuda(x, 256)
    q, s = tq.quantize_int8(x, 256)
    with pytest.raises(ValueError, match="does not hold"):
        tqk.dequantize_int8_cuda(q, s, (1000, ))
    with pytest.raises(ValueError, match="codes and float32 scales"):
        tqk.dequantize_int4_cuda(q, s, (1024, ))
    with pytest.raises(ValueError, match="CUDA device"):
        tqk.dequantize_int8_cuda(q, s, (1024, ))


# ------------------------------------------------------------ the grouped codec

#: one step's tensors: sizes that are and are not multiples of 256, the
#: all-zero tensor (index 4) and the int8 tie block (index 5)
GROUPED_NUMELS = (768, 1000, 4096, 65536, 300, 256)


def _grouped_values(dtype: str) -> torch.Tensor:
    rng = np.random.default_rng(17)
    parts = [(rng.normal(size=n) * 10.0**rng.uniform(-6, 3)).astype(np.float32) for n in GROUPED_NUMELS[:4]]
    parts += [np.zeros(GROUPED_NUMELS[4], np.float32), _values(256, 127.0, seed=5).reshape(24, 256)[5]]
    return _pair(np.concatenate(parts), dtype)[1]


def _padded(x: torch.Tensor, unit: int) -> torch.Tensor:
    return torch.cat([x.float(), torch.zeros((-x.numel()) % unit)])


def test_segment_table_layout():
    table = tqk.SegmentTable([768, 1000, 4096], world=2)
    assert table.offsets == (0, 768, 1768) and table.total == 5864
    assert table.chunk_rows == (2, 2, 8) and table.chunk_offsets == (0, 2, 4)
    assert (table.chunk, table.rows) == (12, 24)
    records, row_segments = table.device_tables("cpu")
    np.testing.assert_array_equal(records.numpy(), [[768, 0, 2, 0], [1000, 768, 2, 2], [4096, 1768, 8, 4]])
    np.testing.assert_array_equal(row_segments.numpy(), [0, 0, 1, 1] + [2] * 8)
    assert table.device_tables(torch.device("cpu"))[0] is records   # copied once
    for bad in (dict(numels=[]), dict(numels=[5, 0]), dict(numels=[5], world=0), dict(numels=[5], block=2048)):
        with pytest.raises(ValueError):
            tqk.SegmentTable(**{"world": 2, **bad})


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grouped_codec_matches_the_per_tensor_codec(dtype, world):
    """The plain grouped K4a/K4b (what the CUDA kernels compute) against the
    per-tensor codec of ``padded_quant_allreduce``: each tensor padded apart
    to world·256.  Codes and scales equal, mapped back from the rank-major
    layout; the received copies (a) dequantized in the identity layout; the
    gathered tensors (b) and LoCo's ``local_deq`` (c) in tensor order, cut
    and rounded through the input's dtype, equal."""
    x = _grouped_values(dtype)
    table = tqk.SegmentTable(GROUPED_NUMELS, world)
    q, s = tqk.quantize_int8(x, 256, table)
    assert q.shape == (table.rows, 256) and s.shape == (table.rows, )
    qv, sv = q.view(world, table.chunk, 256), s.view(world, table.chunk)
    received = tqk.dequantize_int8(q, s, (world, table.chunk * 256)).view(world, table.chunk, 256)
    through = x.dtype if dtype == "bf16" else None
    gathered = tqk.dequantize_int8(q, s, (table.total, ), table, through)
    for n, first, c, off in table.segments():
        want_q, want_s = tq.quantize_int8(_padded(x[first:first + n], world * 256), 256)
        assert torch.equal(qv[:, off:off + c], want_q.view(world, c, 256))
        assert torch.equal(sv[:, off:off + c], want_s.view(world, c))
        deq = tq.dequantize_int8(want_q, want_s, (world * c * 256, ))
        assert torch.equal(received[:, off:off + c].reshape(-1), deq)
        want = deq[:n] if through is None else deq[:n].to(through).float()
        assert torch.equal(gathered[first:first + n], want)
    zero = slice(table.chunk_offsets[4], table.chunk_offsets[4] + table.chunk_rows[4])
    assert bool((sv[:, zero] == 1.0).all()) and not qv[:, zero].any()
    tie = qv[0, table.chunk_offsets[5]].int()
    np.testing.assert_array_equal(tie.numpy(), np.clip(np.round(x[-256:].float().numpy()), -127, 127))


def test_grouped_codec_dispatch_and_checks():
    """CPU tensors run the plain grouped versions (no launch is counted);
    the kernel wrappers take nothing but CUDA tensors, and both raise on a
    table that does not fit."""
    x = _grouped_values("f32")
    table = tqk.SegmentTable(GROUPED_NUMELS, 2)
    counts = [f.launches for f in (tqk.quantize_int8_cuda, tqk.dequantize_int8_cuda)]
    q, s = tqk.quantize_int8(x, 256, table)
    want_q, want_s = tq.quantize_int8_grouped(x, table)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert torch.equal(tqk.dequantize_int8(q, s, (table.total, ), table), tq.dequantize_int8_grouped(q, s, table))
    assert counts == [f.launches for f in (tqk.quantize_int8_cuda, tqk.dequantize_int8_cuda)]
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        tqk.quantize_int8_cuda(x, 256, table)
    with pytest.raises(ValueError, match="flat"):
        tqk.quantize_int8_cuda(x[:-1], 256, table)
    with pytest.raises(ValueError, match="differs from the table"):
        tqk.quantize_int8(x, 128, table)
    with pytest.raises(ValueError, match="not the table's"):
        tqk.dequantize_int8_cuda(q[:-1], s[:-1], (table.total, ), table)
    with pytest.raises(ValueError, match="does not hold"):
        tqk.dequantize_int8_cuda(q, s, (table.total + 1, ), table)
    with pytest.raises(ValueError, match="CUDA device"):
        tqk.dequantize_int8_cuda(q, s, (table.total, ), table)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tqk.dequantize_int8(q, s, (table.total, ), table, through=torch.float16)
    with pytest.raises(ValueError, match=f"the table {table.total}"):
        tq.quantize_int8_grouped(x[:-1], table)


def test_grouped_exchange_rejects_what_it_does_not_take():
    """The grouped exchange is int8, takes the tensors it was built for, and
    feeds LoCo float32; each check raises before any collective."""
    from deepspeed_tpu_torch.runtime.comm import GroupedQuantAllreduce
    xs = [torch.zeros(768), torch.zeros(4, 25)]
    with pytest.raises(ValueError, match="bits=8"):
        GroupedQuantAllreduce([x.shape for x in xs], bits=4)
    wire = GroupedQuantAllreduce([x.shape for x in xs], torch.bfloat16)
    assert wire.table.numels == (768, 100) and wire.table.block == 256 and wire.inputs.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="built for 2 tensors"):
        wire(xs[:1])
    with pytest.raises(ValueError, match="float32"):
        wire(xs, errors=[torch.zeros_like(x) for x in xs])
