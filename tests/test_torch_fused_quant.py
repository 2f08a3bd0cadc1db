"""K2 and K3 on the CPU: the port's ``quantize_chunk``/``dequantize_chunk``
(the kernels' plain versions) and the ``fused_quant``/``fused_dequant``
wrappers (which take the plain versions on CPU tensors) against the JAX
package, on the same numpy inputs.

Bitwise everywhere against the JAX functions run op by op (eagerly). The
JAX Pallas kernels run in interpret mode: their quantize and bare
dequantize are bitwise too; their dequantize-accumulate differs by at most
the product's one rounding (``eps * (|add_to| + |q * scale|)``), because
XLA:CPU contracts the interpreted kernel's ``add_to + q * scale`` into one
FMA (the JAX package compares jit with jit for that reason), while the
port, like the CUDA kernel built with ``-fmad=false``, rounds the product
and the sum apart. Blocks 1, 16 and 64 are not multiples of the TPU's 128
lanes, so the JAX package serves them through its reference.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models import NetResDeep as FlaxNetResDeep
from tpu_ddp.ops.fused_quant import fused_dequant as jax_fused_dequant
from tpu_ddp.ops.fused_quant import fused_quant as jax_fused_quant
from tpu_ddp.parallel import compression as jc
from tpu_ddp.train import create_train_state, make_optimizer
from tpu_ddp_torch import ops
from tpu_ddp_torch.models import NetResDeep
from tpu_ddp_torch.ops.fused_quant import fused_dequant, fused_quant
from tpu_ddp_torch.parallel import compression as tc

BLOCKS_TAILS = [(128, 0), (128, 37), (256, 0), (256, 37),
                (1, 0), (16, 5), (64, 0), (64, 37)]


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


def _inputs(block, tail, seed=0):
    size = block * 3 + tail
    rng = np.random.default_rng(seed + block + tail)
    x = (rng.standard_normal(size) * 3.0).astype(np.float32)
    x[size // 2] = 0.0
    acc = rng.standard_normal(size).astype(np.float32)
    return size, x, acc


@pytest.mark.parametrize("block,tail", BLOCKS_TAILS)
def test_plain_versions_bitwise_equal_jax(block, tail):
    size, x, acc = _inputs(block, tail)
    want = jc.quantize_chunk(jnp.asarray(x), "int8", block)
    got = tc.quantize_chunk(torch.from_numpy(x), "int8", block)
    assert got["q"].dtype == torch.int8
    assert np.array_equal(got["q"].numpy(), np.asarray(want["q"]))
    assert np.array_equal(_bits(got["scale"].numpy()), _bits(want["scale"]))
    d_want = jc.dequantize_chunk(want, "int8", block, size)
    d_got = tc.dequantize_chunk(got, "int8", block, size)
    assert np.array_equal(_bits(d_got.numpy()), _bits(d_want))
    a_want = jnp.asarray(acc) + d_want
    a_got = torch.from_numpy(acc) + d_got
    assert np.array_equal(_bits(a_got.numpy()), _bits(a_want))


@pytest.mark.parametrize("block,tail", BLOCKS_TAILS)
def test_cpu_wrappers_match_jax_fused(block, tail):
    size, x, acc = _inputs(block, tail, seed=1)
    before = dict(ops.LAUNCHES)
    got = fused_quant(torch.from_numpy(x), block)
    want = jax_fused_quant(jnp.asarray(x), block, interpret=True)
    assert np.array_equal(got["q"].numpy(), np.asarray(want["q"]))
    assert np.array_equal(_bits(got["scale"].numpy()), _bits(want["scale"]))
    d_got = fused_dequant(got, block, size)
    d_want = jax_fused_dequant(want, block, size, interpret=True)
    assert np.array_equal(_bits(d_got.numpy()), _bits(d_want))
    a_got = fused_dequant(got, block, size, add_to=torch.from_numpy(acc))
    a_want = jax_fused_dequant(want, block, size, add_to=jnp.asarray(acc),
                               interpret=True)
    one_rounding = np.finfo(np.float32).eps * (np.abs(acc) + np.abs(d_got.numpy()))
    assert (np.abs(a_got.numpy() - np.asarray(a_want)) <= one_rounding).all()
    # bitwise against the JAX reference run op by op (two roundings)
    a_ref = jnp.asarray(acc) + jc.dequantize_chunk(want, "int8", block, size)
    assert np.array_equal(_bits(a_got.numpy()), _bits(a_ref))
    # CPU tensors take the plain versions: no kernel launched
    assert dict(ops.LAUNCHES) == before


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_cast_payloads_bitwise_equal_jax(mode):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(1000) * 100).astype(np.float32)
    want = jc.quantize_chunk(jnp.asarray(x), mode, 256)
    got = tc.quantize_chunk(torch.from_numpy(x), mode, 256)
    assert (np.asarray(want["q"]).view(np.uint8).tobytes()
            == got["q"].contiguous().view(torch.uint8).numpy().tobytes())
    back = tc.dequantize_chunk(got, mode, 256, 1000)
    assert back.dtype == torch.float32
    assert np.array_equal(_bits(back.numpy()),
                          _bits(jc.dequantize_chunk(want, mode, 256, 1000)))


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("route", ["plain", "wrapper"])
def test_nonfinite_sentinels_survive(bad, route):
    """A NaN or Inf makes its block's scale non-finite (as in JAX) and the
    whole block dequantizes non-finite; the other blocks stay exact."""
    x = np.r_[np.ones(10, np.float32), np.float32(bad), np.ones(5, np.float32)]
    want = jc.quantize_chunk(jnp.asarray(x), "int8", 4)
    if route == "plain":
        got = tc.quantize_chunk(torch.from_numpy(x), "int8", 4)
        back = tc.dequantize_chunk(got, "int8", 4, 16).numpy()
    else:
        got = fused_quant(torch.from_numpy(x), 4)
        back = fused_dequant(got, 4, 16).numpy()
    scale, ref = got["scale"].numpy(), np.asarray(want["scale"])
    assert np.isnan(scale[2]) == np.isnan(ref[2])
    assert not np.isfinite(scale[2]) and not np.isfinite(ref[2])
    if not np.isnan(bad):
        assert scale[2] == ref[2]
    assert not np.isfinite(back[8:12]).any()
    assert np.array_equal(back[:8], np.ones(8, np.float32))
    assert np.array_equal(back[12:], np.ones(4, np.float32))


def test_all_zero_block_quantizes_to_zero():
    x = torch.zeros(300)
    x[:10] = 1.5
    got = fused_quant(x, 128)
    assert got["scale"][1:].eq(0).all() and got["q"][128:].eq(0).all()
    assert torch.equal(fused_dequant(got, 128, 300), x)


@pytest.mark.parametrize("size,mode,block", [
    (1024, "f32", 256), (1024, "bf16", 256), (1024, "int8", 256),
    (37, "int8", 16), (5, "int8", 256)])
def test_chunk_wire_bytes_equal_jax(size, mode, block):
    assert tc.chunk_wire_bytes(size, mode, block) == jc.chunk_wire_bytes(
        size, mode, block)


def _netresdeep_templates():
    jax_params = jax.eval_shape(lambda: create_train_state(
        FlaxNetResDeep(), make_optimizer(lr=0.1), jax.random.key(0))).params
    port_params = dict(NetResDeep().named_parameters())
    return jax_params, port_params


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("ef", [False, True])
def test_accounting_equals_jax_netresdeep_n8(mode, ef):
    jax_params, port_params = _netresdeep_templates()
    cfg = dict(mode=mode, block=256, error_feedback=ef)
    want = jc.GradCompressor(jc.GradCompression(**cfg), jax_params, 8).accounting()
    got = tc.GradCompressor(tc.GradCompression(**cfg), port_params, 8).accounting()
    assert got == want


def test_wire_bytes_table_equals_jax():
    jax_params, port_params = _netresdeep_templates()
    assert (tc.wire_bytes_table(port_params, 8)
            == jc.wire_bytes_table(jax_params, 8))


def test_compression_config_validation_matches_jax():
    for kw in (dict(mode="fp8"), dict(block=0)):
        with pytest.raises(ValueError) as want:
            jc.GradCompression(**kw)
        with pytest.raises(ValueError) as got:
            tc.GradCompression(**kw)
        assert str(got.value) == str(want.value)


def test_flatten_pads_to_shards_and_round_trips():
    params = dict(NetResDeep(n_chans1=6, n_blocks=2).named_parameters())
    comp = tc.GradCompressor(tc.GradCompression(), params, 4)
    flat = comp.flatten({n: p.detach() for n, p in params.items()})
    for name, x in flat.items():
        assert x.shape[0] % 4 == 0 and x.shape[0] - params[name].numel() < 4
    back = comp.unflatten(flat)
    assert all(torch.equal(back[n], params[n].detach()) for n in params)
    res = comp.init_residual(torch.device("cpu"))
    assert all(res[n].shape == flat[n].shape and not res[n].any() for n in flat)


def test_wrappers_refuse_other_devices_and_bad_operands():
    x = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_quant(x, 4)
    with pytest.raises(ValueError, match="1-D float32"):
        fused_quant(torch.zeros(4, 4), 4)
    payload = fused_quant(torch.ones(16), 4)
    with pytest.raises(ValueError, match="want int8 q"):
        fused_dequant(payload, 8, 16)
    with pytest.raises(ValueError, match="add_to must be float32"):
        fused_dequant(payload, 4, 16, add_to=torch.zeros(15))


def test_strided_input_is_made_contiguous():
    base = torch.arange(64, dtype=torch.float32)
    got = fused_quant(base[::2], 16)
    want = tc.quantize_chunk(base[::2].contiguous(), "int8", 16)
    assert torch.equal(got["q"], want["q"]) and torch.equal(got["scale"], want["scale"])


def test_registry_names_k2_k3():
    for name, plain, line in (("fused_quant", tc.quantize_chunk, ":58"),
                              ("fused_dequant", tc.dequantize_chunk, ":104")):
        entry = ops.resolve(name)
        assert entry["plain"] is plain and entry["route"] == "cuda"
        assert entry["replaces"] == "tpu_ddp/ops/fused_quant.py" + line
        assert entry["source"] == "tpu_ddp_torch/ops/csrc/fused_quant.cu"
