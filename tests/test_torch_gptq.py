"""The port's GPTQ-Int4 import (``models/gptq.py``) against the JAX
package's: the numpy helpers give equal arrays, and ``to_native_int4`` gives
the JAX function's ``kernel_q4``, ``scales4``, ``zeros4`` and ``perm4`` to the
bit for the symmetric, asymmetric and activation-order (desc_act) exports.

One chosen difference is pinned: the port's int4 kernels take group 128
only, so a group-64 or ``group_size=-1`` export gives None here (the loader
requantizes it at group 128), where the JAX package converts it.

The converted projection, run through the port's ``Dense`` in f32 on the
CPU, equals x @ dequantize(...) within 1e-4 (the JAX test's tolerance: f32
sums in another order)."""
import numpy as np
import pytest
import torch

from chatts_tpu.models import gptq as jgptq
from chatts_tpu_torch.models import gptq
from chatts_tpu_torch.models.qwen import Dense


def _synth(rng, in_f, out_f, group, *, asym, desc_act, scale_dtype=np.float16):
    codes = rng.integers(0, 16, size=(in_f, out_f), dtype=np.int32)
    groups = in_f // group
    if asym:
        zeros = rng.integers(1, 16, size=(groups, out_f), dtype=np.int32)
    else:
        zeros = np.full((groups, out_f), 8, np.int32)
    sd = {
        "p.qweight": jgptq.pack_int4(codes, axis=0),
        "p.qzeros": jgptq.pack_int4(zeros - 1, axis=1),
        "p.scales": rng.uniform(0.01, 0.1, size=(groups, out_f)).astype(scale_dtype),
    }
    g_idx = np.repeat(np.arange(groups), group).astype(np.int32)
    if desc_act:
        rng.shuffle(g_idx)
    sd["p.g_idx"] = g_idx
    return sd


def test_torch_gptq_pack_unpack_round_trip():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 16, size=(64, 24), dtype=np.int32)
    for axis, shape in ((0, (8, 24)), (1, (64, 3))):
        packed = gptq.pack_int4(codes, axis=axis)
        assert packed.shape == shape
        np.testing.assert_array_equal(packed, jgptq.pack_int4(codes, axis=axis))
        np.testing.assert_array_equal(gptq.unpack_int4(packed, axis=axis), codes)


@pytest.mark.parametrize("desc_act", [False, True], ids=["group_map", "g_idx"])
def test_torch_gptq_dequantize_equals_jax(desc_act):
    rng = np.random.default_rng(1)
    sd = _synth(rng, 256, 128, 64, asym=True, desc_act=desc_act, scale_dtype=np.float32)
    g_idx = sd["p.g_idx"] if desc_act else None
    want = jgptq.dequantize(sd["p.qweight"], sd["p.qzeros"], sd["p.scales"], g_idx=g_idx)
    got = gptq.dequantize(sd["p.qweight"], sd["p.qzeros"], sd["p.scales"], g_idx=g_idx)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gptq.load_gptq_kernel(sd, "p"), jgptq.load_gptq_kernel(sd, "p"))


def test_torch_gptq_native_codes_need_no_unpacking():
    """The byte route (qweight's bytes transposed, XOR 0x88) gives the packed
    layout of the unpacked codes minus 8."""
    from chatts_tpu_torch.ops.int4_matmul import pack_from_int4_values

    rng = np.random.default_rng(2)
    codes = rng.integers(0, 16, size=(256, 384), dtype=np.int32)
    got = gptq.native_codes(torch.from_numpy(gptq.pack_int4(codes, axis=0)))
    want, _ = pack_from_int4_values(torch.from_numpy(codes - 8).to(torch.int8),
                                    torch.ones((2, 384)))
    assert got.dtype == torch.int8 and torch.equal(got, want)


@pytest.mark.parametrize("asym,desc_act", [(False, False), (True, False), (False, True),
                                           (True, True)],
                         ids=["sym", "asym", "desc_act", "asym_desc_act"])
def test_torch_gptq_to_native_int4_bit_equal_to_jax(asym, desc_act):
    rng = np.random.default_rng(3)
    sd = _synth(rng, 512, 256, 128, asym=asym, desc_act=desc_act)
    want = jgptq.to_native_int4(sd, "p")
    got = gptq.to_native_int4(sd, "p")
    assert set(got) == set(want)
    assert ("zeros4" in got) == asym and ("perm4" in got) == desc_act
    for key in want:
        w = np.array(want[key])
        assert got[key].dtype == torch.from_numpy(w).dtype, key
        np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)

    # The port's Dense applies perm4 and zeros4 around the int4 matmul.
    x = rng.normal(0, 1, size=(5, 512)).astype(np.float32)
    w = jgptq.load_gptq_kernel(sd, "p")
    y = Dense(**got)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, x @ w, rtol=1e-4, atol=1e-4)


def test_torch_gptq_unbalanced_groups_give_none():
    rng = np.random.default_rng(4)
    sd = _synth(rng, 256, 128, 128, asym=False, desc_act=False)
    sd["p.g_idx"] = np.asarray([0] * 100 + [1] * 156, np.int32)
    assert gptq.to_native_int4(sd, "p") is None
    assert jgptq.to_native_int4(sd, "p") is None


@pytest.mark.parametrize("group", [64, 256], ids=["group64", "group_size_minus_1"])
def test_torch_gptq_other_group_sizes_give_none_where_jax_converts(group):
    """The chosen difference: the JAX package converts these exports
    losslessly to its TPU kernel's layout; the port's kernels take group 128
    only, so it gives None and the loader requantizes at group 128."""
    rng = np.random.default_rng(5)
    sd = _synth(rng, 256, 128, group, asym=False, desc_act=False)
    assert jgptq.to_native_int4(sd, "p") is not None
    assert gptq.to_native_int4(sd, "p") is None


def test_torch_gptq_to_native_int4_reads_qweight_to_the_device():
    """Only qweight is read with the device; the result lies there (the CPU
    here; tests/test_torch_weights_gpu.py holds the card's to the CPU's)."""
    rng = np.random.default_rng(6)
    sd = {k: torch.from_numpy(v) for k, v in
          _synth(rng, 256, 128, 128, asym=True, desc_act=True).items()}
    out = gptq.to_native_int4(sd, "p", device="cpu")
    assert all(t.device.type == "cpu" for t in out.values())
    assert gptq.has_gptq_tensors(sd, "p") and not gptq.has_gptq_tensors(sd, "q")
