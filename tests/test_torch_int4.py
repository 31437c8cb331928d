"""int4 weight-only matmul: the port's packing and plain matmuls against JAX
``ops/int4_matmul.py``.  Packing and dequantization are exact; the
dequantizing matmul is f32 on both sides and differs only in summation order
(tolerance 1e-5).  The grouped plain version, the kernel's own arithmetic,
is held to the Pallas kernel with bf16 x: both sum each group's exact
products in f32, add them times the scales in group order and round once to
bf16, so they differ by one bf16 ulp at most (2**-7 of the output), plus
2**-16 of the row's largest output for f32 sums in another order where an
output cancels to near zero."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chatts_tpu.ops import int4_matmul as ji4
from chatts_tpu_torch.ops import int4_matmul as ti4

TOL = 1e-5


def _int4_values(seed, in_dim=256, out_dim=256):
    rng = np.random.default_rng(seed)
    q = rng.integers(-8, 8, size=(in_dim, out_dim)).astype(np.int8)
    scales = rng.uniform(0.01, 0.2, size=(in_dim // 128, out_dim)).astype(np.float32)
    return q, scales


def test_torch_pack_from_int4_values_matches_jax_bytes():
    q, scales = _int4_values(0)
    want_p, want_s = ji4.pack_from_int4_values(jnp.asarray(q), jnp.asarray(scales))
    got_p, got_s = ti4.pack_from_int4_values(torch.from_numpy(q), torch.from_numpy(scales))
    assert got_p.dtype == torch.int8
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(ti4.unpack_values(got_p).numpy(), q.astype(np.int32))


def test_torch_pack_int4_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.05, size=(384, 256)).astype(np.float32)
    want_p, want_s = ji4.pack_int4(jnp.asarray(w))
    got_p, got_s = ti4.pack_int4(torch.from_numpy(w))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_torch_dequantize_is_exact():
    q, scales = _int4_values(2)
    packed, _ = ji4.pack_from_int4_values(jnp.asarray(q), jnp.asarray(scales))
    want = np.asarray(ji4.dequantize(packed, jnp.asarray(scales)))
    got = ti4.dequantize(torch.from_numpy(np.asarray(packed)), torch.from_numpy(scales))
    np.testing.assert_array_equal(got.numpy(), want)
    expect = (q.astype(np.float32).reshape(2, 128, -1) * scales[:, None, :]).reshape(256, -1)
    np.testing.assert_array_equal(got.numpy(), expect)


def test_torch_int4_plain_matmul_matches_pallas_interpret():
    q, scales = _int4_values(3)
    packed, _ = ji4.pack_from_int4_values(jnp.asarray(q), jnp.asarray(scales))
    x = np.random.default_rng(4).normal(0, 1, (5, 256)).astype(np.float32)
    want = np.asarray(ji4.int4_matmul(jnp.asarray(x), packed, jnp.asarray(scales),
                                      interpret=True))
    args = (torch.from_numpy(x), torch.from_numpy(np.asarray(packed)),
            torch.from_numpy(scales))
    got = ti4.int4_matmul_reference(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # On CPU tensors the wrapper is the plain version and launches nothing.
    before = ti4.int4_matmul.launches
    np.testing.assert_array_equal(ti4.int4_matmul(*args).numpy(), got.numpy())
    assert ti4.int4_matmul.launches == before


@pytest.mark.parametrize("r", [1, 5, 37])
def test_torch_int4_grouped_plain_matches_pallas_interpret(r):
    q, scales = _int4_values(10 + r, in_dim=384)
    q[:2, :7] = -8  # 0x88 bytes
    packed, _ = ji4.pack_from_int4_values(jnp.asarray(q), jnp.asarray(scales))
    x = np.random.default_rng(r).normal(0, 1, (r, 384)).astype(np.float32)
    want = ji4.int4_matmul(jnp.asarray(x, jnp.bfloat16), packed, jnp.asarray(scales),
                           interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = ti4.int4_matmul_grouped_reference(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(np.asarray(packed)),
        torch.from_numpy(scales))
    assert got.dtype == torch.bfloat16 and got.shape == (r, 256)
    err = np.abs(got.float().numpy() - want)
    tol = 2.0 ** -7 * np.abs(want) + 2.0 ** -16 * np.abs(want).max(axis=-1, keepdims=True)
    assert (err <= tol).all(), err.max()


def test_torch_int4_wrapper_refuses_other_devices():
    x = torch.empty((2, 256), device="meta", dtype=torch.bfloat16)
    packed = torch.empty((128, 256), device="meta", dtype=torch.int8)
    scales = torch.empty((2, 256), device="meta", dtype=torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        ti4.int4_matmul(x, packed, scales)
