"""Attention: the plain versions of the port's two attention kernels against
JAX ``mha_reference`` and against the Pallas kernels in interpret mode.

Tolerance 1e-5 (rtol and atol) in f32: the math is the same and only the
order of the f32 sums differs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chatts_tpu.ops import attention as jattn
from chatts_tpu.ops import flash_attention as jfa
from chatts_tpu.ops import ragged_decode_attention as jrda
from chatts_tpu_torch.ops import attention as tattn
from chatts_tpu_torch.ops import flash_attention as tfa
from chatts_tpu_torch.ops import ragged_decode_attention as trda

TOL = 1e-5


def _prefill_inputs(b, t, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, t, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, t, kvh, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, t, kvh, d)).astype(np.float32)
    pos = np.tile(np.arange(t, dtype=np.int32)[None], (b, 1))
    seq_lens = np.asarray([t, t - t // 3][:b])
    valid = pos < seq_lens[:, None]
    valid[-1, :3] = False  # the last row's queries 0..2 have no valid key
    return q, k, v, pos, valid


def _both(q, k, v, pos, valid):
    jax_kw = dict(q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
                  kv_valid=jnp.asarray(valid))
    torch_kw = dict(q_positions=torch.from_numpy(pos), kv_positions=torch.from_numpy(pos),
                    kv_valid=torch.from_numpy(valid))
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    targs = [torch.from_numpy(a) for a in (q, k, v)]
    return jargs, jax_kw, targs, torch_kw


@pytest.mark.parametrize("t,h,kvh,d", [(40, 4, 2, 16), (37, 6, 3, 32), (24, 4, 4, 8)])
def test_torch_mha_reference_matches_jax(t, h, kvh, d):
    jargs, jkw, targs, tkw = _both(*_prefill_inputs(2, t, h, kvh, d, seed=t))
    want = np.asarray(jattn.mha_reference(*jargs, **jkw))
    got = tattn.mha_reference(*targs, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[-1, :3], 0.0)  # no valid key -> 0


def test_torch_flash_plain_matches_pallas_interpret():
    jargs, jkw, targs, tkw = _both(*_prefill_inputs(2, 128, 4, 2, 64, seed=1))
    want = np.asarray(jfa.flash_attention(*jargs, **jkw, interpret=True))
    got = tfa.flash_attention_reference(*targs, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # On CPU tensors the wrapper is the plain version and launches nothing.
    before = tfa.flash_attention.launches
    np.testing.assert_array_equal(tfa.flash_attention(*targs, **tkw).numpy(), got)
    np.testing.assert_array_equal(tattn.attention(*targs, **tkw).numpy(), got)
    assert tfa.flash_attention.launches == before


def _decode_inputs(b, h, kvh, s, d, lengths, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, kvh, s, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, kvh, s, d)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


def test_torch_ragged_plain_matches_jax_decode_attention():
    """Against the JAX engine's own decode attention off the TPU: the
    reference over the transposed cache with kv_pos <= cur_len."""
    q, k, v, lengths = _decode_inputs(3, 4, 2, 64, 16, [1, 30, 64], seed=2)
    b, s = q.shape[0], k.shape[2]
    kv_pos = np.tile(np.arange(s, dtype=np.int32)[None], (b, 1))
    want = jattn.mha_reference(
        jnp.asarray(q)[:, None], jnp.swapaxes(jnp.asarray(k), 1, 2),
        jnp.swapaxes(jnp.asarray(v), 1, 2),
        q_positions=jnp.asarray(lengths - 1)[:, None], kv_positions=jnp.asarray(kv_pos),
        kv_valid=jnp.asarray(kv_pos < lengths[:, None]),
    )[:, 0]
    got = trda.ragged_decode_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v, lengths)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_torch_ragged_plain_matches_pallas_interpret():
    q, k, v, lengths = _decode_inputs(2, 4, 2, 512, 128, [5, 300], seed=3)
    want = np.asarray(jrda.ragged_decode_attention(
        *(jnp.asarray(a) for a in (q, k, v, lengths)), interpret=True))
    targs = [torch.from_numpy(a) for a in (q, k, v, lengths)]
    got = trda.ragged_decode_attention_reference(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    before = trda.ragged_decode_attention.launches
    np.testing.assert_array_equal(trda.ragged_decode_attention(*targs).numpy(), got)
    assert trda.ragged_decode_attention.launches == before


def test_torch_ragged_plain_zero_length_row_is_zero():
    q, k, v, lengths = _decode_inputs(2, 4, 2, 32, 16, [0, 7], seed=4)
    got = trda.ragged_decode_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v, lengths)))
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got[0].numpy(), 0.0)


def test_torch_attention_wrappers_refuse_other_devices():
    q = torch.empty((1, 8, 2, 128), device="meta", dtype=torch.bfloat16)
    pos = torch.empty((1, 8), device="meta", dtype=torch.int32)
    valid = torch.empty((1, 8), device="meta", dtype=torch.bool)
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention(q, q, q, q_positions=pos, kv_positions=pos, kv_valid=valid)
    cache = torch.empty((1, 2, 8, 128), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        trda.ragged_decode_attention(q[:, 0], cache, cache, pos[:, 0])


# ---------------------------------------------------------------------------
# The plain versions of the CUDA kernels' own arithmetic: the tiled prefill
# attention and the split decode attention.
#
# Tolerance, f32 on the CPU: the tile loop and the logsumexp merge add the
# same f32 terms in another order than the dense softmax, which moves a
# result by a few units of 2**-24 of the row's largest output, so
# |got - want| <= 1e-5 * max_D |want| (+ 1e-6 where a row is all zeros).
# ---------------------------------------------------------------------------

def _close_rows(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    tol = TOL * np.abs(want).max(axis=-1, keepdims=True) + 1e-6
    assert (np.abs(got - want) <= tol).all(), float(np.abs(got - want).max())


def _flash_case(name, block_k, seed=0):
    """(q, k, v, q_pos, kv_pos, kv_valid) as numpy, B = 2, H = 4, KVH = 2,
    D = 16."""
    rng = np.random.default_rng(seed)
    b, h, kvh, d = 2, 4, 2, 16
    t = s = 5 * block_k + 7
    if name == "offset_chunk":  # T < S: a chunk of queries over a longer prefix
        t = block_k + 9
    q = rng.normal(0, 1, (b, t, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, kvh, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, kvh, d)).astype(np.float32)
    kv_pos = np.tile(np.arange(s, dtype=np.int32)[None], (b, 1))
    q_pos = np.tile(np.arange(t, dtype=np.int32)[None], (b, 1)) + (s - t)
    valid = np.ones((b, s), bool)
    if name == "no_valid_key":  # row 1 has no valid key at all
        valid[1] = False
    elif name == "first_tiles_masked":  # row 0's first two tiles and a bit are invalid
        valid[0, :2 * block_k + 5] = False
    elif name == "invalid_tile_in_the_middle":
        valid[:, block_k:2 * block_k] = False
        valid[1, 3 * block_k:4 * block_k] = False
    elif name == "offset_chunk":
        valid[1, s - 11:] = False  # a padded tail
    elif name == "shuffled_keys":  # positions decide, not indices
        perm = rng.permutation(s)
        k, v, kv_pos = k[:, perm], v[:, perm], kv_pos[:, perm]
        valid[0, :block_k] = False
    else:
        raise ValueError(name)
    return q, k, v, q_pos, kv_pos, valid


FLASH_CASES = ("no_valid_key", "first_tiles_masked", "invalid_tile_in_the_middle",
               "offset_chunk", "shuffled_keys")


@pytest.mark.parametrize("block_q,block_k", [(8, 8), (16, 8), (32, 16), (128, 64)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_torch_flash_tiled_matches_dense(case, block_q, block_k):
    q, k, v, q_pos, kv_pos, valid = _flash_case(case, block_k)
    targs = [torch.from_numpy(a) for a in (q, k, v)]
    tkw = dict(q_positions=torch.from_numpy(q_pos), kv_positions=torch.from_numpy(kv_pos),
               kv_valid=torch.from_numpy(valid))
    want = tfa.flash_attention_reference(*targs, **tkw)
    stats = {}
    got = tfa.flash_attention_tiled_reference(*targs, **tkw, block_q=block_q, block_k=block_k,
                                              stats=stats)
    _close_rows(got, want)
    visible = (valid[:, None, :] & (kv_pos[:, None, :] <= q_pos[:, :, None])).any(-1)
    np.testing.assert_array_equal(got.numpy()[~visible], 0.0)  # no visible key -> 0
    assert stats["tiles_visited"] > 0
    if case != "shuffled_keys" or block_k < 64:
        assert stats["tiles_skipped"] > 0  # a skip rule fired
    if case == "no_valid_key":
        assert not visible[1].any()


@pytest.mark.parametrize("case", FLASH_CASES)
def test_torch_flash_tiled_matches_jax_dense(case):
    """Against JAX ``mha_reference`` (which takes any T and S)."""
    q, k, v, q_pos, kv_pos, valid = _flash_case(case, 16, seed=1)
    want = np.asarray(jattn.mha_reference(
        *(jnp.asarray(a) for a in (q, k, v)), q_positions=jnp.asarray(q_pos),
        kv_positions=jnp.asarray(kv_pos), kv_valid=jnp.asarray(valid)))
    got = tfa.flash_attention_tiled_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), q_positions=torch.from_numpy(q_pos),
        kv_positions=torch.from_numpy(kv_pos), kv_valid=torch.from_numpy(valid),
        block_q=32, block_k=16)
    _close_rows(got, want)


@pytest.mark.parametrize("block_q,block_k", [(64, 64), (128, 64)])
def test_torch_flash_tiled_matches_pallas_interpret(block_q, block_k):
    """The Pallas kernel in interpret mode (T and S multiples of its 128-row
    blocks), with a padded row, queries without a valid key and an invalid
    tile in the middle."""
    q, k, v, pos, valid = _prefill_inputs(2, 256, 4, 2, 64, seed=5)
    valid[0, 64:128] = False
    jargs, jkw, targs, tkw = _both(q, k, v, pos, valid)
    want = np.asarray(jfa.flash_attention(*jargs, **jkw, interpret=True))
    got = tfa.flash_attention_tiled_reference(*targs, **tkw, block_q=block_q, block_k=block_k)
    _close_rows(got, want)
    np.testing.assert_array_equal(got.numpy()[-1, :3], 0.0)


def test_torch_flash_tiled_rounds_p_and_sums_unrounded():
    """In bf16 the tiled version rounds p for the PV product only: it stays
    within bf16's rounding of the dense plain version."""
    q, k, v, q_pos, kv_pos, valid = _flash_case("first_tiles_masked", 16, seed=2)
    targs = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    tkw = dict(q_positions=torch.from_numpy(q_pos), kv_positions=torch.from_numpy(kv_pos),
               kv_valid=torch.from_numpy(valid))
    want = tfa.flash_attention_reference(*targs, **tkw).float()
    got = tfa.flash_attention_tiled_reference(*targs, **tkw, block_q=32, block_k=16).float()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    # Two roundings to bf16 (p, the output), 2**-8 each, of the row's largest.
    tol = 2.0 ** -6 * want.abs().amax(dim=-1, keepdim=True) + 1e-6
    assert ((got - want).abs() <= tol).all()


@pytest.mark.parametrize("t,want", [(1, 64), (64, 64), (65, 128), (1280, 128)])
def test_torch_flash_default_tile(t, want):
    assert tfa.default_block_q(t) == want and want in tfa.BLOCKS_Q


SPLIT_CHUNKS = (16, 32, 128)


def _split_lengths(chunk, s):
    return [0, 1, chunk - 1, chunk, chunk + 1, s]


@pytest.mark.parametrize("g", [1, 5])
@pytest.mark.parametrize("chunk", SPLIT_CHUNKS)
def test_torch_ragged_split_matches_dense(chunk, g):
    """Lengths 0, 1, chunk - 1, chunk, chunk + 1 and S, with more chunks than
    any row but the last needs."""
    s = 4 * chunk
    lengths = _split_lengths(chunk, s)
    q, k, v, lens = _decode_inputs(len(lengths), 2 * g, 2, s, 16, lengths, seed=chunk + g)
    targs = [torch.from_numpy(a) for a in (q, k, v, lens)]
    want = trda.ragged_decode_attention_reference(*targs)
    got = trda.ragged_decode_attention_split_reference(*targs, chunk=chunk)
    _close_rows(got, want)
    np.testing.assert_array_equal(got[0].numpy(), 0.0)  # length 0 -> 0


def test_torch_ragged_split_ignores_the_cache_past_the_length():
    """NaN past a row's length, in a chunk the row half fills and in chunks it
    never reaches, changes nothing."""
    q, k, v, lens = _decode_inputs(2, 4, 2, 96, 16, [40, 0], seed=9)
    k2, v2 = k.copy(), v.copy()
    k2[0, :, 40:], v2[0, :, 40:], k2[1], v2[1] = np.nan, np.nan, np.nan, np.nan
    want = trda.ragged_decode_attention_split_reference(
        *(torch.from_numpy(a) for a in (q, k, v, lens)), chunk=32)
    got = trda.ragged_decode_attention_split_reference(
        *(torch.from_numpy(a) for a in (q, k2, v2, lens)), chunk=32)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("chunk", [128, 256])
def test_torch_ragged_split_matches_pallas_interpret(chunk):
    s = 512
    lengths = _split_lengths(chunk, s)
    q, k, v, lens = _decode_inputs(len(lengths), 4, 2, s, 128, lengths, seed=chunk)
    want = np.asarray(jrda.ragged_decode_attention(
        *(jnp.asarray(a) for a in (q, k, v, lens)), interpret=True))
    got = trda.ragged_decode_attention_split_reference(
        *(torch.from_numpy(a) for a in (q, k, v, lens)), chunk=chunk)
    _close_rows(got, want)


@pytest.mark.parametrize("s,b,kvh", [(2048, 4, 8), (1024, 24, 8), (6144, 1, 8), (6144, 24, 8),
                                     (64, 1, 1), (300, 3, 2), (130, 1, 4), (6144, 1, 4)])
def test_torch_ragged_split_plan_covers_the_capacity(s, b, kvh):
    """The plan comes from the shapes alone; its chunks are whole key tiles,
    cover S, and none starts past S."""
    splits, chunk = trda.split_plan(s, b, kvh)
    assert chunk % trda.KEY_TILE == 0 and chunk >= trda.KEY_TILE
    assert (splits - 1) * chunk < s <= splits * chunk
    assert splits * b * kvh <= max(trda.MAX_BLOCKS, b * kvh) and splits <= trda.MAX_SPLITS
    # The default chunk of the split plain version is the plan's.
    q, k, v, lens = _decode_inputs(1, 2, 1, 256, 8, [200], seed=1)
    targs = [torch.from_numpy(a) for a in (q, k, v, lens)]
    np.testing.assert_array_equal(
        trda.ragged_decode_attention_split_reference(*targs).numpy(),
        trda.ragged_decode_attention_split_reference(
            *targs, chunk=trda.split_plan(256, 1, 1)[1]).numpy())


def test_torch_build_stale_sees_shared_headers(tmp_path, monkeypatch):
    """A library is rebuilt when its own source or any csrc/*.cuh is newer."""
    import os

    from chatts_tpu_torch.kernels import build

    csrc, out = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    out.mkdir()
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(out))
    source, header, other = csrc / "a.cu", csrc / "shared.cuh", csrc / "b.cu"
    for f in (source, header, other):
        f.write_text("// test")
    assert build._stale("a")  # no library yet
    lib = out / "liba.so"
    lib.write_text("")

    def touch(path, at):
        os.utime(path, (at, at))

    for f in (source, header, other):
        touch(f, 1000)
    touch(lib, 2000)
    assert not build._stale("a")
    touch(header, 3000)
    assert build._stale("a")  # the shared header is newer
    touch(header, 1000)
    touch(other, 3000)
    assert not build._stale("a")  # another kernel's source does not count
    touch(source, 3000)
    assert build._stale("a")
