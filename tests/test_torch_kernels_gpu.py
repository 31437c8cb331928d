"""The port's CUDA kernels against their plain versions on the card, at small
and ragged shapes (the main path's shapes are in ``chip_smoke.py``).

Marked ``gpu``; each test skips where there is no CUDA card.  This file
imports no JAX, so on a machine without it run it without the repository's
conftest (which sets JAX up):

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py

Tolerance, both sides bf16 on the card: |got - ref| <= 2e-2 + 2e-2 |ref|.
The outputs round to bf16 (one ulp apart at worst), the plain int4 matmul
rounds each dequantized weight to bf16, and the plain attention rounds
normalised probabilities where the kernel rounds them against a running max.

The two attention kernels are also held to the plain versions of their own
arithmetic.  The prefill kernel against ``flash_attention_tiled_reference``
(the same tiles, skips, sentinel and roundings), per row to 2**-6 of the
row's largest output: p rounds to bf16 on both sides and may land one ulp
apart where the f32 exponentials differ in their last bits (2**-8 of p each,
so at most that share of the row's largest value), and the output rounds to
bf16 once more.  The decode kernel against
``ragged_decode_attention_split_reference``, per row to 2**-7 of the row's
largest output: both are f32 throughout and round once to bf16.

The int8 decode attention is held tighter, per (row, head), to 2e-2 of that
row's largest output: both sides compute in f32 and round once to bf16 (one
ulp, at most 2**-7 of the row's largest), and a long row's outputs are too
small for the shared absolute tolerance to see one wrong 128-key tile.  Its
split cases are also held to ``ragged_decode_attention_int8_split_reference``,
per row to 2**-7 of the row's largest output, as the bf16 kernel's are.

The int4 matmul is also held, path by path, to one bf16 ulp of the plain
version of its own arithmetic (see its test).

The int8-activation matmul is held to the bits of its plain version: every
group's int32 sum is exact, and both add f32(sum) * s_g in group order and
round once.  The int8-weight projection
on the card is held to one bf16 ulp of the same projection on the CPU: with
int8 activations its products are exact integers; weight-only, its f32 sums
run in another order, so where an output cancels to near zero it may differ
by 1e-4 of the largest output.
"""
import math

import pytest
import torch

from chatts_tpu_torch.models.qwen import Dense
from chatts_tpu_torch.ops import flash_attention as fa
from chatts_tpu_torch.ops import int4_matmul as i4
from chatts_tpu_torch.ops import ragged_decode_attention as rda

pytestmark = pytest.mark.gpu

ATOL = 2e-2
RTOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _close(got, ref):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() <= ATOL + RTOL * ref.abs()).all(), float((got - ref).abs().max())


def _close_rows(got, ref, rtol=2e-2):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    tol = rtol * ref.abs().amax(dim=-1, keepdim=True)
    assert ((got - ref).abs() <= tol).all(), float((got - ref).abs().max())


def _bf16(gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("t,s,h,kvh", [(1, 1, 2, 1), (65, 65, 4, 2), (100, 37, 8, 8),
                                       (130, 200, 6, 2)])
def test_torch_flash_kernel_matches_plain(cuda, t, s, h, kvh):
    gen = torch.Generator(device=cuda).manual_seed(t)
    b, d = 2, 128
    q, k, v = _bf16(gen, (b, t, h, d), cuda), _bf16(gen, (b, s, kvh, d), cuda), \
        _bf16(gen, (b, s, kvh, d), cuda)
    q_pos = (torch.arange(t, device=cuda, dtype=torch.int32) + max(0, s - t))[None].repeat(b, 1)
    kv_pos = torch.arange(s, device=cuda, dtype=torch.int32)[None].repeat(b, 1)
    kv_valid = kv_pos < torch.tensor([s, max(1, s // 2)], device=cuda)[:, None]
    kv_valid[1, 0] = False
    kw = dict(q_positions=q_pos.contiguous(), kv_positions=kv_pos.contiguous(),
              kv_valid=kv_valid.contiguous())
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _close(got, fa.flash_attention_reference(q, k, v, **kw))


def _flash_case(name, dev, seed=0):
    """The CPU tests' prefill cases at the kernel's widths (bf16, D = 128,
    64-key tiles): (q, k, v, kw)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h, kvh, d, bk = 2, 10, 2, 128, 64
    t = s = 5 * bk + 7
    if name == "offset_chunk":
        t = bk + 9
    q, k, v = _bf16(gen, (b, t, h, d), dev), _bf16(gen, (b, s, kvh, d), dev), \
        _bf16(gen, (b, s, kvh, d), dev)
    kv_pos = torch.arange(s, device=dev, dtype=torch.int32)[None].repeat(b, 1)
    q_pos = torch.arange(t, device=dev, dtype=torch.int32)[None].repeat(b, 1) + (s - t)
    valid = torch.ones((b, s), device=dev, dtype=torch.bool)
    if name == "no_valid_key":
        valid[1] = False
    elif name == "first_tiles_masked":
        valid[0, :2 * bk + 5] = False
    elif name == "invalid_tile_in_the_middle":
        valid[:, bk:2 * bk] = False
        valid[1, 3 * bk:4 * bk] = False
    elif name == "offset_chunk":
        valid[1, s - 11:] = False
    elif name == "shuffled_keys":
        perm = torch.randperm(s, generator=gen, device=dev)
        k, v, kv_pos = k[:, perm].contiguous(), v[:, perm].contiguous(), kv_pos[:, perm]
        valid[0, :bk] = False
    else:
        raise ValueError(name)
    return q, k, v, dict(q_positions=q_pos.contiguous(), kv_positions=kv_pos.contiguous(),
                         kv_valid=valid.contiguous())


@pytest.mark.parametrize("block_q", [64, 128])
@pytest.mark.parametrize("case", ["no_valid_key", "first_tiles_masked",
                                  "invalid_tile_in_the_middle", "offset_chunk",
                                  "shuffled_keys"])
def test_torch_flash_kernel_cases(cuda, case, block_q):
    """Both query tiles of the kernel against the dense plain version and
    against the plain version of its own arithmetic; two calls bit-equal."""
    q, k, v, kw = _flash_case(case, cuda)
    got = fa.flash_attention_on_tile(q, k, v, **kw, block_q=block_q)
    again = fa.flash_attention_on_tile(q, k, v, **kw, block_q=block_q)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, fa.flash_attention_reference(q, k, v, **kw))
    _close_rows(got, fa.flash_attention_tiled_reference(q, k, v, **kw, block_q=block_q),
                rtol=2.0 ** -6)
    visible = (kw["kv_valid"][:, None, :]
               & (kw["kv_positions"][:, None, :] <= kw["q_positions"][:, :, None])).any(-1)
    assert (got[~visible] == 0).all()  # no visible key -> 0
    if block_q == fa.default_block_q(q.shape[1]):
        assert torch.equal(got, fa.flash_attention(q, k, v, **kw))


def test_torch_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16)
    pos = torch.zeros((1, 8), device=cuda, dtype=torch.int32)
    valid = torch.ones((1, 8), device=cuda, dtype=torch.bool)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q, q_positions=pos, kv_positions=pos, kv_valid=valid)
    q = torch.zeros((1, 8, 2, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="query tile"):
        fa.flash_attention_on_tile(q, q, q, q_positions=pos, kv_positions=pos, kv_valid=valid,
                                   block_q=96)


@pytest.mark.parametrize("lengths,h,kvh,s", [([0, 1, 129], 8, 2, 300), ([256, 255], 40, 8, 256),
                                             ([17], 16, 1, 64)])
def test_torch_ragged_kernel_matches_plain(cuda, lengths, h, kvh, s):
    gen = torch.Generator(device=cuda).manual_seed(len(lengths))
    b, d = len(lengths), 128
    q = _bf16(gen, (b, h, d), cuda)
    k, v = _bf16(gen, (b, kvh, s, d), cuda), _bf16(gen, (b, kvh, s, d), cuda)
    lens = torch.tensor(lengths, device=cuda, dtype=torch.int32)
    before = rda.ragged_decode_attention.launches
    got = rda.ragged_decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert rda.ragged_decode_attention.launches == before + 1
    _close(got, rda.ragged_decode_attention_reference(q, k, v, lens))


@pytest.mark.parametrize("g", [1, 5, 7, 16])
@pytest.mark.parametrize("chunk", [128, 256])
def test_torch_ragged_kernel_split_cases(cuda, g, chunk):
    """Lengths 0, 1, chunk - 1, chunk, chunk + 1 and S through the split
    kernel, with more chunks than any row but the last needs and NaN in the
    cache past every length; against both plain versions; two calls
    bit-equal."""
    s, kvh, d = 4 * chunk + 40, 2, 128
    lengths = [0, 1, chunk - 1, chunk, chunk + 1, s]
    b = len(lengths)
    gen = torch.Generator(device=cuda).manual_seed(g + chunk)
    q = _bf16(gen, (b, g * kvh, d), cuda)
    k, v = _bf16(gen, (b, kvh, s, d), cuda), _bf16(gen, (b, kvh, s, d), cuda)
    lens = torch.tensor(lengths, device=cuda, dtype=torch.int32)
    past = torch.arange(s, device=cuda)[None, None, :, None] >= lens[:, None, None, None]
    k_nan = torch.where(past, float("nan"), k)
    v_nan = torch.where(past, float("nan"), v)
    plan = (-(-s // chunk), chunk)
    got = rda.ragged_decode_attention_on_plan(q, k_nan, v_nan, lens, plan)
    again = rda.ragged_decode_attention_on_plan(q, k_nan, v_nan, lens, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, rda.ragged_decode_attention_reference(q, k, v, lens))
    _close_rows(got, rda.ragged_decode_attention_split_reference(q, k, v, lens, chunk=chunk),
                rtol=2.0 ** -7)
    assert (got[0] == 0).all()  # a row of length 0 gives 0
    one = rda.ragged_decode_attention_on_plan(q, k_nan, v_nan, lens, (1, plan[0] * chunk))
    torch.cuda.synchronize()
    _close_rows(one, got, rtol=2.0 ** -7)  # one split: no merge kernel
    assert (one[0] == 0).all()


def test_torch_ragged_kernel_in_a_cuda_graph(cuda):
    """The wrapper reads nothing of ``lengths`` on the host: a call captured
    in a CUDA graph and replayed after ``lengths`` changed gives the new
    lengths' result."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    b, h, kvh, s, d = 4, 40, 8, 2048, 128
    q = _bf16(gen, (b, h, d), cuda)
    k, v = _bf16(gen, (b, kvh, s, d), cuda), _bf16(gen, (b, kvh, s, d), cuda)
    lens = torch.tensor([1, 255, 257, 2048], device=cuda, dtype=torch.int32)
    rda.ragged_decode_attention(q, k, v, lens)  # builds and loads outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rda.ragged_decode_attention(q, k, v, lens)
    graph.replay()
    torch.cuda.synchronize()
    _close(out, rda.ragged_decode_attention_reference(q, k, v, lens))
    new = torch.tensor([2048, 0, 1000, 300], device=cuda, dtype=torch.int32)
    lens.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    _close(out, rda.ragged_decode_attention_reference(q, k, v, new))
    assert (out[1] == 0).all()
    assert torch.equal(out, rda.ragged_decode_attention(q, k, v, new))


def test_torch_ragged_kernel_refuses_a_plan_that_does_not_cover(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _bf16(gen, (1, 4, 128), cuda)
    k = _bf16(gen, (1, 2, 300, 128), cuda)
    lens = torch.tensor([5], device=cuda, dtype=torch.int32)
    for plan in ((2, 128), (4, 128), (3, 100), (1, 256)):
        with pytest.raises(ValueError, match="plan"):
            rda.ragged_decode_attention_on_plan(q, k, k, lens, plan)


def _int8_cache(gen, shape, dev):
    codes = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
    scales = (torch.rand(shape[:3], generator=gen, device=dev) + 0.5) / 127
    return codes, scales


@pytest.mark.parametrize("lengths,h,kvh,s", [([0, 1, 129], 8, 2, 300), ([256, 255, 257], 40, 8, 1024),
                                             ([17], 16, 1, 64), ([1000, 3], 10, 2, 1000),
                                             ([0], 4, 4, 130), ([6000, 4500], 8, 2, 6144)])
def test_torch_ragged_int8_kernel_matches_plain(cuda, lengths, h, kvh, s):
    gen = torch.Generator(device=cuda).manual_seed(len(lengths) + s)
    b, d = len(lengths), 128
    q = _bf16(gen, (b, h, d), cuda)
    k, ks = _int8_cache(gen, (b, kvh, s, d), cuda)
    v, vs = _int8_cache(gen, (b, kvh, s, d), cuda)
    lens = torch.tensor(lengths, device=cuda, dtype=torch.int32)
    before = rda.ragged_decode_attention_int8.launches
    got = rda.ragged_decode_attention_int8(q, k, v, ks, vs, lens)
    torch.cuda.synchronize()
    assert rda.ragged_decode_attention_int8.launches == before + 1
    _close_rows(got, rda.ragged_decode_attention_int8_reference(q, k, v, ks, vs, lens))
    assert (got[lens == 0] == 0).all()  # a row of length 0 gives 0


@pytest.mark.parametrize("g", [1, 5, 7, 16])
@pytest.mark.parametrize("chunk", [128, 256])
def test_torch_ragged_int8_kernel_split_cases(cuda, g, chunk):
    """Lengths 0, 1, chunk - 1, chunk, chunk + 1 and S through the int8 split
    kernel, with more chunks than any row but the last needs and NaN scales
    past every length; per (row, head) against the dense plain version (2e-2
    of the row's largest) and the plain version of its own arithmetic (one
    bf16 ulp, 2**-7); two calls bit-equal; one split (no merge) agrees."""
    s, kvh, d = 4 * chunk + 40, 2, 128
    lengths = [0, 1, chunk - 1, chunk, chunk + 1, s]
    b = len(lengths)
    gen = torch.Generator(device=cuda).manual_seed(g + chunk)
    q = _bf16(gen, (b, g * kvh, d), cuda)
    k, ks = _int8_cache(gen, (b, kvh, s, d), cuda)
    v, vs = _int8_cache(gen, (b, kvh, s, d), cuda)
    k[:, :, ::7, ::5] = -128  # the code the quantizer never writes still counts
    lens = torch.tensor(lengths, device=cuda, dtype=torch.int32)
    past = torch.arange(s, device=cuda)[None, None, :] >= lens[:, None, None]
    ks_nan = torch.where(past, float("nan"), ks)
    vs_nan = torch.where(past, float("nan"), vs)
    plan = (-(-s // chunk), chunk)
    got = rda.ragged_decode_attention_int8_on_plan(q, k, v, ks_nan, vs_nan, lens, plan)
    again = rda.ragged_decode_attention_int8_on_plan(q, k, v, ks_nan, vs_nan, lens, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close_rows(got, rda.ragged_decode_attention_int8_reference(q, k, v, ks, vs, lens))
    _close_rows(got, rda.ragged_decode_attention_int8_split_reference(
        q, k, v, ks, vs, lens, chunk=chunk), rtol=2.0 ** -7)
    assert (got[0] == 0).all()  # a row of length 0 gives 0
    one = rda.ragged_decode_attention_int8_on_plan(q, k, v, ks_nan, vs_nan, lens,
                                                   (1, plan[0] * chunk))
    torch.cuda.synchronize()
    _close_rows(one, got, rtol=2.0 ** -7)  # one split: no merge kernel
    assert (one[0] == 0).all()


def test_torch_ragged_int8_kernel_in_a_cuda_graph(cuda):
    """The int8 wrapper reads nothing of ``lengths`` on the host: a call
    captured in a CUDA graph and replayed after ``lengths`` changed gives the
    new lengths' result."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    b, h, kvh, s, d = 24, 40, 8, 1024, 128
    q = _bf16(gen, (b, h, d), cuda)
    k, ks = _int8_cache(gen, (b, kvh, s, d), cuda)
    v, vs = _int8_cache(gen, (b, kvh, s, d), cuda)
    lens = torch.randint(0, s + 1, (b,), generator=gen, device=cuda).to(torch.int32)
    rda.ragged_decode_attention_int8(q, k, v, ks, vs, lens)  # builds outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rda.ragged_decode_attention_int8(q, k, v, ks, vs, lens)
    graph.replay()
    torch.cuda.synchronize()
    _close_rows(out, rda.ragged_decode_attention_int8_reference(q, k, v, ks, vs, lens))
    new = torch.randint(0, s + 1, (b,), generator=gen, device=cuda).to(torch.int32)
    new[1], new[2] = 0, s
    lens.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    _close_rows(out, rda.ragged_decode_attention_int8_reference(q, k, v, ks, vs, new))
    assert (out[1] == 0).all()
    assert torch.equal(out, rda.ragged_decode_attention_int8(q, k, v, ks, vs, new))


def test_torch_ragged_int8_kernel_refuses_a_plan_that_does_not_cover(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _bf16(gen, (1, 4, 128), cuda)
    k, ks = _int8_cache(gen, (1, 2, 300, 128), cuda)
    lens = torch.tensor([5], device=cuda, dtype=torch.int32)
    for plan in ((2, 128), (4, 128), (3, 100), (1, 256)):
        with pytest.raises(ValueError, match="plan"):
            rda.ragged_decode_attention_int8_on_plan(q, k, k, ks, ks, lens, plan)


def test_torch_ragged_int8_kernel_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _bf16(gen, (1, 4, 128), cuda)
    k, ks = _int8_cache(gen, (1, 2, 64, 128), cuda)
    lens = torch.tensor([5], device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="int8 cache"):
        rda.ragged_decode_attention_int8(q, k.to(torch.bfloat16), k.to(torch.bfloat16),
                                         ks, ks, lens)
    with pytest.raises(ValueError, match="scales"):
        rda.ragged_decode_attention_int8(q, k, k, ks.double(), ks, lens)
    with pytest.raises(ValueError, match="lengths"):
        rda.ragged_decode_attention_int8(q, k, k, ks, ks, lens.long())
    with pytest.raises(ValueError, match="kv heads"):
        rda.ragged_decode_attention_int8(_bf16(gen, (1, 3, 128), cuda), k, k, ks, ks, lens)


INT4_ROWS = [1, 3, 16, 17, 24, 33, 64, 65, 130, 640]
INT4_SHAPES = [(128, 128), (640, 384), (1152, 256), (5120, 7168)]
# Above the band (R > STREAM_MAX_ROWS, the GEMM configuration's rows): the
# 14B projections qkv, down and gate_up, and the smallest shape.
INT4_GEMM_ROWS = [641, 1000, 2049, 4096]
INT4_GEMM_SHAPES = [(5120, 7168), (13824, 5120), (5120, 27648), (128, 128)]
INT4_CASES = ([(r, i, o) for i, o in INT4_SHAPES for r in INT4_ROWS]
              + [(r, i, o) for i, o in INT4_GEMM_SHAPES for r in INT4_GEMM_ROWS])


@pytest.mark.parametrize("r,in_dim,out_dim", INT4_CASES)
def test_torch_int4_kernel_matches_plain(cuda, r, in_dim, out_dim):
    """Every path of the kernel at R rows.  Against the plain version of its
    own arithmetic (``int4_matmul_grouped_reference``: per group an f32 sum,
    times the scales, added in group order) it is held to one bf16 ulp plus
    2**-16 of the row's largest output: only the order of the f32 sums inside
    a group differs, and the one rounding to bf16 may land one ulp apart.
    Against the dequantizing plain version, which rounds each weight to
    bf16, the shared tolerance holds.  Two calls agree to the bit, and the
    0x88 bytes count as -8."""
    gen = torch.Generator(device=cuda).manual_seed(r + in_dim)
    x = _bf16(gen, (r, in_dim), cuda)
    packed = torch.randint(-128, 128, (in_dim // 2, out_dim), generator=gen, device=cuda,
                           dtype=torch.int8)
    packed[0, :9] = -120  # 0x88: both nibbles -8
    scales = (torch.rand((in_dim // 128, out_dim), generator=gen, device=cuda) + 0.5) \
        / (7 * math.sqrt(in_dim))
    before = i4.int4_matmul.launches
    got = i4.int4_matmul(x, packed, scales)
    torch.cuda.synchronize()
    assert i4.int4_matmul.launches == before + 1
    _close(got, i4.int4_matmul_reference(x, packed, scales))
    grouped = i4.int4_matmul_grouped_reference(x, packed, scales)
    row_max = grouped.float().abs().amax(dim=-1, keepdim=True)
    one = torch.zeros_like(x)
    one[0, :2] = 1  # row 0 of the product: q[0] + q[1], times the first scales
    want1 = (-16 * scales[0, :9]).to(torch.bfloat16)
    for path in i4.PATHS.values():
        out = i4.int4_matmul_on_path(x, packed, scales, path)
        assert torch.equal(out, i4.int4_matmul_on_path(x, packed, scales, path))
        _within_one_ulp(out, grouped, 2.0 ** -16 * row_max)
        assert torch.equal(i4.int4_matmul_on_path(one, packed, scales, path)[0, :9], want1)
    assert torch.equal(got, i4.int4_matmul_on_path(x, packed, scales, i4.int4_path(r)))


@pytest.mark.parametrize("r,in_dim,out_dim", [(1000, 5120, 7168), (700, 5120, 1024)])
def test_torch_int4_gemm_in_a_cuda_graph(cuda, r, in_dim, out_dim):
    """The GEMM configuration captured in a CUDA graph, as a captured step
    would launch it (the second shape splits K, so the capture also holds
    the workspace and the reduce): a replay gives the eager call's bits, and
    after x changes in place, the new x's."""
    assert i4.int4_path(r) == i4.GEMM
    gen = torch.Generator(device=cuda).manual_seed(r)
    x = _bf16(gen, (r, in_dim), cuda)
    packed = torch.randint(-128, 128, (in_dim // 2, out_dim), generator=gen, device=cuda,
                           dtype=torch.int8)
    scales = (torch.rand((in_dim // 128, out_dim), generator=gen, device=cuda) + 0.5) \
        / (7 * math.sqrt(in_dim))
    eager = i4.int4_matmul(x, packed, scales)  # builds and loads outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = i4.int4_matmul(x, packed, scales)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x.copy_(_bf16(gen, (r, in_dim), cuda))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, i4.int4_matmul(x, packed, scales))
    assert not torch.equal(out, eager)


def test_torch_int4_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((17, 256), device=cuda, dtype=torch.bfloat16)
    packed = torch.zeros((128, 256), device=cuda, dtype=torch.int8)
    scales = torch.ones((2, 256), device=cuda)
    with pytest.raises(ValueError, match="no path"):
        i4.int4_matmul_on_path(x, packed, scales, 0)
    with pytest.raises(ValueError, match="multiples of 128"):
        i4.int4_matmul(x[:, :192], packed[:96], scales)
    with pytest.raises(ValueError, match="bfloat16"):
        i4.int4_matmul(x.float(), packed, scales)


def _within_one_ulp(got, ref, atol=0.0):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    err = (got - ref).abs()
    assert (err <= 2.0 ** -7 * ref.abs() + atol).all(), float(err.max())


@pytest.mark.parametrize("r", [1, 17, 64, 65, 129, 130, 300])
@pytest.mark.parametrize("in_dim,out_dim", [(128, 128), (640, 384), (1152, 256)])
def test_torch_int4_a8_kernel_matches_plain(cuda, r, in_dim, out_dim):
    """The a8 kernel at R rows on both sides of its 64-row tile and of the
    wrapper's choice of block width, with each width (``int4_matmul_a8_on_width``;
    OUT = 384 leaves the wide block's second warpgroup without columns in the
    last block): bit-equal to the plain version, a whole 128 x 128 weight
    tile of -8 nibbles included."""
    gen = torch.Generator(device=cuda).manual_seed(r + in_dim)
    x_q = torch.randint(-127, 128, (r, in_dim), generator=gen, device=cuda, dtype=torch.int8)
    x_scale = (torch.rand((r,), generator=gen, device=cuda) + 0.5) / 127
    packed = torch.randint(-128, 128, (in_dim // 2, out_dim), generator=gen, device=cuda,
                           dtype=torch.int8)
    packed[0, :9] = -120  # 0x88: both nibbles -8, as GPTQ imports carry
    packed[-64:, -128:] = -120  # the last group's last weight tile: all -8
    scales = (torch.rand((in_dim // 128, out_dim), generator=gen, device=cuda) + 0.5) \
        / (7 * math.sqrt(in_dim))
    before = i4.int4_matmul_a8.launches
    got = i4.int4_matmul_a8(x_q, x_scale, packed, scales)
    torch.cuda.synchronize()
    assert i4.int4_matmul_a8.launches == before + 1
    assert got.shape == (r, out_dim) and got.dtype == torch.bfloat16
    ref = i4.int4_matmul_a8_reference(x_q, x_scale, packed, scales)
    _within_one_ulp(got, ref)
    assert torch.equal(got, ref)
    for warpgroups in i4.A8_WARPGROUPS:
        out = i4.int4_matmul_a8_on_width(x_q, x_scale, packed, scales, warpgroups)
        assert torch.equal(out, ref), warpgroups
    assert torch.equal(got, i4.int4_matmul_a8_on_width(x_q, x_scale, packed, scales,
                                                       i4.a8_warpgroups(r)))
    # The -8 nibbles count as -8: with row 0 of x_q set to 1 and the rest 0,
    # row 0 of the product is the first group's weights summed.
    one = torch.zeros_like(x_q)
    one[0, :2] = 1
    got1 = i4.int4_matmul_a8(one, torch.ones_like(x_scale), packed, scales)
    want1 = (i4.unpack_values(packed[:1]).sum(dim=0).float() * scales[0]).to(torch.bfloat16)
    assert float(want1[0]) == float(-16 * scales[0, 0].to(torch.bfloat16))
    _within_one_ulp(got1[0], want1)


def test_torch_int4_a8_kernel_refuses_what_it_does_not_take(cuda):
    x_q = torch.zeros((4, 256), device=cuda, dtype=torch.int8)
    x_scale = torch.ones((4,), device=cuda)
    packed = torch.zeros((128, 256), device=cuda, dtype=torch.int8)
    scales = torch.ones((2, 256), device=cuda)
    with pytest.raises(ValueError, match="int8"):
        i4.int4_matmul_a8(x_q.to(torch.bfloat16), x_scale, packed, scales)
    with pytest.raises(ValueError, match="x_scale"):
        i4.int4_matmul_a8(x_q, x_scale[:3], packed, scales)
    with pytest.raises(ValueError, match="bf16"):
        i4.int4_matmul_a8(x_q, x_scale, packed, scales, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="warpgroups"):
        i4.int4_matmul_a8_on_width(x_q, x_scale, packed, scales, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_torch_quantizers_on_the_card_match_the_cpu(cuda, dtype):
    """Activation (and KV) codes and scales, int8 and int4 weight
    quantization: the card's results equal the CPU's (and so the JAX
    package's) to the bit."""
    from chatts_tpu_torch.models import quantize
    from chatts_tpu_torch.models.qwen import quantize_acts

    gen = torch.Generator().manual_seed(7)
    x = (torch.randn((512, 1024), generator=gen) * 3).to(dtype)
    for got, want in zip(quantize_acts(x.to(cuda)), quantize_acts(x)):
        assert torch.equal(got.cpu(), want)
    w = torch.randn((256, 384), generator=gen) / 10
    assert all(torch.equal(a.cpu(), b) for a, b in zip(i4.pack_int4(w.to(cuda)), i4.pack_int4(w)))
    q_gpu = quantize.quantize_dense(Dense(w.to(cuda)))
    q_cpu = quantize.quantize_dense(Dense(w))
    assert torch.equal(q_gpu.kernel_q.cpu(), q_cpu.kernel_q)
    assert torch.equal(q_gpu.scales.cpu(), q_cpu.scales)


@pytest.mark.parametrize("rows", [3, 40])
@pytest.mark.parametrize("act_int8", [False, True], ids=["weight_only", "act_int8"])
def test_torch_int8_dense_on_the_card(cuda, rows, act_int8):
    """An int8-weight projection (cuBLAS's f32-output bf16 GEMM, or the int8
    GEMM behind torch._int_mm with its rows padded past 16) against the same
    projection on the CPU."""
    gen = torch.Generator().manual_seed(rows)
    dense = Dense(kernel_q=torch.randint(-127, 128, (256, 384), generator=gen,
                                         dtype=torch.int8),
                  scales=torch.rand((384,), generator=gen) / 100,
                  bias=torch.randn((384,), generator=gen).to(torch.bfloat16))
    x = torch.randn((2, rows, 256), generator=gen).to(torch.bfloat16)
    want = dense(x, act_int8)
    got = dense.to(cuda)(x.to(cuda), act_int8)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (2, rows, 384)
    _within_one_ulp(got.cpu(), want,
                    0.0 if act_int8 else 1e-4 * float(want.float().abs().max()))


# ---------------------------------------------------------------------------
# The decoder glue (csrc/fused_glue.cu) against its eager composition in
# models/qwen.py, at the 14B and Qwen3-8B decode shapes (B = 32) and at
# R = 4,096 prefill rows.  Bit for bit where no reduction is reordered; a
# norm's sum of squares runs in another order, so a normed value may land one
# bf16 ulp off, in under 0.1% of the elements.
# ---------------------------------------------------------------------------

def _ordered(t):
    """bf16 bits as integers ordered like the values: one ulp apart is 1."""
    bits = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def _near_bits(got, want, share=1e-3):
    """Equal but for one bf16 ulp in under ``share`` of the elements."""
    ulps = (_ordered(got) - _ordered(want)).abs()
    assert int(ulps.max()) <= 1, int(ulps.max())
    assert float((ulps > 0).float().mean()) < share, float((ulps > 0).float().mean())


def _around_one(gen, n, dev):
    return (0.5 + torch.rand((n,), generator=gen, device=dev)).to(torch.bfloat16)


@pytest.mark.parametrize("r,h", [(32, 5120), (32, 4096), (4096, 5120), (4096, 4096)])
@pytest.mark.parametrize("add", [True, False], ids=["add", "norm_only"])
def test_torch_add_rms_norm_kernel_matches_eager(cuda, r, h, add):
    from chatts_tpu_torch.models.qwen import rms_norm
    from chatts_tpu_torch.ops import fused_glue as glue

    gen = torch.Generator(device=cuda).manual_seed(r + h)
    x = _bf16(gen, (r, h), cuda) * 4
    branch = _bf16(gen, (r, h), cuda) if add else None
    w = _around_one(gen, h, cuda)
    before = glue.add_rms_norm.launches
    resid, normed = glue.add_rms_norm(x, branch, w, 1e-6)
    torch.cuda.synchronize()
    assert glue.add_rms_norm.launches == before + 1
    want_resid = x + branch if add else x
    assert torch.equal(resid, want_resid)
    _near_bits(normed, rms_norm(want_resid, w, 1e-6))


@pytest.mark.parametrize("r,i", [(32, 13824), (32, 12288), (4096, 13824), (4096, 12288)])
@pytest.mark.parametrize("layout", ["gate_up", "apart"])
def test_torch_silu_mul_kernel_matches_eager(cuda, r, i, layout):
    import torch.nn.functional as F

    from chatts_tpu_torch.ops import fused_glue as glue

    gen = torch.Generator(device=cuda).manual_seed(r + i)
    gate_up = _bf16(gen, (r, 2 * i), cuda) * 4
    gate, up = gate_up.chunk(2, dim=-1)
    if layout == "apart":
        gate, up = gate.contiguous(), up.contiguous()
    got = glue.silu_mul(gate, up)
    torch.cuda.synchronize()
    assert got.is_contiguous() and torch.equal(got, F.silu(gate) * up)


QKV_SHAPES = {"14b": (40, 8, True, False), "qwen3_8b": (32, 8, False, True)}


@pytest.mark.parametrize("model", list(QKV_SHAPES))
@pytest.mark.parametrize("cache", ["int8", "bf16"])
def test_torch_qkv_decode_kernel_matches_eager(cuda, model, cache):
    """The decode step's qkv epilogue at B = 32, 256 positions a row:
    against ``Dense``'s bias add, ``rms_norm``, ``apply_rope``,
    ``_cache_values`` and ``_write_cache``.  The 14B's shape (bias, no
    norms) matches to the bit, codes and scales as ``quantize_kv`` makes
    them; with Qwen3's q/k norms a value may be one ulp off (an int8 code
    one step) in under 0.1% of the elements.  No position but each row's
    ``write_pos`` changes."""
    from chatts_tpu_torch.models import qwen
    from chatts_tpu_torch.ops import fused_glue as glue

    h, kvh, bias, norms = QKV_SHAPES[model]
    b, d, s = 32, 128, 256
    gen = torch.Generator(device=cuda).manual_seed(len(model) + len(cache))
    y = _bf16(gen, (b, (h + 2 * kvh) * d), cuda) * 3
    widths = [h * d, kvh * d, kvh * d]
    bvec = (_bf16(gen, ((h + 2 * kvh) * d,), cuda) * 0.1) if bias else None
    qn, kn = (_around_one(gen, d, cuda) for _ in range(2)) if norms else (None, None)
    pos = torch.randint(0, s, (b,), generator=gen, device=cuda, dtype=torch.int32)
    cos, sin = qwen.rope_cos_sin(pos[:, None], d, 1e6)
    if cache == "int8":
        base = [torch.randint(-127, 128, (b, kvh, s, d), generator=gen, device=cuda,
                              dtype=torch.int8) for _ in range(2)]
        base += [torch.rand((b, kvh, s), generator=gen, device=cuda) for _ in range(2)]
    else:
        base = [_bf16(gen, (b, kvh, s, d), cuda) for _ in range(2)]
    got_cache = [c.clone() for c in base]
    want_cache = [c.clone() for c in base]

    q_got = glue.qkv_decode(*y.split(widths, dim=-1),
                            [None] * 3 if bvec is None else bvec.split(widths), qn, kn, 1e-6,
                            cos.reshape(b, d), sin.reshape(b, d), pos, got_cache, h, kvh, d)
    torch.cuda.synchronize()

    yb = y if bvec is None else (y.float() + bvec.float()).to(torch.bfloat16)
    q, k, v = yb.split(widths, dim=-1)
    q, k, v = q.reshape(b, 1, h, d), k.reshape(b, 1, kvh, d), v.reshape(b, 1, kvh, d)
    if norms:
        q, k = qwen.rms_norm(q, qn, 1e-6), qwen.rms_norm(k, kn, 1e-6)
    q, k = qwen.apply_rope(q, cos, sin), qwen.apply_rope(k, cos, sin)
    values = qwen._cache_values(want_cache, k.transpose(1, 2), v.contiguous().transpose(1, 2))
    rows = torch.arange(b, device=cuda)[:, None, None]
    heads = torch.arange(kvh, device=cuda)[None, :, None]
    qwen._write_cache(want_cache, (rows, heads, pos.long()[:, None, None]), values)

    assert q_got.shape == (b, h, d) and q_got.is_contiguous()
    written = torch.zeros((b, kvh, s), dtype=torch.bool, device=cuda)
    written[rows[:, :, 0], heads[:, :, 0], pos.long()[:, None]] = True
    for got, want, old in zip(got_cache, want_cache, base):
        keep = ~written if got.dim() == 3 else ~written[..., None].expand_as(got)
        assert torch.equal(got[keep], old[keep])
    if not norms:
        assert torch.equal(q_got, q[:, 0])
        assert all(torch.equal(g, w) for g, w in zip(got_cache, want_cache))
        return
    _near_bits(q_got, q[:, 0])
    if cache == "bf16":
        for g, w in zip(got_cache, want_cache):
            _near_bits(g[written], w[written])
        return
    assert torch.equal(got_cache[1], want_cache[1]) and torch.equal(got_cache[3], want_cache[3])
    steps = (got_cache[0][written].int() - want_cache[0][written].int()).abs()
    assert int(steps.max()) <= 1 and float((steps > 0).float().mean()) < 1e-3
    ratio = got_cache[2][written] / want_cache[2][written]
    assert float((ratio - 1).abs().max()) <= 2 ** -7


def _steps_within_one(got, want, what):
    """int8 codes at most one step apart."""
    steps = (got.int() - want.int()).abs()
    assert int(steps.max()) <= 1, (what, int(steps.max()))


@pytest.mark.parametrize("model", ["14b", "qwen3_8b"])
def test_torch_fused_decode_step_in_a_cuda_graph(cuda, model):
    """Two layers at the model's widths (``chip_smoke.glue_model``: random
    int4 weights, norm weights and qkv biases away from 1 and 0), 32 slots
    at random lengths, 32 decode steps three ways: the fused step captured
    in a CUDA graph and replayed, the fused step run without a graph, and
    the step with the glue eager (the gate forced off).  The capture records
    4 fused glue calls a layer and the final norm, no eager one.  The graph
    replays to the fused step's tokens and caches bit for bit.  Against the
    eager glue (a norm's sum of squares in another order: one bf16 ulp here
    and there, carried through the layers) every step's logits agree to
    2e-2 of the row's largest while the tokens agree; the first layer's
    cache written until then holds int8 codes within one step, scales within
    2**-7 and bf16 values within one ulp, the second layer's head vectors
    agree to 2e-2 of their largest.  A near-tie may send the tokens apart:
    the steps after it are not compared."""
    import chip_smoke
    from chatts_tpu_torch.ops import fused_glue as glue
    from chatts_tpu_torch.runtime import kv_cache

    make = {"14b": chip_smoke.chatts_14b_config, "qwen3_8b": chip_smoke.qwen3_8b_config}[model]
    n_layers, b, s, n_steps = 2, 32, 1024, 32
    cfg = make(n_layers)
    llm = chip_smoke.glue_model(torch, cfg, cuda, 11).llm
    cache_dtype = torch.int8 if model == "14b" else torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(11)
    caches0 = kv_cache.allocate(cfg.llm, b, s, cache_dtype, cuda)
    for c in caches0:
        for t in c:
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=cuda))
            elif t.dtype == torch.float32:
                t.copy_(torch.rand(t.shape, generator=gen, device=cuda) / 20)
            else:
                t.copy_(_bf16(gen, t.shape, cuda))
    tokens0 = torch.randint(0, cfg.llm.vocab_size, (b,), generator=gen, device=cuda,
                            dtype=torch.int32)
    lens0 = torch.randint(1, s // 2, (b,), generator=gen, device=cuda, dtype=torch.int32)
    per_step = {"fused": 4 * n_layers + 1, "eager": 0}

    def state():
        return [tuple(t.clone() for t in c) for c in caches0], tokens0.clone(), lens0.clone()

    def step(caches, tokens, lens):
        positions = lens[:, None]
        hidden, _ = llm(llm.embed(tokens[:, None]), positions, kv_caches=caches,
                        write_pos=positions, kv_lengths=lens + 1)
        logits = llm.compute_logits(hidden)[:, 0]
        tokens.copy_(logits.argmax(dim=-1).to(torch.int32))
        lens.add_(1)
        return logits

    def run(caches, tokens, lens):
        logits, out = [], []
        for _ in range(n_steps):
            logits.append(step(caches, tokens, lens).clone())
            out.append(tokens.clone())
        return logits, out

    with torch.no_grad():
        caches_f, tokens_f, lens_f = state()
        before = glue.counts()
        step(*state())
        assert {k: v - before[k] for k, v in glue.counts().items()} == per_step
        logits_f, out_f = run(caches_f, tokens_f, lens_f)

        caches_g, tokens_g, lens_g = state()
        graph, captured = torch.cuda.CUDAGraph(), {}
        with torch.cuda.graph(graph):
            glue.counting(lambda: step(caches_g, tokens_g, lens_g), captured)()
        assert captured == per_step
        for c, c0 in zip(caches_g, caches0):
            for t, t0 in zip(c, c0):
                t.copy_(t0)
        tokens_g.copy_(tokens0)
        lens_g.copy_(lens0)
        out_g = []
        for _ in range(n_steps):
            graph.replay()
            out_g.append(tokens_g.clone())
        torch.cuda.synchronize()
        assert all(torch.equal(a, e) for a, e in zip(out_g, out_f))
        assert torch.equal(lens_g, lens_f)
        for cg, cf in zip(caches_g, caches_f):
            assert all(torch.equal(a, e) for a, e in zip(cg, cf))

        caches_e, tokens_e, lens_e = state()
        engaged = glue.engaged
        glue.engaged = lambda *a: False
        try:
            before = glue.counts()
            logits_e, out_e = run(caches_e, tokens_e, lens_e)
            assert glue.counts()["eager"] - before["eager"] == n_steps * per_step["fused"]
        finally:
            glue.engaged = engaged

    apart = next((i for i in range(n_steps) if not torch.equal(out_f[i], out_e[i])), n_steps)
    print(f"{model}: the eager glue's tokens agree for {apart} of {n_steps} steps")
    for i in range(min(apart + 1, n_steps)):
        _close_rows(logits_f[i], logits_e[i])
    # Positions written from the same tokens: step i writes lens0 + i from
    # the token step i - 1 chose.  Layer 0's K/V hold the glue's own
    # roundings only; a later layer's also carry the earlier layers' (a norm
    # one ulp off moves every projection after it), so its head vectors are
    # held, dequantized, to 2e-2 of each vector's largest value.
    pos = torch.arange(s, device=cuda)[None, :]
    same = (pos < (lens0 + min(apart + 1, n_steps))[:, None])[:, None, :]  # (B, 1, S)
    for layer, (cf, ce) in enumerate(zip(caches_f, caches_e)):
        mask = same.expand(cf[0].shape[:3])
        what = f"{model} layer {layer}"
        if layer:
            if cache_dtype == torch.int8:
                for codes, scales in ((0, 2), (1, 3)):
                    _close_rows(cf[codes][mask].float() * cf[scales][mask][:, None],
                                ce[codes][mask].float() * ce[scales][mask][:, None])
            else:
                for f, e in zip(cf, ce):
                    _close_rows(f[mask], e[mask])
            continue
        for j, (f, e) in enumerate(zip(cf, ce)):
            if f.dtype == torch.int8:
                _steps_within_one(f[mask], e[mask], f"{what} cache {j}")
            elif f.dtype == torch.float32:
                assert bool(((f[mask] - e[mask]).abs() <= 2 ** -7 * e[mask].abs()).all()), what
            else:
                ulps = (_ordered(f[mask]) - _ordered(e[mask])).abs()
                assert int(ulps.max()) <= 1, (what, j, int(ulps.max()))


# ---------------------------------------------------------------------------
# Moonlight-16B-A3B's kernels (multi-head latent attention, routed experts),
# at its published shapes: 16 heads over a 576-wide latent row (c_kv 512,
# rope 64), qk 192 / v 128 in prefill, 64 experts of 1,408 at hidden 2,048,
# top 6.  Each is held to its plain version on the card, row by row, to
# 2e-2 of the row's largest output: the kernels round q_lat, p and o to
# bf16 where the plain versions round them at other points (p against the
# row's max, not the running one), and the int4 products sum in another
# order within a group.
# ---------------------------------------------------------------------------

def _mla_inputs(cuda, r, b, s, seed):
    from chatts_tpu_torch.ops import mla

    gen = torch.Generator(device=cuda).manual_seed(seed)
    cache = _bf16(gen, (b, 1, s, mla.LATENT + mla.ROPE), cuda)
    w_uk = (_bf16(gen, (mla.HEADS, mla.NOPE, mla.LATENT), cuda).float() / 12).to(torch.bfloat16)
    w_uv = (_bf16(gen, (mla.HEADS, mla.LATENT, mla.V), cuda).float() / 23).to(torch.bfloat16)
    q_nope = _bf16(gen, (r, mla.HEADS, mla.NOPE), cuda)
    q_pe = _bf16(gen, (r, mla.HEADS, mla.ROPE), cuda)
    return gen, cache, w_uk, w_uv, q_nope, q_pe


@pytest.mark.parametrize("case", ["decode", "mixed"])
def test_torch_mla_decode_kernel_matches_plain(cuda, case):
    """``decode``: 128 rows over a capacity of 8,192 at lengths 0 to 8,192
    (0, 1, 127, 128, 129 and 8,192 among them).  ``mixed``: the serving
    engine's mixed step, 32 decode rows and 4 admission rows of 48 prompt
    tokens, each prompt token a query over its slot's first p + 1
    positions, several queries a slot."""
    from chatts_tpu_torch.ops import mla

    if case == "decode":
        r, b, s = 128, 128, 8192
        gen, cache, w_uk, w_uv, q_nope, q_pe = _mla_inputs(cuda, r, b, s, 21)
        rows = torch.arange(r, device=cuda, dtype=torch.int32)
        lengths = torch.randint(0, s + 1, (r,), generator=gen, device=cuda, dtype=torch.int32)
        lengths[:6] = torch.tensor([0, 1, 127, 128, 129, s], device=cuda)
    else:
        b, s, a, npt = 32, 2048, 4, 48
        r = b + a * npt
        gen, cache, w_uk, w_uv, q_nope, q_pe = _mla_inputs(cuda, r, b, s, 22)
        slots = torch.tensor([3, 9, 17, 30], device=cuda, dtype=torch.int32)
        pos = 700 + torch.arange(npt, device=cuda, dtype=torch.int32)
        rows = torch.cat([torch.arange(b, device=cuda, dtype=torch.int32),
                          slots.repeat_interleave(npt)])
        lengths = torch.cat([torch.randint(1, s, (b,), generator=gen, device=cuda,
                                           dtype=torch.int32), (pos + 1).repeat(a)])
    scale = 192 ** -0.5
    got = mla.mla_decode(q_nope, q_pe, w_uk, w_uv, cache, rows, lengths, scale=scale)
    want = mla.mla_decode_reference(q_nope, q_pe, w_uk, w_uv, cache, rows, lengths, scale)
    assert got.shape == (r, mla.HEADS, mla.V) and mla.mla_decode.launches > 0
    live = lengths > 0
    assert (got[~live] == 0).all()
    _close_rows(got[live].reshape(-1, mla.V), want[live].reshape(-1, mla.V))


@pytest.mark.parametrize("t", [37, 300, 1024])
def test_torch_mla_prefill_kernel_matches_plain(cuda, t):
    """B1's qk 192 / v 128 instance: two rows, the second valid below T / 2,
    16 heads, both query tiles (T 37 takes 64 rows, the others 128)."""
    from chatts_tpu_torch.ops import mla

    gen = torch.Generator(device=cuda).manual_seed(t)
    b, h = 2, 16
    q = _bf16(gen, (b, t, h, 192), cuda)
    k = _bf16(gen, (b, t, h, 192), cuda)
    v = _bf16(gen, (b, t, h, 128), cuda)
    pos = torch.arange(t, device=cuda, dtype=torch.int32)[None].repeat(b, 1).contiguous()
    valid = pos < torch.tensor([[t], [t // 2]], device=cuda)
    kw = dict(q_positions=pos, kv_positions=pos, kv_valid=valid, scale=192 ** -0.5)
    got = mla.mla_prefill(q, k, v, **kw)
    want = mla.mla_prefill_reference(q, k, v, **kw)
    _close_rows(got.reshape(-1, 128), want.reshape(-1, 128))


def _moe_weights(cuda, e, hid, inter, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def packed(fan_in, fan_out):
        k = torch.randint(0, 225, (e, fan_in // 2, fan_out), generator=gen, device=cuda)
        lo, hi = (k % 15 + 9) & 15, (k // 15 + 9) & 15
        codes = (lo | (hi << 4)).to(torch.uint8).view(torch.int8)
        scales = (0.5 + torch.rand((e, fan_in // 128, fan_out), generator=gen, device=cuda)) / (
            7 * math.sqrt(fan_in))
        return codes, scales

    return gen, packed(hid, 2 * inter), packed(inter, hid)


@pytest.mark.parametrize("t", [128, 300, 1024, 1877, 1878, 4096])
def test_torch_moe_int4_kernel_matches_plain(cuda, t):
    """64 experts of 1,408 at hidden 2,048, top 6, uneven loads: expert 0 in
    nearly every token's choice, expert 5 in none; T 128, 300 and 1,024 take
    the 16-, 32- and 64-row tiles; the routing reads its ids from shared
    memory up to 11,264 pairs (T 1,877) and from global memory above (T
    1,878 and 4,096).  The counter gains each expert's rows exactly."""
    from chatts_tpu_torch.ops import moe_int4
    from chatts_tpu_torch.ops.int4_matmul import int4_matmul_grouped_reference

    e, hid, inter, k = 64, 2048, 1408, 6
    gen, (gu_q, gu_s), (d_q, d_s) = _moe_weights(cuda, e, hid, inter, t)
    weights = torch.ones((e,), device=cuda)
    weights[0], weights[5] = 400.0, 0.0
    idx = torch.multinomial(weights.expand(t, e), k, replacement=False,
                            generator=gen).to(torch.int32)
    w = torch.rand((t, k), generator=gen, device=cuda)
    x = _bf16(gen, (t, hid), cuda)
    counts = torch.full((e,), 7, dtype=torch.int32, device=cuda)
    got = moe_int4.moe_int4(x, idx, w, gu_q, gu_s, d_q, d_s, counts=counts)
    want = moe_int4.moe_int4_reference(x, idx, w, gu_q, gu_s, d_q, d_s,
                                       matmul=int4_matmul_grouped_reference)
    assert moe_int4.rows_per_tile(t, k, e) == (16 if t == 128 else 32 if t == 300 else 64)
    assert torch.equal(counts - 7, torch.bincount(idx.long().flatten(), minlength=e).int())
    assert int(counts[5]) == 7 and int(counts[0]) > t * 0.8
    _close_rows(got, want)


def test_torch_moonlight_decode_step_in_a_cuda_graph(cuda):
    """Two layers of Moonlight-16B-A3B at its published widths (dense layer
    0 and an expert layer, int4 throughout, q with kv_a fused), 128 slots of
    the latent cache at random lengths, 4 decode steps: the step captured in
    a CUDA graph and replayed gives the eager step's logits, tokens and
    latent cache bit for bit."""
    import dataclasses

    from chatts_tpu_torch.core.config import MoonlightConfig
    from chatts_tpu_torch.models import moonlight
    from chatts_tpu_torch.runtime import kv_cache

    cfg = dataclasses.replace(MoonlightConfig(), num_hidden_layers=2)
    b, s, n_steps = 128, 1024, 4
    gen = torch.Generator(device=cuda).manual_seed(31)
    with torch.no_grad():
        llm = moonlight.init_params(cfg, gen, cuda, torch.bfloat16, int4=True)
        caches0 = kv_cache.allocate(cfg, b, s, torch.bfloat16, cuda)
        for c in caches0:
            c[0].copy_(_bf16(gen, c[0].shape, cuda))
        tokens0 = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=cuda,
                                dtype=torch.int32)
        lens0 = torch.randint(1, s - n_steps, (b,), generator=gen, device=cuda,
                              dtype=torch.int32)

        def state():
            return [tuple(t.clone() for t in c) for c in caches0], tokens0.clone(), lens0.clone()

        def step(caches, tokens, lens, out):
            positions = lens[:, None]
            hidden, _ = llm(llm.embed(tokens[:, None]), positions, kv_caches=caches,
                            write_pos=positions, kv_lengths=lens + 1)
            logits = llm.compute_logits(hidden)[:, 0]
            out.copy_(logits)
            tokens.copy_(logits.argmax(dim=-1).to(torch.int32))
            lens.add_(1)

        caches_e, tokens_e, lens_e = state()
        out_e = torch.empty((b, cfg.vocab_size), device=cuda)
        eager = []
        for _ in range(n_steps):
            step(caches_e, tokens_e, lens_e, out_e)
            eager.append((out_e.clone(), tokens_e.clone()))

        caches_g, tokens_g, lens_g = state()
        out_g = torch.empty_like(out_e)
        step(*state(), out_g)  # warm-up on a copy
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step(caches_g, tokens_g, lens_g, out_g)
        for c, c0 in zip(caches_g, caches0):
            c[0].copy_(c0[0])
        tokens_g.copy_(tokens0)
        lens_g.copy_(lens0)
        for i in range(n_steps):
            graph.replay()
            assert torch.equal(out_g, eager[i][0]) and torch.equal(tokens_g, eager[i][1]), i
        torch.cuda.synchronize()
        assert torch.equal(lens_g, lens_e)
        for cg, ce in zip(caches_g, caches_e):
            assert torch.equal(cg[0], ce[0])
