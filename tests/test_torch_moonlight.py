"""The DeepSeek-V3 decoder block (``models/moonlight.py``, Moonlight-16B-A3B's
architecture) on the CPU, at a tiny size, against the plain f32 reference
``tests/moonlight_reference.py``:

- the reference against ``transformers``' ``DeepseekV3ForCausalLM`` built
  tiny and random in-process (no q LoRA, one dense layer first, top-2 of 4
  experts, a shared expert, ``noaux_tc`` with a random correction bias,
  ``norm_topk_prob``): logits within 1e-4 (rtol and atol), f32 on both
  sides;
- the port's model on its plain paths: a prompt's prefill into the latent
  cache, then cached decode steps, against the reference's full forward of
  the whole sequence, within ``TOL`` (f32; the decode attends absorbed,
  whose sums differ from the un-absorbed ones in rounding only);
- ``ServeEngine`` on a tiny f32 ChatTS with this decoder, through the block
  and the scan-sliced admission routes: greedy tokens equal the
  reference's, the prompt's embeddings (the TS encoder merged in) taken
  from the model;
- each kernel's plain version against the equations: ``mla_decode`` at
  ragged lengths (0, 1, a full cache, rows sharing a slot) against the
  un-absorbed attention, ``mla_prefill`` against its masked softmax, and
  ``moe_int4`` at uneven expert loads (one expert empty, one taking most
  rows) against a per-token loop, with its counter;
- the latent cache's allocation and byte count.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chatts_tpu_torch.core.config import (ChatTSConfig, MoonlightConfig, TSEncoderConfig,
                                          decoder_config_from_hf_dict)
from chatts_tpu_torch.models import moonlight
from chatts_tpu_torch.models.chatts import ChatTSModel
from chatts_tpu_torch.models.ts_encoder import TSEncoder
from chatts_tpu_torch.ops import mla, moe_int4
from chatts_tpu_torch.ops.int4_matmul import dequantize
from chatts_tpu_torch.processor.processor import ChatTSProcessor
from chatts_tpu_torch.runtime import kv_cache
from chatts_tpu_torch.serve.scheduler import Request, SamplingParams, ServeEngine
from tests import moonlight_reference as ref
from tests.helpers import FakeTokenizer

TOL = 1e-4

TINY = MoonlightConfig(
    vocab_size=512, hidden_size=128, intermediate_size=256, moe_intermediate_size=128,
    num_hidden_layers=3, num_attention_heads=2, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=4, n_shared_experts=1,
    num_experts_per_tok=2, first_k_dense_replace=1, routed_scaling_factor=2.446,
    rms_norm_eps=1e-5, rope_theta=50000.0, max_position_embeddings=512, dtype="float32")


def ref_config(cfg: MoonlightConfig) -> dict:
    return dataclasses.asdict(cfg)


def port_model(seed: int = 0) -> moonlight.MoonlightModel:
    return moonlight.init_params(TINY, torch.Generator().manual_seed(seed), "cpu")


def ref_weights(llm: moonlight.MoonlightModel) -> dict:
    """The port model's weights as the reference takes them: float, (in,
    out), the int4 experts dequantized."""
    def w(d):
        return moonlight.dense_weight(d)

    def gate_up(m):
        if m.gate_up_proj is None:
            return w(m.gate_proj), w(m.up_proj)
        return w(m.gate_up_proj).chunk(2, dim=1)

    layers = []
    for layer in llm.layers:
        at, ff = layer.self_attn, layer.mlp
        nq = at.num_heads * llm.cfg.qk_head_dim
        if at.q_kv_a_proj is not None:
            fused = w(at.q_kv_a_proj)
            q, kv_a = fused[:, :nq], fused[:, nq:nq + llm.cfg.latent_dim]
        else:
            q, kv_a = w(at.q_proj), w(at.kv_a_proj)
        lw = dict(ln1=layer.input_layernorm.float(), ln2=layer.post_attention_layernorm.float(),
                  q=q, kv_a=kv_a, kv_a_norm=at.kv_a_norm.float(),
                  kv_b=w(at.kv_b_proj), o=w(at.o_proj))
        if isinstance(ff, moonlight.MoE):
            inter = ff.down_q4.shape[1] * 2
            gu = torch.stack([dequantize(q, s) for q, s in zip(ff.gate_up_q4, ff.gate_up_s4)])
            sg, su = gate_up(ff.shared)
            lw.update(router=ff.router, bias=ff.router_bias, experts_gate=gu[..., :inter],
                      experts_up=gu[..., inter:],
                      experts_down=torch.stack([dequantize(q, s)
                                                for q, s in zip(ff.down_q4, ff.down_s4)]),
                      shared_gate=sg, shared_up=su, shared_down=w(ff.shared.down_proj))
        else:
            g, u = gate_up(ff)
            lw.update(gate=g, up=u, down=w(ff.down_proj))
        layers.append(lw)
    head = llm.lm_head.float() if llm.lm_head_q is None else w(llm.lm_head_q)
    return dict(embed=llm.embed_tokens.float(), norm=llm.norm.float(), head=head, layers=layers)


# ---------------------------------------------------------------------------
# The reference against transformers
# ---------------------------------------------------------------------------

def test_torch_moonlight_reference_matches_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.DeepseekV3Config(
        vocab_size=256, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4, n_shared_experts=1,
        n_routed_experts=4, num_experts_per_tok=2, routed_scaling_factor=2.446,
        kv_lora_rank=16, q_lora_rank=None, qk_rope_head_dim=8, qk_nope_head_dim=16,
        v_head_dim=12, n_group=1, topk_group=1, first_k_dense_replace=1, norm_topk_prob=True,
        max_position_embeddings=128, rope_theta=50000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=False, attn_implementation="eager")
    torch.manual_seed(0)
    model = transformers.DeepseekV3ForCausalLM(hf_cfg).float().eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.randn_like(p) * (0.3 if p.dim() > 1 else 0.1)
                    + (1.0 if "norm" in name else 0.0))
        for layer in model.model.layers[1:]:
            layer.mlp.gate.e_score_correction_bias.copy_(0.1 * torch.randn(4))
    sd = {k: v.float() for k, v in model.state_dict().items()}
    cfg = dataclasses.asdict(decoder_config_from_hf_dict(hf_cfg.to_dict()))

    def t(name):
        return sd[name].t()

    layers = []
    for i in range(3):
        p = f"model.layers.{i}."
        lw = dict(ln1=sd[p + "input_layernorm.weight"],
                  ln2=sd[p + "post_attention_layernorm.weight"],
                  q=t(p + "self_attn.q_proj.weight"),
                  kv_a=t(p + "self_attn.kv_a_proj_with_mqa.weight"),
                  kv_a_norm=sd[p + "self_attn.kv_a_layernorm.weight"],
                  kv_b=t(p + "self_attn.kv_b_proj.weight"), o=t(p + "self_attn.o_proj.weight"))
        if i == 0:
            lw.update(gate=t(p + "mlp.gate_proj.weight"), up=t(p + "mlp.up_proj.weight"),
                      down=t(p + "mlp.down_proj.weight"))
        else:
            e = p + "mlp.experts."
            lw.update(router=t(p + "mlp.gate.weight"),
                      bias=sd[p + "mlp.gate.e_score_correction_bias"],
                      experts_gate=torch.stack([t(f"{e}{j}.gate_proj.weight") for j in range(4)]),
                      experts_up=torch.stack([t(f"{e}{j}.up_proj.weight") for j in range(4)]),
                      experts_down=torch.stack([t(f"{e}{j}.down_proj.weight") for j in range(4)]),
                      shared_gate=t(p + "mlp.shared_experts.gate_proj.weight"),
                      shared_up=t(p + "mlp.shared_experts.up_proj.weight"),
                      shared_down=t(p + "mlp.shared_experts.down_proj.weight"))
        layers.append(lw)
    w = dict(embed=sd["model.embed_tokens.weight"], norm=sd["model.norm.weight"],
             head=t("lm_head.weight"), layers=layers)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256, size=(1, 20)))
    with torch.no_grad():
        want = model(ids).logits[0]
    got = ref.forward(cfg, w, ids[0])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_torch_moonlight_config_from_hf_dict():
    d = dict(model_type="deepseek_v3", vocab_size=163840, hidden_size=2048,
             intermediate_size=11264, moe_intermediate_size=1408, num_hidden_layers=27,
             num_attention_heads=16, kv_lora_rank=512, q_lora_rank=None, qk_nope_head_dim=128,
             qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=64, n_shared_experts=2,
             num_experts_per_tok=6, first_k_dense_replace=1, routed_scaling_factor=2.446,
             norm_topk_prob=True, n_group=1, topk_group=1, rms_norm_eps=1e-5,
             rope_theta=50000.0, max_position_embeddings=8192, ts=dict(patch_size=16,
             num_layers=5, hidden_size=2048), ts_token_start_index=163800)
    cfg = ChatTSConfig.from_hf_dict(d)
    assert cfg.llm == MoonlightConfig()
    assert cfg.llm.qk_head_dim == 192 and cfg.llm.latent_dim == 576 and cfg.llm.head_dim == 64
    for bad in (dict(q_lora_rank=1536), dict(n_group=8), dict(rope_scaling={"factor": 2})):
        with pytest.raises(NotImplementedError):
            ChatTSConfig.from_hf_dict({**d, **bad})


# ---------------------------------------------------------------------------
# The port's model against the reference
# ---------------------------------------------------------------------------

def test_torch_moonlight_prefill_then_decode_matches_reference():
    llm = port_model()
    w = ref_weights(llm)
    t, steps = 11, 4
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, TINY.vocab_size, size=t + steps))
    caches = kv_cache.allocate(TINY, 1, 64, torch.float32, "cpu", kv_heads=llm.kv_heads)
    assert len(caches[0]) == 1 and caches[0][0].shape == (1, 1, 64, TINY.latent_dim)
    pos = torch.arange(t)[None]
    with torch.no_grad():
        hidden, _ = llm(llm.embed(ids[None, :t]), pos, kv_caches=caches,
                        kv_valid=torch.ones((1, t), dtype=torch.bool), kv_positions=pos)
        got = [llm.compute_logits(hidden)[0]]
        for i in range(steps):
            p = torch.tensor([[t + i]])
            hidden, _ = llm(llm.embed(ids[None, t + i:t + i + 1]), p, kv_caches=caches,
                            write_pos=p, kv_lengths=torch.tensor([t + i + 1]))
            got.append(llm.compute_logits(hidden)[0])
    want = ref.forward(ref_config(TINY), w, ids)
    np.testing.assert_allclose(torch.cat(got).numpy(), want[:t + steps].numpy(),
                               rtol=TOL, atol=TOL)
    counts = llm.expert_tokens
    assert counts.shape == (TINY.num_hidden_layers, TINY.n_routed_experts)
    assert counts[0].sum() == 0
    assert (counts[1:].sum(dim=1) == (t + steps) * TINY.num_experts_per_tok).all()


def test_torch_moonlight_int4_fused_matches_reference():
    """Every projection and the head in int4, q with kv_a and gate with up
    fused (the serving layout, kv_a's 576 columns padded to 640 beside q):
    the same logits as the reference given the same int4 values."""
    cfg = dataclasses.replace(TINY, kv_lora_rank=128, v_head_dim=64)  # int4 inputs: 128s
    llm = moonlight.init_params(cfg, torch.Generator().manual_seed(2), "cpu", int4=True)
    at = llm.layers[1].self_attn
    assert at.q_proj is None and at.q_kv_a_proj.out_features % 128 == 0
    w = ref_weights(llm)
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, TINY.vocab_size, size=9))
    with torch.no_grad():
        hidden, _ = llm(llm.embed(ids[None]), torch.arange(9)[None])
    np.testing.assert_allclose(llm.compute_logits(hidden)[0].numpy(),
                               ref.forward(ref_config(cfg), w, ids).numpy(), rtol=TOL, atol=TOL)


def test_torch_moonlight_chunk_matches_reference():
    """A prefill chunk at write_pos attends its cache prefix through kv_b."""
    llm = port_model(1)
    w = ref_weights(llm)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, TINY.vocab_size, size=14))
    caches = kv_cache.allocate(TINY, 1, 32, torch.float32, "cpu")
    kv_pos = torch.arange(32, dtype=torch.int32)[None]
    with torch.no_grad():
        pos = torch.arange(6)[None]
        llm(llm.embed(ids[None, :6]), pos, kv_caches=caches,
            kv_valid=torch.ones((1, 6), dtype=torch.bool), kv_positions=pos)
        pos = torch.arange(6, 14)[None]
        hidden, _ = llm(llm.embed(ids[None, 6:]), pos, kv_caches=caches, write_pos=pos,
                        kv_valid=kv_pos < 14, kv_positions=kv_pos, kv_limit=16)
    want = ref.forward(ref_config(TINY), w, ids)
    np.testing.assert_allclose(llm.compute_logits(hidden)[0].numpy(), want[6:].numpy(),
                               rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# ServeEngine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    cfg = ChatTSConfig(llm=TINY, ts=TSEncoderConfig(patch_size=4, num_layers=2, hidden_size=128,
                                                     max_sequence_length=64),
                       ts_token_start_index=500)
    gen = torch.Generator().manual_seed(7)
    encoder = TSEncoder(cfg.ts).reset_parameters(gen)
    model = ChatTSModel(cfg, encoder, moonlight.init_params(TINY, gen, "cpu"))
    proc = ChatTSProcessor(FakeTokenizer(vocab_limit=200), cfg)
    return cfg, model, proc


def _reference_greedy(cfg, model, proc, prompt, series, n):
    b = proc([prompt], series)
    with torch.no_grad():
        embeds = model.input_embeddings(
            torch.from_numpy(b.input_ids), torch.from_numpy(b.ts_values),
            torch.from_numpy(b.ts_mask), torch.from_numpy(b.scatter_seq),
            torch.from_numpy(b.scatter_tok))[0, :int(b.seq_lens[0])]
    w = ref_weights(model.llm)
    out = []
    for _ in range(n):
        nxt = int(ref.forward(ref_config(cfg.llm), w, embeds=embeds)[-1].argmax())
        out.append(nxt)
        embeds = torch.cat([embeds, w["embed"][nxt][None]])
    return out


def _wait(reqs, timeout=120.0):
    deadline = time.time() + timeout
    while any(r.finished_s is None and r.error is None for r in reqs):
        assert time.time() < deadline, "requests did not finish"
        time.sleep(0.002)


@pytest.mark.parametrize("route", ["block", "mixed"])
def test_torch_moonlight_serve_engine_matches_reference(served, route):
    """A runner decodes while a second request is admitted, by a block round
    or by scan-sliced rounds (``block_token_budget`` 0); both get the
    reference's greedy tokens, and the expert counter reaches ``stats``."""
    cfg, model, proc = served
    p1, t1 = "first runner <ts><ts/> keeps decoding", [np.arange(12.0)]
    p2, t2 = "second arrives <ts><ts/> mid decode of the first", [np.sin(np.arange(8.0))]
    with ServeEngine(model, cfg, proc, device="cpu", max_batch_size=4, max_model_len=128,
                     cache_dtype=torch.float32, decode_chunk=4) as eng:
        if route == "mixed":
            eng.block_token_budget = 0
        r1 = eng.submit(Request(p1, t1, SamplingParams(max_tokens=12, temperature=0.0)))
        deadline = time.time() + 60
        while not r1.output_tokens:
            assert r1.error is None and time.time() < deadline
            time.sleep(0.001)
        r2 = eng.submit(Request(p2, t2, SamplingParams(max_tokens=6, temperature=0.0)))
        _wait([r1, r2])
        stats = eng.stats()
    assert r1.error is None and r2.error is None
    assert stats["admissions"].get(route, 0) >= 1, stats["admissions"]
    assert r1.output_tokens == _reference_greedy(cfg, model, proc, p1, t1, 12)
    assert r2.output_tokens == _reference_greedy(cfg, model, proc, p2, t2, 6)
    experts = np.asarray(stats["expert_tokens"])
    assert experts.shape == (TINY.num_hidden_layers, TINY.n_routed_experts)
    assert experts[1:].sum() > 0 and experts[0].sum() == 0


# ---------------------------------------------------------------------------
# The kernels' plain versions against the equations
# ---------------------------------------------------------------------------

def test_torch_mla_decode_plain_matches_unabsorbed():
    g = torch.Generator().manual_seed(5)
    h, nope, rp, lat, vd, s = 4, 16, 8, 32, 16, 24
    cache = torch.randn((3, 1, s, lat + rp), generator=g)
    w_kb = torch.randn((lat, h, nope + vd), generator=g) / lat ** 0.5
    w_uk = w_kb[..., :nope].permute(1, 2, 0).contiguous()
    w_uv = w_kb[..., nope:].transpose(0, 1).contiguous()
    rows = torch.tensor([0, 1, 2, 2, 1], dtype=torch.int32)
    lengths = torch.tensor([0, 1, s, 7, 13], dtype=torch.int32)
    q_nope = torch.randn((5, h, nope), generator=g)
    q_pe = torch.randn((5, h, rp), generator=g)
    scale = (nope + rp) ** -0.5
    got = mla.mla_decode(q_nope, q_pe, w_uk, w_uv, cache, rows, lengths, scale=scale)
    assert got.shape == (5, h, vd)
    for r in range(5):
        n = int(lengths[r])
        if n == 0:
            assert (got[r] == 0).all()
            continue
        c = cache[int(rows[r]), 0, :n]
        kv = torch.einsum("sl,lhd->shd", c[:, :lat], w_kb)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        sc = (torch.einsum("hd,shd->hs", q_nope[r], k_nope)
              + torch.einsum("hd,sd->hs", q_pe[r], c[:, lat:])) * scale
        want = torch.einsum("hs,shd->hd", sc.softmax(dim=-1), v)
        np.testing.assert_allclose(got[r].numpy(), want.numpy(), rtol=TOL, atol=TOL)


def test_torch_mla_split_plan_covers_the_cache():
    for s, r in ((64, 1), (8192, 128), (8192, 512), (1000, 3)):
        splits, chunk = mla.split_plan(s, r)
        assert chunk % mla.KEY_TILE == 0 and splits * chunk >= s > (splits - 1) * chunk
        assert splits <= mla.MAX_SPLITS


def test_torch_mla_prefill_plain_matches_softmax():
    g = torch.Generator().manual_seed(6)
    b, t, h = 2, 9, 3
    q, k = torch.randn((b, t, h, 24), generator=g), torch.randn((b, t, h, 24), generator=g)
    v = torch.randn((b, t, h, 16), generator=g)
    pos = torch.arange(t, dtype=torch.int32)[None].repeat(b, 1)
    valid = pos < torch.tensor([[t], [5]])
    got = mla.mla_prefill(q, k, v, q_positions=pos, kv_positions=pos, kv_valid=valid)
    for bi, n in ((0, t), (1, 5)):
        sc = torch.einsum("thd,shd->hts", q[bi], k[bi, :n]) * 24 ** -0.5
        sc = sc.masked_fill(torch.arange(n)[None, :] > torch.arange(t)[:, None], float("-inf"))
        want = torch.einsum("hts,shd->thd", sc.softmax(dim=-1), v[bi, :n])
        np.testing.assert_allclose(got[bi].numpy(), want.numpy(), rtol=TOL, atol=TOL)


def test_torch_moe_int4_plain_uneven_loads_match_loop():
    """Four experts, two choices a token: expert 2 takes no row, expert 0
    most rows; one choice falls outside the held range and adds nothing."""
    g = torch.Generator().manual_seed(8)
    t, hid, inter, e = 10, 128, 128, 4
    layer = moonlight.init_params(dataclasses.replace(TINY, num_hidden_layers=2),
                                  g, "cpu").layers[1].mlp
    x = torch.randn((t, hid), generator=g)
    idx = torch.tensor([[0, 1]] * 6 + [[0, 3]] * 3 + [[3, 7]], dtype=torch.int32)
    w = torch.rand((t, 2), generator=g)
    counts = torch.zeros((e,), dtype=torch.int32)
    got = moe_int4.moe_int4(x, idx, w, layer.gate_up_q4, layer.gate_up_s4, layer.down_q4,
                            layer.down_s4, counts=counts)
    assert counts.tolist() == [9, 6, 0, 4]
    for i in range(t):
        want = torch.zeros(hid)
        for j in range(2):
            ex = int(idx[i, j])
            if ex >= e:
                continue
            gu = x[i] @ dequantize(layer.gate_up_q4[ex], layer.gate_up_s4[ex])
            act = F.silu(gu[:inter]) * gu[inter:]
            want += w[i, j] * (act @ dequantize(layer.down_q4[ex], layer.down_s4[ex]))
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), rtol=TOL, atol=TOL)


def test_torch_latent_cache_layout_and_bytes():
    cfg = MoonlightConfig()
    assert kv_cache.cache_bytes(cfg, 128, 8192) == 128 * 8192 * 27 * 1152
    caches = kv_cache.allocate(dataclasses.replace(cfg, num_hidden_layers=2), 3, 16,
                               torch.bfloat16, "cpu")
    assert [tuple(c[0].shape) for c in caches] == [(3, 1, 16, 576)] * 2
    with pytest.raises(NotImplementedError):
        kv_cache.allocate(cfg, 1, 16, torch.int8, "cpu")


def test_torch_moonlight_mixed_bound_reads_each_prefix_once():
    """The benchmark's bound of a scan-sliced round's ``mla_decode``: every
    (query, position) pair's operations, but a prompt's rows share its
    slot's prefix, so its bytes are its longest row's positions, once."""
    import os
    import types

    from port_bench import flops
    from port_bench.cells import Bench

    fam = Bench(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))).family("moonlight")
    npt, o, cap = 4, 8, 64
    engine = types.SimpleNamespace(
        _pending_mixed={"embeds": torch.zeros(2, 1), "npt": npt, "o": o,
                        "reqs": [types.SimpleNamespace(prompt_tokens=10)]},
        _active_device=lambda: torch.tensor([True, False]), budget=torch.tensor([5, 5]),
        cur_lens=torch.tensor([30, 7]), decode_chunk=2, max_model_len=cap)
    got = fam.mixed_launches({"num_hidden_layers": 3}, engine)
    assert [(k, n) for k, n, _ in got] == [("mla_decode", 3)] * 2
    row = 16 * (576 + 128) * 2
    factors = 2 * 16 * 128 * 512 * 2
    for s, (_, _, bound) in enumerate(got):
        start = o + s * npt
        dec = [30 + s + 1, 1]  # the live slot, then the idle one
        pro = [min(start + j + 1, 10) for j in range(npt)] + [0] * npt  # the pad row
        read = sum(dec) + min(start + npt, 10)
        pos = sum(dec) + sum(pro)
        ops = 2.0 * 16 * (2 * 512 + 64) * pos + 2 * 2.0 * 16 * 128 * 512 * 10
        want = flops.bound_s(read * 1152 + 10 * row + factors, ops)
        assert bound == pytest.approx(3 * want, rel=1e-12)
        assert bound < 3 * fam.mla_decode_bound_s(dec + pro, cap)
