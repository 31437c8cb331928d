"""The Moonlight family: ChatTS on the DeepSeek-V3 decoder block at
Moonlight-16B-A3B's widths (``model_type`` ``deepseek_v3``): multi-head
latent attention (MLA) over a latent cache, 64 routed experts of which each
token takes 6, 2 shared experts, layer 0 dense; int4 projections, experts and
head.

Its weights (``make``), the port's model built from them (``port_model``),
the plain float32 reference with its float8 control (``logits``), the FLOPs
of a request (``request_flops``), and the port's kernels with their bounds
(``KERNELS``, ``spies``, ``mixed_launches``): ``int4_matmul`` (B3) for the
attention projections, layer 0's MLP, the shared experts and the head;
``mla_decode`` (absorbed decode over the latent rows; the mixed step's
prompt tokens too); ``mla_prefill`` (B1 at qk 192 / v 128); ``moe_int4``
(the routed experts).  The tracer's summary is read by ``expert_load_skew``
as well, from the snapshots ``spies`` takes of the port's expert counter.

The reference, the published equations un-absorbed: x + attn(rmsnorm(x)),
then x + ff(rmsnorm(x)).  Attention: q = x Wq per head (nope 128 ‖ rope 64);
[c, k_pe] = x Wkv_a, c = rmsnorm(c); [k_nope, v] = c Wkv_b per head; q_pe
and k_pe de-interleaved (even elements, then odd) and rotated rotate-half
(``reference/model.py``'s rope); causal softmax of (q . k) / sqrt(192); the
heads through Wo.  Layer 0's ff is the dense SiLU MLP; the others route in
float32, as the program does: sigmoid(x Wr) scores, the top 6 of scores +
bias, the chosen scores normalised to sum 1 and times 2.446; the sum of the
chosen experts' outputs times their weights, plus the shared experts' MLP.
Every int4 tensor is unpacked from the benchmark's bytes and multiplied by
its group scales in float32, a layer (an expert) at a time, and the whole of
every sequence is computed: no cache.  ``lowered=True`` is the control, the
reference a precision below the bfloat16 the configuration states: every
tensor the program holds in bfloat16 (the merged embeddings, the residual
stream after each add, each norm's output, q, c and k_pe, each head's key
and value, the attention output, each projection's and expert's output, the
MLPs' activations, the routed sum) is rounded to float8 e4m3, each row
scaled by its largest magnitude over 448; the router stays float32.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from port_bench import flops
from port_bench.reference.model import (
    Sequence_, full_f32, patch_embeddings, rms_norm, rope, to_fp8, unpack_int4)
from port_bench.weights import GROUP, Draws, port_ts_encoder

KERNELS = {"int4": ("int4_mma_kernel", "int4_splitk_reduce_kernel"),
           "mla_decode": ("mla_decode", "decode_merge_kernel"),
           "mla_prefill": ("mla_prefill_mma_kernel",),
           "moe_int4": ("moe_int4",)}

HEADS, NOPE, ROPE, V, LATENT = 16, 128, 64, 128, 512


def _shape(cfg: dict):
    """(layers, hidden, heads, q width, the fused q ‖ kv_a width padded to
    a multiple of 128)."""
    h, hid = cfg["num_attention_heads"], cfg["hidden_size"]
    nq = h * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"])
    width = nq + cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    return cfg["num_hidden_layers"], hid, h, nq, -(-width // 128) * 128


# -- weights and the port's model ---------------------------------------------

def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of configuration ``cfg`` drawn from ``seed`` on
    ``device``.  ``.q4``/``.s4`` keys are packed int4 bytes and their
    scales: the attention's stacked over the layers, the experts' over
    (expert layers, experts), layer 0's MLP alone.  q and kv_a are drawn as
    one projection [q | kv_a | pad] (the pad's 64 columns are never read).
    The router is float32: N(0, 1) / sqrt(hidden) times ``router_spread``,
    with a bias 0.05 N(0, 1)."""
    from chatts_tpu_torch.models import moonlight  # noqa: F401  (a port without it fails here)

    n, hid, h, _, qkv_w = _shape(cfg)
    m = n - cfg["first_k_dense_replace"]
    e, inter = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    shared = inter * cfg["n_shared_experts"]
    kv_b = h * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"])
    draw = Draws(seed, device, n)
    g = draw.g
    w: Dict[str, torch.Tensor] = {}

    def proj(name, layers, fan_in, fan_out, residual=False):
        w[f"{name}.q4"] = draw.packed(layers, fan_in, fan_out)
        w[f"{name}.s4"] = draw.scales(layers, fan_in, fan_out, residual=residual)

    proj("q_kv_a", n, hid, qkv_w)
    proj("kv_b", n, cfg["kv_lora_rank"], kv_b)
    proj("o", n, h * cfg["v_head_dim"], hid, residual=True)
    w["kv_a_norm"] = draw.around_one(n, cfg["kv_lora_rank"])
    w["ln1"] = draw.around_one(n, hid)
    w["ln2"] = draw.around_one(n, hid)
    proj("dense.gate_up", 0, hid, 2 * cfg["intermediate_size"])
    proj("dense.down", 0, cfg["intermediate_size"], hid, residual=True)
    proj("shared.gate_up", m, hid, 2 * shared)
    proj("shared.down", m, shared, hid, residual=True)
    proj("experts.gate_up", m * e, hid, 2 * inter)
    proj("experts.down", m * e, inter, hid, residual=True)
    for key in ("experts.gate_up.q4", "experts.gate_up.s4", "experts.down.q4",
                "experts.down.s4"):
        w[key] = w[key].view(m, e, *w[key].shape[1:])
    w["router"] = (torch.randn((m, hid, e), generator=g, device=device)
                   * (cfg["router_spread"] / math.sqrt(hid)))
    w["router_bias"] = 0.05 * torch.randn((m, e), generator=g, device=device)
    w["norm"] = draw.around_one(hid)
    w["embed"] = torch.randn((cfg["vocab_size"], hid), generator=g, device=device,
                             dtype=torch.bfloat16)
    proj("head", 0, hid, cfg["vocab_size"])
    w.update(draw.ts_encoder(cfg["ts"]))
    return w


def port_config(cfg: dict):
    """The port's ``ChatTSConfig`` for configuration ``cfg``."""
    from chatts_tpu_torch.core.config import ChatTSConfig, MoonlightConfig, TSEncoderConfig

    ts = cfg["ts"]
    keys = ("vocab_size", "hidden_size", "intermediate_size", "moe_intermediate_size",
            "num_hidden_layers", "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim",
            "qk_rope_head_dim", "v_head_dim", "n_routed_experts", "n_shared_experts",
            "num_experts_per_tok", "first_k_dense_replace", "routed_scaling_factor",
            "norm_topk_prob", "rms_norm_eps", "rope_theta", "max_position_embeddings",
            "tie_word_embeddings")
    return ChatTSConfig(
        llm=MoonlightConfig(**{k: cfg[k] for k in keys}, dtype="bfloat16"),
        ts=TSEncoderConfig(patch_size=ts["patch_size"], num_layers=ts["num_layers"],
                           hidden_size=ts["hidden_size"],
                           max_sequence_length=ts["max_sequence_length"]),
        ts_token_start_index=cfg["ts_token_start_index"],
    )


def port_model(cfg: dict, w: Dict[str, torch.Tensor]):
    """The port's ``ChatTSModel`` holding the tensors of ``w`` (no copy): q
    and kv_a as one int4 projection, fused gate/up MLPs, int4 experts and
    head; ``kv_b`` dequantized at build into its two absorbed factors."""
    from chatts_tpu_torch.models.chatts import ChatTSModel
    from chatts_tpu_torch.models.moonlight import MLAttention, MoE, MoonlightModel
    from chatts_tpu_torch.models.qwen import MLP, DecoderLayer, Dense

    pcfg = port_config(cfg)
    k0 = cfg["first_k_dense_replace"]

    def dense(name, *i):
        return Dense(kernel_q4=w[f"{name}.q4"][i] if i else w[f"{name}.q4"],
                     scales4=w[f"{name}.s4"][i] if i else w[f"{name}.s4"])

    layers = []
    for i in range(cfg["num_hidden_layers"]):
        attn = MLAttention(pcfg.llm, None, None, w["kv_a_norm"][i], dense("kv_b", i),
                           dense("o", i), q_kv_a_proj=dense("q_kv_a", i))
        if i < k0:
            ff = MLP(dense("dense.down"), gate_up_proj=dense("dense.gate_up"))
        else:
            j = i - k0
            ff = MoE(pcfg.llm, w["router"][j], w["router_bias"][j],
                     w["experts.gate_up.q4"][j], w["experts.gate_up.s4"][j],
                     w["experts.down.q4"][j], w["experts.down.s4"][j],
                     MLP(dense("shared.down", j), gate_up_proj=dense("shared.gate_up", j)))
        layers.append(DecoderLayer(pcfg.llm, attn, ff, w["ln1"][i], w["ln2"][i]))
    llm = MoonlightModel(pcfg.llm, w["embed"], layers, w["norm"], lm_head_q=dense("head"))
    encoder = port_ts_encoder(pcfg.ts, w, w["embed"].device)
    return pcfg, ChatTSModel(pcfg, encoder, llm)


# -- the plain reference --------------------------------------------------------

def _attention(q, k, v, scale: float, block: int = 1024) -> torch.Tensor:
    """Causal attention of q, k (T, H, Dqk) and v (T, H, Dv) -> (T, H * Dv),
    queries in blocks."""
    t, h, _ = q.shape
    kt, vt = k.transpose(0, 1), v.transpose(0, 1)
    out = []
    for s in range(0, t, block):
        qb = q[s:s + block].transpose(0, 1)
        scores = qb @ kt.transpose(1, 2) * scale
        rows = torch.arange(s, s + qb.shape[1], device=q.device)[:, None]
        scores = scores.masked_fill(torch.arange(t, device=q.device)[None, :] > rows,
                                    float("-inf"))
        out.append((scores.softmax(dim=-1) @ vt).transpose(0, 1).reshape(qb.shape[1], -1))
    return torch.cat(out)


def _deinterleave(x: torch.Tensor) -> torch.Tensor:
    return x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)


def _route(cfg: dict, x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor):
    scores = torch.sigmoid(x @ router)
    idx = torch.topk(scores + bias, cfg["num_experts_per_tok"], dim=-1).indices
    wt = scores.gather(1, idx)
    if cfg["norm_topk_prob"]:
        wt = wt / (wt.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, wt * cfg["routed_scaling_factor"]


@torch.no_grad()
def final_hidden(cfg: dict, w: Dict[str, torch.Tensor], seqs: List[Sequence_],
                 lowered: bool = False) -> List[torch.Tensor]:
    """The final norm's output (len(wanted), hidden) float32 of every
    sequence, layer by layer over all of them."""
    dev = w["embed"].device
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    n, _, h, nq, _ = _shape(cfg)
    nope, rp, vd, lat = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                         cfg["kv_lora_rank"])
    k0, e = cfg["first_k_dense_replace"], cfg["n_routed_experts"]
    inter = cfg["moe_intermediate_size"]
    scale = (nope + rp) ** -0.5

    def lo(x):
        return to_fp8(x) if lowered else x

    def mlp(x, gate_up, down):
        g, u = lo(x @ gate_up).chunk(2, dim=-1)
        return lo(lo(F.silu(g) * u) @ down)

    with full_f32():
        xs = []
        for s in seqs:
            x = w["embed"][torch.as_tensor(s.ids, device=dev)].float()
            for values, start in zip(s.values, s.starts):
                emb = patch_embeddings(cfg, w, values, dev)
                x[start:start + emb.shape[0]] = emb
            xs.append(lo(x))
        for i in range(n):
            wq = {k: unpack_int4(w[f"{k}.q4"][i], w[f"{k}.s4"][i]) for k in ("q_kv_a", "kv_b", "o")}
            normed = []
            for j, x in enumerate(xs):
                t = x.shape[0]
                y = lo(lo(rms_norm(x, w["ln1"][i], eps)) @ wq["q_kv_a"])
                q = y[:, :nq].reshape(t, h, nope + rp)
                c, k_pe = y[:, nq:nq + lat + rp].split([lat, rp], dim=-1)
                c = lo(rms_norm(c, w["kv_a_norm"][i], eps))
                kv = lo(c @ wq["kv_b"]).reshape(t, h, nope + vd)
                q_pe = lo(rope(_deinterleave(q[..., nope:]), theta))
                k_pe = lo(rope(_deinterleave(k_pe)[:, None, :], theta))
                qf = torch.cat([q[..., :nope], q_pe], dim=-1)
                kf = torch.cat([kv[..., :nope], k_pe.expand(t, h, rp)], dim=-1)
                att = lo(_attention(qf, kf, kv[..., nope:], scale))
                x = lo(x + lo(att @ wq["o"]))
                xs[j] = x
                normed.append(lo(rms_norm(x, w["ln2"][i], eps)))
            del wq
            if i < k0:
                gu = unpack_int4(w["dense.gate_up.q4"], w["dense.gate_up.s4"])
                dn = unpack_int4(w["dense.down.q4"], w["dense.down.s4"])
                xs = [lo(x + mlp(z, gu, dn)) for x, z in zip(xs, normed)]
                del gu, dn
                continue
            li = i - k0
            routed = [torch.zeros_like(z) for z in normed]
            choices = [_route(cfg, z, w["router"][li], w["router_bias"][li]) for z in normed]
            for ex in range(e):
                gu = unpack_int4(w["experts.gate_up.q4"][li, ex], w["experts.gate_up.s4"][li, ex])
                dn = unpack_int4(w["experts.down.q4"][li, ex], w["experts.down.s4"][li, ex])
                for z, out, (idx, wt) in zip(normed, routed, choices):
                    rows, ks = torch.nonzero(idx == ex, as_tuple=True)
                    if rows.numel():
                        out.index_add_(0, rows, mlp(z[rows], gu, dn) * wt[rows, ks, None])
            sgu = unpack_int4(w["shared.gate_up.q4"][li], w["shared.gate_up.s4"][li])
            sdn = unpack_int4(w["shared.down.q4"][li], w["shared.down.s4"][li])
            xs = [lo(x + lo(lo(r) + mlp(z, sgu, sdn))) for x, r, z in zip(xs, routed, normed)]
            del sgu, sdn, routed
        return [lo(rms_norm(x[torch.as_tensor(s.wanted, device=dev)], w["norm"], eps))
                for s, x in zip(seqs, xs)]


@torch.no_grad()
def logits(cfg: dict, w: Dict[str, torch.Tensor], seqs: List[Sequence_],
           lowered: bool = False) -> List[torch.Tensor]:
    """The logits (len(wanted), vocab) float32 of every sequence: the int4
    head over ``final_hidden``."""
    hidden = final_hidden(cfg, w, seqs, lowered)
    with full_f32():
        head = unpack_int4(w["head.q4"], w["head.s4"])
        return [x @ head for x in hidden]


# -- FLOPs ------------------------------------------------------------------------

def token_matmul_flops(cfg: dict) -> float:
    """A token's projection FLOPs through the whole stack, 2 a multiply-add:
    q and kv_a, kv_b once (the un-absorbed form), o; layer 0's dense MLP;
    in every expert layer the 6 routed experts and the shared MLP; not the
    head, and not the router's f32 product."""
    n, hid, h, nq, _ = _shape(cfg)
    k0 = cfg["first_k_dense_replace"]
    lat, rp = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    attn = hid * (nq + lat + rp) + lat * h * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"]) \
        + h * cfg["v_head_dim"] * hid
    dense = 3 * hid * cfg["intermediate_size"]
    expert = 3 * hid * cfg["moe_intermediate_size"]
    moe = (cfg["num_experts_per_tok"] + cfg["n_shared_experts"]) * expert
    return 2.0 * (n * attn + k0 * dense + (n - k0) * moe)


def _attn_pair_flops(cfg: dict) -> float:
    """A (query, key) pair's attention FLOPs over the heads: q . k at 192
    and p v at 128, 2 a multiply-add."""
    h = cfg["num_attention_heads"]
    return 2.0 * h * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"])


def head_flops(cfg: dict) -> float:
    return 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


def prefill_flops(cfg: dict, prompt: int) -> float:
    n = cfg["num_hidden_layers"]
    return (prompt * token_matmul_flops(cfg)
            + n * _attn_pair_flops(cfg) * flops.prefix_pairs([prompt]) + head_flops(cfg))


def decode_flops(cfg: dict, prompt: int, first: int, count: int) -> float:
    n = cfg["num_hidden_layers"]
    keys = flops.span_pairs(prompt + first - 1, prompt + first - 1 + count)
    return count * (token_matmul_flops(cfg) + head_flops(cfg)) + n * _attn_pair_flops(cfg) * keys


def request_flops(cfg: dict, prompt: int, puts: Iterable[Tuple[float, int]]):
    """(time, FLOPs) of each delivery of one request's tokens: the first
    carries the prefill, the rest the decode steps that made them."""
    out, done = [], 0
    for t, k in puts:
        f = 0.0
        if done == 0:
            f += prefill_flops(cfg, prompt)
            if k > 1:
                f += decode_flops(cfg, prompt, 1, k - 1)
        else:
            f += decode_flops(cfg, prompt, done, k)
        out.append((t, f))
        done += k
    return out


# -- the kernels' bounds --------------------------------------------------------------

def mla_decode_bound_s(lengths: List[int], s_cap: int, read: Optional[int] = None) -> float:
    """``mla_decode`` over query rows of these lengths: the latent positions
    read from device memory (1,152 bytes each; ``read``, where rows share a
    slot's prefix, else each row's own), each row's q (576) and output (128
    a head) in bf16, the absorbed factors once (2 x 16 x 128 x 512 bf16);
    16 x (576 + 512) multiply-adds a row's position, and the absorption and
    up-projection, 2 x 16 x 128 x 512 a row."""
    r, pos = len(lengths), sum(min(max(n, 0), s_cap) for n in lengths)
    read = pos if read is None else read
    nbytes = read * (LATENT + ROPE) * 2 + r * HEADS * (LATENT + ROPE + V) * 2 \
        + 2 * HEADS * NOPE * LATENT * 2
    ops = 2.0 * HEADS * (2 * LATENT + ROPE) * pos + 2 * 2.0 * HEADS * NOPE * LATENT * r
    return flops.bound_s(nbytes, ops)


def mla_prefill_bound_s(lengths: List[int]) -> float:
    """``mla_prefill`` over prompts of these lengths: q, k (192) and v, the
    output (128) once each, 16 heads, bf16; the causal pairs' operations."""
    tokens = sum(lengths)
    nbytes = 2 * HEADS * tokens * (2 * (NOPE + ROPE) + 2 * V)
    ops = 2.0 * HEADS * (NOPE + ROPE + V) * flops.prefix_pairs(lengths)
    return flops.bound_s(nbytes, ops)


def moe_bound_s(t: int, k: int, e: int, hid: int, inter: int) -> float:
    """``moe_int4`` over T tokens: the packed bytes and scales of the experts
    the launch is expected to touch (each of E experts is untouched with
    probability (1 - K / E) ** T under uniform routing), x, the K rows of
    activations and results and the output once; 3 x hidden x inter
    multiply-adds a routed row."""
    touched = e * (1.0 - (1.0 - k / e) ** t)
    per_expert = 3 * hid * inter // 2 + (2 * hid // GROUP * inter + inter // GROUP * hid) * 4
    nbytes = touched * per_expert + 2 * t * hid * 2 + 2 * t * k * (inter + hid) * 2
    return flops.bound_s(nbytes, 2.0 * 3 * hid * inter * t * k)


# -- the traced run's hooks ------------------------------------------------------------

_EXPERT_SNAPSHOTS: Dict[float, torch.Tensor] = {}


def spies(tracer) -> list:
    """Wrappers of the names the port calls: ``int4_matmul`` (B3, every
    launch at its shape, a graph's at its capture's); ``moe_int4`` likewise;
    ``mla_prefill``, eager prefill over a prompt block, its bound worked out
    from the valid lengths when the trace is read.  ``mla_decode`` runs only
    inside the serving engine's graphs, whose lengths change every replay:
    a decode round counts its launches from the slots' lengths
    (``_DecodeStepGraph.round``), a scan-sliced round from
    ``mixed_launches``, and an eager call from its lengths.  Each engine
    round end also snapshots the port's expert counter on the device
    (no sync), for ``expert_load_skew``."""
    from chatts_tpu_torch.models import moonlight, qwen
    from chatts_tpu_torch.serve import scheduler

    int4, decode, prefill, moe = (qwen.int4_matmul, moonlight.mla_decode, moonlight.mla_prefill,
                                  moonlight.moe_int4)
    round_fn, log_round = scheduler._DecodeStepGraph.round, scheduler.ServeEngine._log_round
    _EXPERT_SNAPSHOTS.clear()

    def int4_spy(x, packed, scales, *args, **kw):
        tracer.launch("int4", flops.int4_bound_s, x.shape[0], x.shape[1], packed.shape[1])
        return int4(x, packed, scales, *args, **kw)

    def moe_spy(x, idx, wt, gu_q, *args, **kw):
        tracer.launch("moe_int4", moe_bound_s, x.shape[0], idx.shape[1], gu_q.shape[0],
                      x.shape[1], gu_q.shape[2] // 2)
        return moe(x, idx, wt, gu_q, *args, **kw)

    def prefill_spy(q, k, v, **kw):
        if tracer.counts_eager():
            tracer.eager("mla_prefill", lambda valid: mla_prefill_bound_s(
                valid.sum(dim=1).tolist()), kw["kv_valid"].clone())
        return prefill(q, k, v, **kw)

    def decode_spy(q_nope, q_pe, w_uk, w_uv, cache, rows, lengths, **kw):
        if tracer.counts_eager():
            tracer.eager("mla_decode", lambda ls, s: mla_decode_bound_s(ls.tolist(), s),
                         lengths.clone(), cache.shape[-2])
        return decode(q_nope, q_pe, w_uk, w_uv, cache, rows, lengths, **kw)

    def decode_round(self):
        if tracer.recording:
            cfg = tracer.cfg
            s_cap = cfg["engine"]["max_model_len"]
            for lengths in _decode_lengths(self.state[1], self.active, self.budget,
                                           self.chunk_size):
                tracer.calls["mla_decode"] += cfg["num_hidden_layers"]
                tracer.bound["mla_decode"] += cfg["num_hidden_layers"] * mla_decode_bound_s(
                    lengths, s_cap)
        return round_fn(self)

    def snapshot(self, **entry):
        counts = getattr(self.model.llm, "expert_tokens", None)
        if counts is not None and "t" in entry:
            _EXPERT_SNAPSHOTS[entry["t"]] = counts.clone()
        return log_round(self, **entry)

    return [(qwen, "int4_matmul", int4_spy), (moonlight, "moe_int4", moe_spy),
            (moonlight, "mla_prefill", prefill_spy), (moonlight, "mla_decode", decode_spy),
            (scheduler._DecodeStepGraph, "round", decode_round),
            (scheduler.ServeEngine, "_log_round", snapshot)]


def _decode_lengths(cur_lens, active, budget, steps: int) -> List[List[int]]:
    """Each step's query lengths in a decode round: an active slot attends
    cur_len + 1 while it has budget (its cur_len then stops), an inactive
    one 1 position."""
    c, a, b = (t.tolist() for t in (cur_lens, active, budget))
    return [[(ci + min(i, bi) + 1) if ai else 1 for ci, ai, bi in zip(c, a, b)]
            for i in range(steps)]


def mixed_launches(cfg: dict, engine) -> List[Tuple[str, int, float]]:
    """The ``mla_decode`` launches of the scan-sliced round about to run:
    ``decode_chunk`` steps, one launch a layer, each over the decode rows'
    lengths and the admission rows' prompt tokens, a token at position p
    attending min(p + 1, its prompt's length) positions (a pad row: 0).  A
    prompt's rows share its slot's prefix: its bytes are its longest row's
    positions, read once."""
    st = engine._pending_mixed
    a = st["embeds"].shape[0]
    lengths = [r.prompt_tokens for r in st["reqs"]] + [0] * (a - len(st["reqs"]))
    npt, o = st["npt"], st["o"]
    live = (engine._active_device() & (engine.budget > 0))
    steps = _decode_lengths(engine.cur_lens, live, engine.budget, engine.decode_chunk)
    n, s_cap = cfg["num_hidden_layers"], engine.max_model_len
    out = []
    for s, dec in enumerate(steps):
        start = o + s * npt
        pro = [min(start + j + 1, ln) for ln in lengths for j in range(npt)]
        read = sum(min(m, s_cap) for m in dec) + sum(min(start + npt, ln, s_cap) for ln in lengths)
        out.append(("mla_decode", n, n * mla_decode_bound_s(dec + pro, s_cap, read)))
    return out


def expert_load_skew(run) -> Optional[float]:
    """Over the measured window (its first and last round ends): for each
    expert layer, the busiest expert's routed rows over the mean of its
    experts', from the port's expert counter; the mean over the layers.
    None where the counter was not snapshotted at both ends."""
    lo, hi = _EXPERT_SNAPSHOTS.get(run.span[0]), _EXPERT_SNAPSHOTS.get(run.span[1])
    if lo is None or hi is None:
        return None
    rows = (hi - lo).double()
    rows = rows[rows.sum(dim=1) > 0]
    if rows.numel() == 0:
        return None
    return float((rows.amax(dim=1) / rows.mean(dim=1)).mean())
