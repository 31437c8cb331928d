"""The DeepSeek-V3 decoder block (``model_type`` ``deepseek_v3``) at
Moonlight-16B-A3B's widths, as PyTorch modules: multi-head latent attention
(MLA) over a latent cache, and sparse routed experts with shared experts.

The stack is ``QwenModel``'s (``models/qwen.py``): its embedding, final norm,
head, ``forward`` (block prefill, prefill chunks, cached decode) and
``forward_mixed`` (the serving engine's scan-sliced step), and its
``DecoderLayer`` (pre-norm residuals through ``add_rms_norm``).  What differs
is the attention (``MLAttention``) and, from layer ``first_k_dense_replace``
on, the feed-forward (``MoE``; earlier layers are the dense ``qwen.MLP``).
The rope tables are ``QwenModel``'s at the config's ``head_dim``, the rope
width (64), and q_pe and k_pe are de-interleaved before rotate-half, as
``transformers``' ``apply_rotary_pos_emb_interleave`` does
(``rope_interleave``, its default).

- **Attention.**  q is one projection to heads x (nope 128 ‖ rope 64);
  ``kv_a`` gives the latent ``c_kv`` (512, put through its RMSNorm) and one
  rope key shared by the heads; ``kv_b`` maps ``c_kv`` to each head's nope
  key and value (128 each).  A layer cache is the 1-tuple (latent,) of a
  (B, 1, S, 576) buffer (``runtime/kv_cache.py``): a token's normed
  ``c_kv`` and roped key.  A prompt block attends itself un-absorbed
  through ``kv_b`` (``ops/mla.py::mla_prefill``, qk 192 / v 128); a
  prefill chunk attends its cache prefix the same way, the prefix taken up
  through ``kv_b``.  Decode, and the mixed step's decode and prompt tokens
  alike, attend the latent rows absorbed (``mla_decode``): ``kv_b`` is
  dequantized once, at build time, into its two factors ``w_uk`` (H, 128,
  512) and ``w_uv`` (H, 512, 128) in the model's type.  The softmax scale is
  192 ** -0.5 (no rope scaling).
- **Experts.**  The router's logits are f32 (its weight and
  ``e_score_correction_bias`` are f32): sigmoid scores, the top
  ``num_experts_per_tok`` of score + bias (one group: no group limit),
  the chosen scores normalised to sum 1 (``norm_topk_prob``) and times
  ``routed_scaling_factor``, as ``transformers``' ``DeepseekV3TopkRouter``
  computes them.  The routed experts are int4 (``ops/moe_int4.py``) and the
  layer holds a range of them, [first, first + E): here all of them, with
  no exchange; the shared experts are one ``qwen.MLP`` added to the routed
  sum.  Each ``MoE`` keeps a device counter of the rows routed to each of
  its experts, added inside the step with no sync
  (``MoonlightModel.expert_tokens``).

Under ``torch.profiler`` the eager calls of the three kernels are the
ranges ``mla.prefill``, ``mla.decode`` and ``moe.experts``.  Tensor
parallelism, training and ``act_int8`` on the experts are not ported.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from chatts_tpu_torch.core.config import MoonlightConfig
from chatts_tpu_torch.models import qwen
from chatts_tpu_torch.models.qwen import Dense, DecoderLayer, MLP, QwenModel, rms_norm
from chatts_tpu_torch.ops.int4_matmul import dequantize, pack_from_int4_values, pack_int4
from chatts_tpu_torch.ops.mla import mla_decode, mla_prefill, mla_prefill_reference
from chatts_tpu_torch.ops.moe_int4 import moe_int4


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> the even elements, then the odd: the reordering
    ``apply_rotary_pos_emb_interleave`` makes before rotate-half."""
    return x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)


def dense_weight(d: Dense) -> torch.Tensor:
    """A ``Dense``'s (in, out) weight in f32: the float kernel, or the int4
    values times their scales."""
    if d.kernel_q4 is not None:
        return dequantize(d.kernel_q4, d.scales4)
    if d.kernel is None:
        raise ValueError("kv_b must be float or int4")
    return d.kernel.float()


def fuse_q_kv_a(q_proj: Dense, kv_a_proj: Dense) -> Dense:
    """One projection of q's and kv_a's columns, [q | kv_a | zeros], the
    zero columns padding the width to a multiple of 128 (B3's tile: kv_a's
    576 alone is none): float kernels or symmetric int4 ones (zero codes,
    unit scales in the pad)."""
    width = q_proj.out_features + kv_a_proj.out_features
    pad = -width % 128
    if q_proj.kernel_q4 is not None and kv_a_proj.kernel_q4 is not None:
        if q_proj.zeros4 is not None or kv_a_proj.zeros4 is not None:
            raise ValueError("fuse_q_kv_a takes symmetric int4 weights")
        packed = torch.cat([q_proj.kernel_q4, kv_a_proj.kernel_q4], dim=1)
        scales = torch.cat([q_proj.scales4, kv_a_proj.scales4], dim=1)
        return Dense(kernel_q4=torch.nn.functional.pad(packed, (0, pad)),
                     scales4=torch.nn.functional.pad(scales, (0, pad), value=1.0))
    if q_proj.kernel is None or kv_a_proj.kernel is None:
        raise ValueError("fuse_q_kv_a takes two float or two int4 projections")
    kernel = torch.cat([q_proj.kernel, kv_a_proj.kernel], dim=1)
    return Dense(torch.nn.functional.pad(kernel, (0, pad)))


class MLAttention(nn.Module):
    """Multi-head latent attention (see the module's docstring).  Called as
    ``qwen.Attention`` is, so ``qwen.DecoderLayer`` holds it.  q and kv_a
    are ``q_proj`` and ``kv_a_proj``, or one ``q_kv_a_proj``
    (``fuse_q_kv_a``)."""

    def __init__(self, cfg: MoonlightConfig, q_proj: Optional[Dense],
                 kv_a_proj: Optional[Dense], kv_a_norm: torch.Tensor, kv_b_proj: Dense,
                 o_proj: Dense, *, q_kv_a_proj: Optional[Dense] = None):
        super().__init__()
        if (q_kv_a_proj is None) == (q_proj is None or kv_a_proj is None):
            raise ValueError("MLAttention takes q_proj and kv_a_proj, or q_kv_a_proj")
        self.cfg = cfg
        self.q_proj, self.kv_a_proj, self.kv_b_proj, self.o_proj = (
            q_proj, kv_a_proj, kv_b_proj, o_proj)
        self.q_kv_a_proj = q_kv_a_proj
        self.kv_a_norm = qwen._frozen(kv_a_norm)
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = 1  # the latent cache's one row a token
        self.mesh = None
        h, nope, v = self.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
        w = dense_weight(kv_b_proj).reshape(cfg.kv_lora_rank, h, nope + v)
        dtype = kv_a_norm.dtype
        self.register_buffer("w_uk", w[..., :nope].permute(1, 2, 0).contiguous().to(dtype))
        self.register_buffer("w_uv", w[..., nope:].transpose(0, 1).contiguous().to(dtype))

    @property
    def scale(self) -> float:
        return self.cfg.qk_head_dim ** -0.5

    def _project(self, x, rope, act_int8: bool = False):
        """q_nope (B, T, H, nope), q_pe (B, T, H, rope) roped, the normed
        c_kv (B, T, latent) and the roped key (B, T, rope) of x."""
        cfg = self.cfg
        b, t, _ = x.shape
        nq = self.num_heads * cfg.qk_head_dim
        if self.q_kv_a_proj is not None:
            y = self.q_kv_a_proj(x, act_int8)
            q, ckv = y[..., :nq], y[..., nq:nq + cfg.latent_dim]
        else:
            q, ckv = self.q_proj(x, act_int8), self.kv_a_proj(x, act_int8)
        q = q.reshape(b, t, self.num_heads, cfg.qk_head_dim)
        q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
        c, k_pe = ckv.split([cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
        c = rms_norm(c, self.kv_a_norm, cfg.rms_norm_eps)
        cos, sin = rope
        q_pe = qwen.apply_rope(deinterleave(q_pe), cos, sin)
        k_pe = qwen.apply_rope(deinterleave(k_pe)[:, :, None], cos, sin)[:, :, 0]
        return q_nope, q_pe, c, k_pe

    def _unabsorbed(self, c, k_pe, act_int8: bool = False):
        """Each head's key (nope ‖ rope) and value of latent rows c (B, S,
        latent) and rope keys (B, S, rope), up through ``kv_b``."""
        cfg = self.cfg
        b, s, _ = c.shape
        kv = self.kv_b_proj(c, act_int8).reshape(b, s, self.num_heads, -1)
        k_nope, v = kv.split([cfg.qk_nope_head_dim, cfg.v_head_dim], dim=-1)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(-1, -1, self.num_heads, -1)], dim=-1)
        return k.contiguous(), v.contiguous()

    def _attend_block(self, q, k, v, q_positions, kv_positions, kv_valid, attn_impl):
        """The un-absorbed prefill attention: the kernel, or its plain
        version for ``attn_impl="xla"``."""
        kw = dict(q_positions=q_positions.contiguous(), kv_positions=kv_positions.contiguous(),
                  kv_valid=kv_valid.contiguous(), scale=self.scale)
        with torch.profiler.record_function("mla.prefill"):
            if attn_impl == "xla":
                return mla_prefill_reference(q, k, v, **kw)
            return mla_prefill(q, k, v, **kw)

    def _attend_latent(self, q_nope, q_pe, cache, rows, lengths):
        """The absorbed attention of R query rows over the latent cache."""
        with torch.profiler.record_function("mla.decode"):
            return mla_decode(q_nope.contiguous(), q_pe.contiguous(), self.w_uk, self.w_uv,
                              cache, rows, lengths, scale=self.scale)

    def forward(self, x, positions, rope, kv_cache, write_pos, kv_valid, kv_positions,
                kv_lengths, act_int8: bool = False, kv_limit: Optional[int] = None,
                attn_impl: str = "auto"):
        b, t, _ = x.shape
        h = self.num_heads
        q_nope, q_pe, c, k_pe = self._project(x, rope, act_int8)
        if kv_cache is not None:
            buf = kv_cache[0]
            latent = torch.cat([c, k_pe], dim=-1).to(buf.dtype)  # (B, T, latent + rope)
        if kv_cache is not None and write_pos is not None:
            buf[torch.arange(b, device=x.device)[:, None], 0, write_pos.long()] = latent
            if kv_lengths is not None:  # decode: one query a row
                out = self._attend_latent(q_nope[:, 0], q_pe[:, 0], buf,
                                          torch.arange(b, device=x.device, dtype=torch.int32),
                                          kv_lengths)[:, None]
            else:  # a chunk: the cache prefix [:kv_limit], up through kv_b
                limit = buf.shape[2] if kv_limit is None else min(kv_limit, buf.shape[2])
                lat = buf[:, 0, :limit].to(x.dtype)
                k, v = self._unabsorbed(lat[..., :self.cfg.kv_lora_rank],
                                        lat[..., self.cfg.kv_lora_rank:], act_int8)
                q = torch.cat([q_nope, q_pe], dim=-1).contiguous()
                out = self._attend_block(q, k, v, positions, kv_positions[:, :limit],
                                         kv_valid[:, :limit], attn_impl)
        else:
            if kv_cache is not None:
                # Prefill: the block goes to positions [0, T); it attends
                # itself, as computed.
                buf[:, 0, :t] = latent
                kv_valid, kv_positions = kv_valid[:, :t], kv_positions[:, :t]
            k, v = self._unabsorbed(c, k_pe, act_int8)
            q = torch.cat([q_nope, q_pe], dim=-1).contiguous()
            out = self._attend_block(q, k, v, positions, kv_positions, kv_valid, attn_impl)
        return self.o_proj(out.reshape(b, t, h * self.cfg.v_head_dim), act_int8), kv_cache

    def forward_mixed(self, x, rope, kv_cache, step: "qwen.MixedStep"):
        """The mixed step (``QwenModel.forward_mixed``): x (1, B + A*npt,
        hidden) packed, decode tokens first.  Every token writes its latent
        row (an inactive decode row writes back what its position holds; a
        pad admission row writes row 0's span again), then every token
        attends absorbed, in one ``mla_decode``: a decode token its slot's
        first ``dec_kv_lengths``, a prompt token at position p its slot's
        first min(p + 1, prompt length) positions (0 for a pad row)."""
        b, a, npt = step.b, step.a, step.npt
        q_nope, q_pe, c, k_pe = (z[0] for z in self._project(x, rope))
        buf = kv_cache[0]
        vals = torch.cat([c, k_pe], dim=-1).to(buf.dtype)  # (Tp, latent + rope)
        dec = vals[:b]
        keep = step.dec_write[:, None]
        buf[step.rows, 0, step.dec_pos] = torch.where(keep, dec, buf[step.rows, 0, step.dec_pos])
        span = vals[b:].reshape(a, npt, -1)[step.adm_src]
        buf[step.adm_write_slots[:, None], 0, step.span_pos[None, :]] = span
        seq_lens = step.adm_kv_valid.sum(dim=1, dtype=torch.int32)  # (A,): the prompt lengths
        pro_len = torch.minimum(step.adm_q_positions + 1, seq_lens[:, None])
        rows = torch.cat([step.rows, step.adm_slots.repeat_interleave(npt)]).to(torch.int32)
        lengths = torch.cat([step.dec_kv_lengths, pro_len.reshape(-1)]).to(torch.int32)
        out = self._attend_latent(q_nope, q_pe, buf, rows, lengths)
        return self.o_proj(out.reshape(1, b + a * npt, -1))


class MoE(nn.Module):
    """Routed experts (int4, the range [first, first + E) of them) and the
    shared experts (a ``qwen.MLP``), as ``transformers``' ``DeepseekV3MoE``
    computes them: see the module's docstring.  ``counts`` (E,) int32 gains
    each expert's routed rows at every call."""

    def __init__(self, cfg: MoonlightConfig, router: torch.Tensor, router_bias: torch.Tensor,
                 gate_up_q4: torch.Tensor, gate_up_s4: torch.Tensor, down_q4: torch.Tensor,
                 down_s4: torch.Tensor, shared: MLP, *, first: int = 0):
        super().__init__()
        self.cfg = cfg
        self.first = first
        self.shared = shared
        for name, t in (("router", router.float()), ("router_bias", router_bias.float()),
                        ("gate_up_q4", gate_up_q4), ("gate_up_s4", gate_up_s4),
                        ("down_q4", down_q4), ("down_s4", down_s4)):
            self.register_buffer(name, t)
        self.register_buffer("counts", torch.zeros((gate_up_q4.shape[0],), dtype=torch.int32,
                                                   device=gate_up_q4.device))

    def route(self, x2: torch.Tensor):
        """(top-k expert ids (T, K) int32, their weights (T, K) f32) of rows
        x2 (T, hidden): the router in f32."""
        cfg = self.cfg
        scores = torch.sigmoid(torch.matmul(x2.float(), self.router))
        idx = torch.topk(scores + self.router_bias, cfg.num_experts_per_tok, dim=-1).indices
        w = scores.gather(1, idx)
        if cfg.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return idx.to(torch.int32), w * cfg.routed_scaling_factor

    def forward(self, x: torch.Tensor, act_int8: bool = False) -> torch.Tensor:
        x2 = x.reshape(-1, x.shape[-1])
        idx, w = self.route(x2)
        with torch.profiler.record_function("moe.experts"):
            routed = moe_int4(x2, idx, w, self.gate_up_q4, self.gate_up_s4, self.down_q4,
                              self.down_s4, first=self.first, counts=self.counts)
        return routed.reshape(x.shape) + self.shared(x, act_int8)


def fuse_projections(model: "MoonlightModel") -> "MoonlightModel":
    """Fuse each layer's q and kv_a (``fuse_q_kv_a``) and each unfused MLP's
    gate and up, in place."""
    for layer in model.layers:
        attn = layer.self_attn
        if attn.q_kv_a_proj is None:
            attn.q_kv_a_proj = fuse_q_kv_a(attn.q_proj, attn.kv_a_proj)
            attn.q_proj = attn.kv_a_proj = None
        mlps = [layer.mlp.shared] if isinstance(layer.mlp, MoE) else [layer.mlp]
        for mlp in mlps:
            if mlp.gate_up_proj is None:
                g, u = mlp.gate_proj, mlp.up_proj
                if g.kernel_q4 is not None:
                    mlp.gate_up_proj = Dense(
                        kernel_q4=torch.cat([g.kernel_q4, u.kernel_q4], dim=1),
                        scales4=torch.cat([g.scales4, u.scales4], dim=1))
                else:
                    mlp.gate_up_proj = Dense(torch.cat([g.kernel, u.kernel], dim=1))
                mlp.gate_proj = mlp.up_proj = None
    return model


class MoonlightModel(QwenModel):
    """The decoder stack (``QwenModel``) of ``MLAttention`` layers, dense
    then ``MoE``; one latent row a token (``kv_heads`` 1)."""

    @property
    def kv_heads(self) -> int:
        return 1

    @property
    def expert_tokens(self) -> torch.Tensor:
        """(layers, experts) int32 on the device: the rows routed to each
        expert of each layer since the model was built (0 for a dense
        layer), read without a sync until the caller reads it to the host."""
        e = self.cfg.n_routed_experts
        rows = []
        for layer in self.layers:
            counts = getattr(layer.mlp, "counts", None)
            rows.append(counts if counts is not None else
                        torch.zeros((e,), dtype=torch.int32, device=self.norm.device))
        return torch.stack(rows)


@torch.no_grad()
def init_params(cfg: MoonlightConfig, generator: torch.Generator, device="cpu",
                dtype=None, *, int4: bool = False) -> MoonlightModel:
    """A random decoder for tests: float projections (normal / sqrt(fan_in),
    the residual ones over sqrt(2 layers) more), int4 routed experts (codes
    uniform over [-7, 7], scales (0.5 + U) / (7 sqrt(fan_in))), norms U(0.5,
    1.5), a router N(0, 1) / sqrt(hidden) with a bias 0.1 N(0, 1), embeddings
    N(0, 1), a float head; drawn in f32 from ``generator``, then cast to
    ``dtype`` (the config's by default) on ``device``.  ``int4``: every
    projection and the head quantized to symmetric int4 (group 128), q and
    kv_a and each MLP's gate and up fused (``fuse_projections``), as the
    serving path holds them."""
    if dtype is None:
        dtype = getattr(torch, cfg.dtype)
    hid, h = cfg.hidden_size, cfg.num_attention_heads
    res = 1.0 / math.sqrt(2 * cfg.num_hidden_layers)

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=generator.device) * std).to(
            device=device, dtype=dtype)

    def dense(fan_in, fan_out, scale=1.0):
        w = normal((fan_in, fan_out), scale / math.sqrt(fan_in))
        if not int4:
            return Dense(w)
        packed, scales = pack_int4(w.float())
        return Dense(kernel_q4=packed, scales4=scales)

    def around_one(n):
        return (0.5 + torch.rand((n,), generator=generator, device=generator.device)).to(
            device=device, dtype=dtype)

    def experts(e, fan_in, fan_out, scale=1.0):
        codes = torch.randint(-7, 8, (e, fan_in, fan_out), generator=generator,
                              device=generator.device, dtype=torch.int32)
        s = (0.5 + torch.rand((e, fan_in // 128, fan_out), generator=generator,
                              device=generator.device)) * scale / (7 * math.sqrt(fan_in))
        packed = torch.stack([pack_from_int4_values(c, si)[0] for c, si in zip(codes, s)])
        return packed.to(device), s.to(device)

    def mlp(inter):
        return MLP(dense(inter, hid, res), gate_proj=dense(hid, inter), up_proj=dense(hid, inter))

    layers = []
    for i in range(cfg.num_hidden_layers):
        attn = MLAttention(cfg, dense(hid, h * cfg.qk_head_dim),
                           dense(hid, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                           around_one(cfg.kv_lora_rank),
                           dense(cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                           dense(h * cfg.v_head_dim, hid, res))
        if i < cfg.first_k_dense_replace:
            ff = mlp(cfg.intermediate_size)
        else:
            e, inter = cfg.n_routed_experts, cfg.moe_intermediate_size
            router = torch.randn((hid, e), generator=generator,
                                 device=generator.device) / math.sqrt(hid)
            bias = 0.1 * torch.randn((e,), generator=generator, device=generator.device)
            gu_q, gu_s = experts(e, hid, 2 * inter)
            d_q, d_s = experts(e, inter, hid, res)
            ff = MoE(cfg, router.to(device), bias.to(device), gu_q, gu_s, d_q, d_s,
                     mlp(inter * cfg.n_shared_experts))
        layers.append(DecoderLayer(cfg, attn, ff, around_one(hid), around_one(hid)))
    embed = normal((cfg.vocab_size, hid), 1.0)
    if int4:
        return fuse_projections(MoonlightModel(cfg, embed, layers, around_one(hid),
                                               lm_head_q=dense(hid, cfg.vocab_size)))
    return MoonlightModel(cfg, embed, layers, around_one(hid),
                          lm_head=normal((hid, cfg.vocab_size), 1 / math.sqrt(hid)))
