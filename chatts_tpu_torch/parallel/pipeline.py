"""Pipeline parallelism: a GPipe schedule of microbatches over a ``pp`` axis.

Counterpart of ``chatts_tpu/parallel/pipeline.py``.  JAX stacks the decoder
layers, shards the stack over ``pp`` and runs the schedule as one
``lax.scan`` inside a ``shard_map``, rotating activations with ``ppermute``;
its train step differentiates straight through the scan.  PyTorch runs one
process a stage, so the port runs the same schedule with point-to-point
messages in the stage's pp group, and its train step runs the schedule's
backward itself:

- the forward, M + S - 1 ticks: at tick t stage s runs microbatch t - s
  (when in range) through its L/S contiguous layers (``attn_impl="xla"``,
  as JAX's), then sends the activation to stage s + 1;
- the backward, the ticks in reverse: the last stage takes each
  microbatch's loss gradient, every other stage receives the gradient of
  its output from the next stage; each stage calls
  ``torch.autograd.backward`` on its saved output and sends the gradient of
  its input to the previous stage.

gloo has no ``send``/``recv`` of CUDA tensors, so under gloo an activation
travels through host memory; under NCCL it is sent from the card.  The
backend stays the caller's (``parallel/distributed.py``).

The embedding, the final norm and the head: JAX replicates them and every
stage computes them.  The port keeps them only where they are used: the
embedding on stage 0, the final norm and the head on the last stage (with
tied embeddings the table on every stage, its gradients, those of the first
and the last stage, summed over pp, so the copies stay equal).  Two
copies of ChatTS-14B's 152,064 x 5,120 vocabulary on every stage would be
3.1 B parameters a stage, 50 GB of f32 AdamW state, where the stage's
layers need less.  So ``pipeline_forward`` returns the hidden state after
the final norm computed on the last stage and broadcast to every stage, as
JAX's ``psum`` replicates it, and the train step computes the loss on the
last stage and broadcasts its value.

``make_pp_train_step`` takes ``optax.adamw(lr)``'s defaults (b1 0.9, b2
0.999, eps 1e-8, weight decay 1e-4, no clip), as JAX's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from chatts_tpu_torch.core.config import QwenConfig
from chatts_tpu_torch.models import qwen
from chatts_tpu_torch.train.loss import token_nll

PIPE_AXIS = "pp"


@dataclasses.dataclass(eq=False)
class PipeMesh:
    """This rank's stage on a ``pp`` mesh and the group its stages talk in."""

    shape: Dict[str, int]  # {PIPE_AXIS: pp}, as JAX's mesh.shape
    stage: int
    ranks: Tuple[int, ...]  # the world ranks of this rank's pipeline, by stage
    group: Any
    backend: str

    @property
    def pp(self) -> int:
        return self.shape[PIPE_AXIS]

    @property
    def is_first(self) -> bool:
        return self.stage == 0

    @property
    def is_last(self) -> bool:
        return self.stage == self.pp - 1


def create_pp_mesh(pp: int) -> PipeMesh:
    """This rank's stage of a pipeline of ``pp`` stages over the initialized
    world: rank r is stage r % pp of pipeline r // pp (a world of several
    pipelines runs them side by side).  Every rank must call it, in the same
    order as its other group calls."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < pp:
        raise ValueError(f"need {pp} devices, have {world}")
    if world % pp:
        raise ValueError(f"a world of {world} ranks does not split into pipelines of {pp}")
    rank = dist.get_rank()
    mine = None
    for start in range(0, world, pp):
        ranks = tuple(range(start, start + pp))
        group = dist.new_group(list(ranks))
        if rank in ranks:
            mine = (ranks, group)
    return PipeMesh(shape={PIPE_AXIS: pp}, stage=rank % pp, ranks=mine[0], group=mine[1],
                    backend=dist.get_backend())


class StackedLLM(nn.Module):
    """The port of JAX's stacked llm pytree: layers [layer_start,
    layer_start + len(layers)) of the ``cfg.num_hidden_layers``, and the
    embedding, final norm and head where this holder keeps them (None
    elsewhere); ``tied``: the head is the embedding's table."""

    def __init__(self, cfg: QwenConfig, layers: Sequence[qwen.DecoderLayer], layer_start: int,
                 embed_tokens: Optional[torch.Tensor], norm: Optional[torch.Tensor],
                 lm_head: Optional[torch.Tensor], tied: bool):
        super().__init__()
        self.cfg, self.tied = cfg, tied
        self.layers = nn.ModuleList(layers)
        self.layer_start = layer_start
        self.embed_tokens = embed_tokens
        self.norm = norm
        self.lm_head = lm_head

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return qwen.embed_tokens(self.embed_tokens, input_ids)

    def compute_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The float head's logits, f32, as ``QwenModel.compute_logits``."""
        if self.tied:
            return qwen.matmul_f32(hidden, self.embed_tokens.t())
        return qwen.matmul_f32(hidden, self.lm_head)


def _stage_range(n_layers: int, mesh: PipeMesh) -> Tuple[int, int]:
    if n_layers % mesh.pp:
        raise ValueError(f"{n_layers} layers not divisible by pp={mesh.pp}")
    part = n_layers // mesh.pp
    return mesh.stage * part, (mesh.stage + 1) * part


def stack_layers(llm: qwen.QwenModel) -> StackedLLM:
    """A whole float decoder as one stack of its layers, sharing its
    tensors.  A tensor-parallel shard raises: a stage runs whole layers."""
    if llm.mesh is not None and llm.mesh.tp > 1:
        raise ValueError("stack_layers takes a whole decoder, not a tp shard")
    if llm.lm_head_q is not None or any(
            p.kernel is None for layer in llm.layers for p in layer.modules()
            if isinstance(p, qwen.Dense)):
        raise ValueError("the pipeline trains float weights; this decoder is quantized")
    return StackedLLM(llm.cfg, list(llm.layers), 0, llm.embed_tokens, llm.norm, llm.lm_head,
                      _tied(llm))


def _tied(llm) -> bool:
    return llm.cfg.tie_word_embeddings or llm.lm_head is None


def _stage(mesh: PipeMesh, stacked: StackedLLM, copy) -> StackedLLM:
    """The stage's part of ``stacked``, each kept tensor through ``copy``."""
    start, stop = _stage_range(stacked.cfg.num_hidden_layers, mesh)
    have = stacked.layer_start, stacked.layer_start + len(stacked.layers)
    if start < have[0] or stop > have[1]:
        raise ValueError(f"stage {mesh.stage} runs layers [{start}, {stop}); the stack holds "
                         f"[{have[0]}, {have[1]})")
    layers = [copy(layer) for layer in stacked.layers[start - have[0]:stop - have[0]]]

    def kept(t, keep):
        return copy(t) if t is not None and keep else None

    return StackedLLM(stacked.cfg, layers, start,
                      kept(stacked.embed_tokens, mesh.is_first or stacked.tied),
                      kept(stacked.norm, mesh.is_last), kept(stacked.lm_head, mesh.is_last),
                      stacked.tied)


def place_stacked(mesh: PipeMesh, stacked: StackedLLM, device=None) -> StackedLLM:
    """This stage's part of a stack, its tensors copied to ``device`` (the
    stack's own by default): layers [s L/S, (s + 1) L/S), which ``stacked``
    must hold; the embedding on stage 0 and the final norm and head on the
    last (a tied table on every stage)."""
    import copy

    device = torch.device(device) if device is not None else (
        stacked.layers[0].input_layernorm.device)

    def place(x):
        if isinstance(x, nn.Module):
            return copy.deepcopy(x).to(device)
        return nn.Parameter(x.detach().to(device, copy=True).contiguous(), requires_grad=False)

    with torch.no_grad():
        return _stage(mesh, stacked, place)


def init_stage(cfg: QwenConfig, generator: torch.Generator, mesh: PipeMesh, device="cuda",
               dtype=None) -> StackedLLM:
    """This stage's part of ``qwen.init_params(cfg, generator, device,
    dtype)``, equal to ``place_stacked`` of its stack: drawn in the same
    order, keeping only the stage's layers, so no rank holds the whole
    model."""
    start, stop = _stage_range(cfg.num_hidden_layers, mesh)
    llm = qwen.init_params(cfg, generator, device, dtype, keep_layers=range(start, stop))
    stacked = StackedLLM(cfg, list(llm.layers), start, llm.embed_tokens, llm.norm, llm.lm_head,
                         _tied(llm))
    return _stage(mesh, stacked, lambda x: x)


def pipeline_parameters(stacked: StackedLLM) -> List[torch.Tensor]:
    """The stage's float tensors, in a fixed order."""
    return [p for p in stacked.parameters() if p.is_floating_point()]


# ---------------------------------------------------------------------------
# Point to point in the pp group
# ---------------------------------------------------------------------------

def _send(mesh: PipeMesh, x: torch.Tensor, stage: int) -> int:
    """Send ``x`` to ``stage`` of the pipeline; returns the bytes sent."""
    x = x.detach().contiguous()
    if mesh.backend == "gloo" and x.is_cuda:
        x = x.cpu()
    dist.send(x, dst=mesh.ranks[stage], group=mesh.group)
    return x.numel() * x.element_size()


def _recv(mesh: PipeMesh, like: torch.Tensor, stage: int) -> torch.Tensor:
    """A tensor shaped and typed as ``like`` received from ``stage``."""
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if mesh.backend == "gloo" else like.device)
    dist.recv(buf, src=mesh.ranks[stage], group=mesh.group)
    return buf.to(like.device)


def _broadcast_from_last(mesh: PipeMesh, x: torch.Tensor) -> torch.Tensor:
    """The last stage's ``x`` on every stage, in place."""
    dist.broadcast(x, src=mesh.ranks[-1], group=mesh.group)
    return x


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Schedule:
    """One forward run of the schedule on this stage: each microbatch's
    input (a leaf that records its gradient on the stages after the
    first) and output, and the bytes sent."""

    inputs: List[Optional[torch.Tensor]]
    outputs: List[Optional[torch.Tensor]]
    sent_bytes: int = 0


def _run_local(stacked: StackedLLM, x: torch.Tensor, positions: torch.Tensor,
               kv_valid: torch.Tensor) -> torch.Tensor:
    rope = qwen.rope_cos_sin(positions, stacked.cfg.head_dim, stacked.cfg.rope_theta)
    for layer in stacked.layers:
        x, _ = layer(x, positions, rope, None, None, kv_valid, positions, None, False, None,
                     "xla")
    return x


def _forward_schedule(stacked: StackedLLM, mesh: PipeMesh, first_inputs, positions,
                      kv_valid, shape: Tuple[int, ...], dtype, grad: bool) -> _Schedule:
    """The forward ticks.  ``first_inputs(m)`` gives microbatch m's input on
    stage 0; later stages receive theirs.  With ``grad``, autograd records
    each stage's layers and a received input records its gradient."""
    m_count, s_count, s = positions.shape[0], mesh.pp, mesh.stage
    sched = _Schedule([None] * m_count, [None] * m_count)
    like = torch.empty(shape, dtype=dtype, device=positions.device)
    for t in range(m_count + s_count - 1):
        m = t - s
        if not 0 <= m < m_count:
            continue
        if mesh.is_first:
            x = first_inputs(m)
        else:
            x = _recv(mesh, like, s - 1)
            x.requires_grad_(grad)
        sched.inputs[m] = x
        with torch.set_grad_enabled(grad):
            y = _run_local(stacked, x, positions[m].to(torch.int32), kv_valid[m].bool())
        if mesh.is_last:
            sched.outputs[m] = y
        else:
            sched.sent_bytes += _send(mesh, y, s + 1)
            sched.outputs[m] = y if grad else None
    return sched


def pipeline_forward(
    stacked: StackedLLM,
    cfg: QwenConfig,
    embeds: Optional[torch.Tensor],  # (M, mb, T, hidden) microbatched inputs; stage 0 reads them
    positions: torch.Tensor,  # (M, mb, T)
    kv_valid: torch.Tensor,  # (M, mb, T) bool
    *,
    mesh: PipeMesh,
) -> torch.Tensor:
    """Run the decoder stack pipeline-parallel.  Returns the hidden state
    (M, mb, T, hidden) after the final norm on every stage, as JAX's does.

    Schedule: M + S - 1 ticks; at tick t, stage s runs microbatch t - s
    (when in range) through its local layers and sends the activation to
    the next stage.  The forward only: ``make_pp_train_step`` runs the
    schedule's backward."""
    m, mb, t_len = positions.shape
    if cfg.num_hidden_layers % mesh.pp:
        raise ValueError(f"{cfg.num_hidden_layers} layers not divisible by pp={mesh.pp}")
    if mesh.is_first and embeds is None:
        raise ValueError("stage 0 takes the microbatched embeddings")
    dtype = embeds.dtype if embeds is not None else _dtype(stacked)
    shape = (mb, t_len, cfg.hidden_size)
    with torch.no_grad():
        sched = _forward_schedule(stacked, mesh, lambda i: embeds[i], positions, kv_valid,
                                  shape, dtype, grad=False)
        if mesh.is_last:
            out = qwen.rms_norm(torch.stack(sched.outputs), stacked.norm, cfg.rms_norm_eps)
        else:
            out = torch.empty((m,) + shape, dtype=dtype, device=positions.device)
        return _broadcast_from_last(mesh, out)


def _dtype(stacked: StackedLLM) -> torch.dtype:
    return stacked.layers[0].input_layernorm.dtype


@dataclasses.dataclass(frozen=True)
class PipelineTrainConfig:
    learning_rate: float = 1e-5
    microbatches: int = 2


class PipelineOptimizer:
    """``optax.adamw(lr)`` in PyTorch: ``init(stacked)`` gives the stage's
    ``torch.optim.AdamW`` with optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
    weight decay 1e-4), the state JAX's ``optimizer.init`` returns."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, stacked: StackedLLM) -> torch.optim.AdamW:
        params = pipeline_parameters(stacked)
        for p in params:
            p.requires_grad_(True)
        return torch.optim.AdamW(params, lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)


def make_pp_train_step(cfg: QwenConfig, mesh: PipeMesh, tc: PipelineTrainConfig):
    """GPipe train step.  Returns (step, optimizer): ``opt_state =
    optimizer.init(stacked)``, then ``stacked, opt_state, metrics =
    step(stacked, opt_state, batch)`` (every stage calls it with the whole
    batch; the parameters and the state are updated in place).  The metrics
    ("loss", "tokens", and "sent_bytes", this stage's P2P bytes) are on
    every stage."""
    optimizer = PipelineOptimizer(tc.learning_rate)

    def step(stacked: StackedLLM, opt_state: torch.optim.AdamW, batch: Dict[str, torch.Tensor]):
        m = tc.microbatches
        ids = batch["input_ids"]
        b, t_len = ids.shape
        if b % m:
            raise ValueError(f"batch {b} not divisible by microbatches {m}")
        if cfg.num_hidden_layers % mesh.pp:
            raise ValueError(f"{cfg.num_hidden_layers} layers not divisible by pp={mesh.pp}")
        mb = b // m

        def split(x):
            return x.reshape((m, mb) + tuple(x.shape[1:]))

        ids_m, positions = split(ids), split(batch["positions"])
        kv_valid = split(batch["attention_mask"]).bool()
        opt_state.zero_grad(set_to_none=True)
        sched = _forward_schedule(stacked, mesh, lambda i: stacked.embed(ids_m[i]), positions,
                                  kv_valid, (mb, t_len, cfg.hidden_size), _dtype(stacked),
                                  grad=True)
        loss = torch.zeros((), dtype=torch.float32, device=ids.device)
        tokens = torch.clamp(batch["loss_mask"].float().sum(), min=1.0)
        # The backward ticks, in reverse: microbatch M - 1 first.
        for i in reversed(range(m)):
            y = sched.outputs[i]
            if mesh.is_last:
                targets, mask = split(batch["targets"])[i], split(batch["loss_mask"])[i]
                hidden = qwen.rms_norm(y, stacked.norm, cfg.rms_norm_eps)
                nll = token_nll(stacked.compute_logits(hidden), targets)
                # The microbatch's share of the whole batch's masked mean.
                part = (nll * mask.float()).sum() / tokens
                part.backward()
                loss += part.detach()
            else:
                grad = _recv(mesh, y, mesh.stage + 1)
                torch.autograd.backward(y, grad)
            if not mesh.is_first:
                sched.sent_bytes += _send(mesh, sched.inputs[i].grad, mesh.stage - 1)
        if mesh.pp > 1 and stacked.tied:
            # The tied table's gradients of the first and the last stage.
            g = stacked.embed_tokens.grad
            g = torch.zeros_like(stacked.embed_tokens) if g is None else g
            dist.all_reduce(g, group=mesh.group)
            stacked.embed_tokens.grad = g
        opt_state.step()
        loss = _broadcast_from_last(mesh, loss)
        return stacked, opt_state, {"loss": loss, "tokens": tokens,
                                    "sent_bytes": sched.sent_bytes}

    return step, optimizer
