#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``chatts_tpu_torch``) on one H100.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``chatts_tpu_torch/csrc`` and runs:

  0. environment: card, power limit, torch, CUDA, nvcc;
  1. build: nvcc time and each kernel's registers and spills;
  2. each kernel against its plain PyTorch version at the main paths' shapes,
     with the device times (CUDA graph replay, CUDA events) of the kernel,
     the plain version and, where one exists, one PyTorch call computing the
     same function, and the kernel's bound; the prefill attention with both
     of its query tiles, beside the plain version of its own tile loop; the
     decode attention (bf16 and int8 cache) twice to the bit, beside the
     plain version of its split and merge, with other chunks, and the int8
     one replayed from a CUDA graph with other lengths; the int4 matmul on
     each of its paths at every R, and the int8-activation matmul (B5) at the
     rows of an a8 prefill, bit-equal to its plain version, with both of its
     block widths at few rows; both int4 matmuls at the unfused widths of an
     imported GPTQ checkpoint (OUT 1,024, 5,120, 13,824); the prefill
     attention at the chunked paths' shapes (512 queries over a 2,048
     prefix, 64 over 2,048 and 4,096) and the int4 matmul at a mixed step's
     280 rows; B1, B2 and B3 at the shapes of phases 13, 13q and 8f (the 8B
     shape's 28 heads over 4 kv heads, G = 7; Qwen3-8B's 32 over 8; the 14B
     bf16 cache at cap 6,144; every projection and head of both models at
     32 and 4,096 rows); the decoder glue's kernels (``add_rms_norm``,
     ``silu_mul``, ``qkv_decode``) against their eager compositions at the
     14B and Qwen3-8B shapes (B = 32, and R = 4,096 for the first two),
     beside the eager composition's time, the bound and, for the norm,
     ``F.rms_norm``; and the decode step at full depth with the glue fused
     and eager.  On every later path no glue call site whose gate lets it
     through (CUDA bf16, autograd off, no mesh) may run eagerly, and no
     captured step may but a prefill's or mixed step's qkv epilogue;
  3. the ChatTS-14B widths at 2 layers, int4 weights: logits of the kernel
     path on the card against the plain path on the CPU in f32;
  3c. the same with int8-activation prefill (``act_int8``), against the
     plain a8 path on the CPU in f32, and beside the card's bf16 prefill;
  3b. the same widths with an int8 KV cache through ``ServeEngine``: one
     monolithic admission and 8 decode steps on the card, run eagerly, their
     logits held against the same schedule on the CPU (plain versions, f32,
     the same int8 quantization, the card's tokens fed back); then the same
     schedule replayed from the engine's decode graph, token-identical; then
     a runner and a late request admitted by a fused block round
     (``block_early_emit`` off), whose decode chunk replays the decode graph,
     token-identical to the same schedule run eagerly;
  3d. the same widths with an int8 KV cache: a runner decodes while a
     ~700-token request is admitted by two scan-sliced mixed rounds (block
     budget 0), driven on this thread, every round eager; the runner's
     logits of every step and the admission's first-token logits held
     against the same schedule on the CPU (plain versions, f32, the card's
     tokens fed back); then the schedule with the mixed rounds replayed from
     their two graphs, token-identical;
  4. the batch slice at full size: ChatTS-14B shape (48 layers, int4, random
     weights from a seed), 4 prompts with series, ``InferenceEngine.generate``
     greedy twice and sampled twice, decoding from the decode step's CUDA
     graph (one capture a key, reused by the second call), each pair
     token-identical, every kernel of the path launched; then greedy and
     sampled once with the decode chunks run eagerly, the same tokens; then
     one decode step replayed from its graph, its device time by CUDA
     events and under ``torch.profiler`` the decode attention's share;
  5. the serving slice at full size, on phase 4's weights: ``ServeEngine`` at
     the 14B serving configuration (24 slots, cap 1024, int8 KV, decode chunk
     32, early emit) behind ``ChatTSServer`` on 127.0.0.1.  Two waves of 8
     bench-like chat requests with two series each (the second wave joins
     while the first decodes, one request streams), twice, token-identical,
     every kernel of the path launched; then 4 steps of a decode round under
     ``torch.profiler``, its top kernels by device time and the int8 decode
     attention's share;
  6. phases 4 and 5 again with ``prefill_act_int8=True`` on the same weights:
     ``InferenceEngine`` greedy twice and the same two serving runs, each
     pair token-identical, B5 launched once per int4 projection per prefill
     and never in decode or for the head (the decode round is phase 5's and
     is not profiled again);
  7. a checkpoint from disk, the user's path: (a) a ChatTS-14B GPTQ-Int4
     directory synthesized in the published format (48 layers, symmetric;
     fewer, said so, if the disk cannot hold them) under a temporary
     directory removed at the end, (b) ``weights.diagnose``, (c)
     ``load_checkpoint(quantize_bits=4)`` onto the card, every projection
     and the head in the int4 layout, unfused, (d) layers 0 and 47 bit-equal
     to the CPU's conversion and, dequantized, to ``gptq.dequantize``, (e)
     2 layers of the directory on the card against the same on the CPU in
     f32 (plain path), bf16 and act_int8 prefill, (f) phase 4's batch through
     ``InferenceEngine`` on the loaded model, greedy twice, token-identical,
     and once with act_int8, (t) tensor parallelism: two ranks on cuda:0
     over gloo each load their tp shard of the directory
     (``load_checkpoint(mesh=)``), compute phase 4's first-step logits
     (held to 3% of the largest of (c)'s model's), generate phase 4's batch
     (tokens against (f)'s) and serve 4 requests with an int8 KV cache, rank
     0 driving and rank 1 in ``follow()`` (first-token logits held the same
     way against a single-device ``ServeEngine``), each rank's launches of
     B1 to B4 summed as the path "tp", and the times, with the share of a
     decode step in collectives; then, in the same world, each rank loads
     the whole model on a dp = 2, tp = 1 mesh and the two replicas serve the
     same 4 requests, world rank 0 driving and the other rank following:
     the tokens must equal the single-device engine's (path "dp_serve"),
     (g) the model served through
     ``examples/serve_openai.py``'s ``build`` at phase 5's configuration, one
     wave of 8 chat requests twice, token-identical, (h) the activation-order
     and asymmetric exports at 2 layers, ``perm4`` and ``zeros4`` on the
     card, logits as in (e);
  8. (run before phase 7, on phase 4's weights) chunked prefill and the
     scan-sliced mixed admission at full size: (a) phase 4's batch with
     ``prefill_chunk=512``, greedy twice, token-identical, first-token
     logits held to the monolithic prefill's; (b) ``ServeEngine`` at 24
     slots, cap 6,144, int8 KV, decode chunk 32 behind ``ChatTSServer``: 8
     of phase 5's requests, then, while they decode, 4 requests of 2,400 to
     2,900 tokens that no block takes, admitted by two mixed rounds (npt 64,
     kv_limit 2,048 then 4,096); (c) the same engine with
     ``prefill_chunk=1024`` and the 4 long requests on an idle engine; each
     twice, token-identical, with the kernels' launches and shapes inside
     the chunked and mixed regions; (e) 8b's schedule with eager mixed
     rounds, token-identical to 8b's, whose mixed rounds replay one graph
     per (a, npt, kv_limit); 8c's wave sampled from one seed with the mixed
     rounds from the graphs and eager, token-identical; each mixed round's
     host seconds beside its device time (CUDA events around its replays);
     then 4 steps of a mixed round under ``torch.profiler``; (f) 8b's
     schedule with the bf16 cache (24 slots, cap 6,144: 29 GB of cache):
     the two scan-sliced rounds from the mixed graphs, token-identical to
     the same schedule with eager mixed rounds;
  9. (after phase 7, every earlier model freed) training: (a) the 14B
     widths at 2 layers, bf16 float weights from ``init_params``, 2 SFT rows
     of 234 tokens: the LoRA loss and every adapter gradient (b nonzero,
     remat) held to the CPU's f32 plain path on the same weights, the merged
     export loaded back bit-equal to ``merge_lora``, one full-parameter
     AdamW step moving every tensor; (b) ``train_lora_sft`` on the 48-layer
     ChatTS-14B shape (bf16, rank 8, remat, batch 2 x 1,024 tokens, two
     256-point series a row), 4 steps twice from one seed, the same losses,
     every b with a gradient at step 1 and every a at step 2; step time,
     tokens/s, peak memory, and one step under ``torch.profiler`` by part
     (projections, plain attention, LoRA merge, recompute, loss, each with
     its backward).  No kernel launches on the training path.
 9t. (after phase 9, every model freed) training on a tensor-parallel mesh:
     two ranks on cuda:0 over gloo, each drawing 9a's and 9b's weights from
     their seed and cutting each layer as it is drawn (no rank holds the
     whole model): (a) 9a's 2-layer LoRA loss and every adapter gradient,
     whole-shaped after the sum over tp, against 9a's on one card; (b)
     9b's ``train_lora_sft`` on the rank's shard of the 48 layers, 3 steps:
     the losses equal on both ranks, step 1's against 9b's, every b with a
     gradient at step 1 and every a at step 2; step seconds, the share of a
     step in collectives (each timed between device syncs), peak memory a
     rank.
 12. (in 9t's world) GPipe at pp = 2: (a) ``pipeline_forward`` of 9b's 48
     bf16 layers, 24 a stage, 2 microbatches of 1 x 1,024 tokens, the last
     positions' logits against the single-stage forward of 9b's model; (b)
     ``make_pp_train_step`` at the 14B widths in f32 with 4 layers, 2 a
     stage, 3 steps on one batch: step 1's loss against the single-stage
     loss, the loss falling; step seconds, P2P bytes and seconds a step.
     Neither launches a kernel (``attn_impl="xla"``, float weights).
 10. (after phase 8, on phase 4's weights) ChatTS's batch evaluation, the
     path of ``scripts/run_eval.sh``: 48 samples of
     ``eval/make_eval_dataset.py::build_dataset`` (one series of 64 to 1,024
     points, 3 or 4 numbered questions) at phase 5's engine configuration
     (24 slots, int8 KV, decode chunk 32, early emit, cap 1,024 or the next
     multiple of 512 that holds a prompt and 512 tokens): (a) 8 of them
     greedy, 64 new tokens, through ``LLMClient("tpu-ts")`` twice, the same
     answers; (b) ``chatts_tpu_torch/scripts/run_eval.py::main`` on all 48 at
     the reference eval envelope (max_tokens 512, temperature 0.2), scored
     with 8 workers in this process; every answer, one scored entry per
     sample, samples/min, output tokens/s, TTFT, the decode rounds' host
     times and the scoring seconds.
 11. (after phase 10, on phase 4's weights) the dataset scripts, the path of
     ``scripts/generate_align_datasets.sh`` and ``generate_sft_datasets.sh``:
     (a) both of the port's scripts on the CPU with a scripted LLM whose
     every answer is 1,024 words, which sizes the cache for the longest
     prompt; (b) ``examples/serve_openai.py``'s ``build`` at phase 5's
     engine configuration (24 slots, int8 KV, decode chunk 32, early emit)
     on 127.0.0.1, ``CHATTS_LLM_URL`` pointing at it, and
     ``chatts_tpu_torch/scripts/generate_align_datasets.py::main`` then
     ``generate_sft_datasets.py::main`` at NUM_DATA 4: every stage's files,
     no hole left and the JAX package's label keys in the three
     hole-filling stages, the template files byte-equal to (a)'s, one
     request a prompt, each ended at EOS or 1,024 tokens; per stage its
     prompts, rows, parse failures and seconds, and output tokens/s and
     TTFT over the phase.  Its answers are noise at random weights, so it
     runs on the first ``DATAGEN_LAYERS`` layers of phase 4's model.
 13. (after phase 12, every model freed) the reference's headline serving
     configuration (``bench.py:1-8,253-263,476-507``): the 8B shape at full
     width and depth (28 layers), random int4 weights from a seed,
     ``ServeEngine`` at 32 slots, cap 1,024, the bf16 KV cache, admission
     bucket 8, decode chunk 32, early first tokens; bench.py's requests
     (500 prompt tokens, series of 256 and 512 points, greedy): 8 on
     an idle engine, 24 by three block rounds while they decode, 64 tokens
     with all 32 slots live, a burst of 8 while 24 decode, one alone; twice,
     token-identical; a shorter schedule from the decode graph against
     eager rounds, token-identical; TPOT and tokens/s at c32, the burst's
     and the single request's TTFT, the replayed step's device time, the
     captures and the peak memory; then the 2-layer logit check and the
     per-layer check against the CPU;
 13q. the Qwen3 decoder at Qwen3-8B's published widths and depth (36
     layers, q/k norms drawn in [0.5, 1.5]): written by ``save_checkpoint``
     and read back by ``load_checkpoint(quantize_bits=4)``, bit-equal to
     what was written; served as phase 13 with the bf16 cache and once with
     the int8 cache; the 2-layer and per-layer checks; a LoRA step of 2
     layers at its widths against the CPU, as 9a.

The per-layer check (phases 7e, 7h, 13, 13q) holds each decoder layer on
the card to the same layer on the CPU in f32 on the card's own input to it.

The engines replay CUDA graphs on the card (``runtime/graphs.py``): the
batch decode step, the serving decode step (pure decode rounds and fused
block rounds) and the mixed step.  A kernel wrapper counts a kernel inside a
graph once, at its capture; ``GraphLedger`` counts each graph's replays.

It prints a JSON line of per-kernel results (the kernel's, the plain
version's and the library call's device times, the bound and what sets it,
the launches by path and the graphs' replays), one of the decoder glue's
kernels and the decode step fused and eager,
the card's name and power limit, then as its last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero; there
is no CPU path.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time

# Tolerances, each with its reason.
# Kernels against their plain versions, both in bf16 on the card: the outputs
# are rounded to bf16 (relative 2**-9 each side, so one ulp apart at worst);
# the plain int4 matmul also rounds each dequantized weight to bf16, and the
# plain attention rounds normalised probabilities where the kernel rounds
# probabilities relative to a running max.  |got - ref| <= ATOL + RTOL * |ref|.
KERNEL_ATOL = 2e-2
KERNEL_RTOL = 2e-2
# The int8 decode attention (B4) against its plain version: both compute in
# f32 and round the output to bf16, so they differ by at most one bf16 ulp,
# at most 2**-7 of the element and so of its row's largest.  A long row's
# outputs average thousands of positions and are small (about 0.02 at
# length 6000), below KERNEL_ATOL itself, so B4 is held per (row, head) to a
# share of that row's largest output: |got - ref| <= 2e-2 * max_D |ref|.
# Dropping one 128-key tile past 4096, or an off-by-one scale index within a
# tile, moves a long row by 11% to 28% of its largest output.
INT8_ROW_RTOL = 2e-2
# Model logits, bf16 kernel path on the card against f32 plain path on the CPU:
# two decoder layers of bf16 activations (8-bit mantissa) through rms_norm,
# attention and the MLP.  The kernels keep the int4 weights exact in f32, and
# the difference measured on an H100 was 0.34% of the largest logit; allow
# 1.5% of the largest plain logit.  Phase 3c holds the int8-activation
# prefill to the same rule: its codes come from bf16 activations on the card
# and f32 ones on the CPU, so a code may differ by one step (1/127 of its
# row's largest value), the same order as a bf16 rounding.
LOGIT_RTOL_OF_MAX = 1.5e-2
# Phase 3b adds the int8 KV cache on both sides.  The codes are rounded from
# bf16 activations on the card and f32 ones on the CPU, so a code may differ
# by one step (1/127 of its row's largest value, the same order as a bf16
# rounding), and decode reads the quantized cache.  The same 1.5% of the
# largest plain logit holds.
SERVE_LOGIT_RTOL_OF_MAX = 1.5e-2
# B5 against its plain version, both on the card: every group's int32 sum is
# exact (at most 128 * 127 * 8 < 2**24), and both add f32(sum) * s_g in group
# order and round once to bf16, so they differ by at most one bf16 ulp of the
# plain result (2**-7 of its magnitude at most).
A8_ULP_RTOL = 2.0 ** -7
# int4_matmul against the plain version of its own arithmetic
# (int4_matmul_grouped_reference: per group an f32 sum, times the scales,
# added in group order), both on the card: only the order of the f32 sums
# inside a group differs (tensor cores against cuBLAS), which moves the f32
# result by a few units of 2**-24 of the row's magnitudes; the one rounding
# to bf16 may then land one ulp apart (2**-7 of the output at most).
# |got - ref| <= 2**-7 |ref| + 2**-16 max_row |ref|, the second term for
# outputs that cancel to near zero.
INT4_ULP_RTOL = 2.0 ** -7
INT4_ROW_ATOL = 2.0 ** -16
# Projections of one decoder layer at the 14B int4 shape (fused qkv and
# gate_up): each prefill launches B5 this many times a layer.
INT4_PROJECTIONS_PER_LAYER = 4
# The 14B int4 projections, and the rows phase 2 times them at: decode (1,
# 4), serving's decode round (16, 24 slots), admissions (37, 64, 640), a
# scan-sliced mixed step (280: 24 slots and 4 rows of 64 prompt tokens) and
# a serving wave's or the batch's prefill (4096, 5120; not the head, which
# runs on the last positions only).
INT4_SHAPES = {"qkv": (5120, 7168), "o": (5120, 5120), "gate_up": (5120, 27648),
               "down": (13824, 5120), "lm_head": (5120, 152064)}
INT4_ROWS = (1, 4, 16, 24, 37, 64, 280, 640)
INT4_PREFILL_ROWS = (4096, 5120)
# An imported GPTQ checkpoint keeps q/k/v and gate/up apart, as the reference
# server does: k and v 5120->1024, q and o 5120->5120, gate and up
# 5120->13824 (down is INT4_SHAPES' down). Phase 2 times B3 and B5 there at
# the rows of decode (1), serving's decode round (24) and the serving and
# batch prefills (4096, 5120).
INT4_UNFUSED_OUT = (1024, 5120, 13824)
INT4_UNFUSED_ROWS = (1, 24, 4096, 5120)
# One H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W): the
# least time a call could take is the larger of its bytes over the memory
# rate and its operations over the peak for their type.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_S = 989e12
PEAK_INT8_S = 1979e12
PEAK_F32_S = 67e12  # outside the tensor cores

SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints one line per phase with its result and seconds; an exception
    propagates and fails the run."""

    def __init__(self, number: int, name: str):
        self.number, self.name = number, name

    def __enter__(self):
        self.start = time.perf_counter()
        log(f"[phase {self.number}] {self.name} ...")
        return self

    def __exit__(self, exc_type, exc, tb):
        seconds = time.perf_counter() - self.start
        result = "ok" if exc_type is None else f"FAILED ({exc_type.__name__}: {exc})"
        log(f"[phase {self.number}] {self.name}: {result} ({seconds:.1f} s)")
        return False


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing and comparison helpers
# ---------------------------------------------------------------------------

def time_ms(fn, target_s: float = 0.2) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around a run of many
    calls, after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(min(200, max(3, target_s * 1e3 / once)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, target_s: float = 0.2) -> float:
    """Mean device time of ``fn`` in ms, without the host's work per call:
    up to 20 calls captured in one CUDA graph, replayed between CUDA events
    after warm-up calls.  A wrapper's Python work per call (checks,
    allocation, the launch) would otherwise bound a short kernel's time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(side):
        fn()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    calls = max(1, min(20, int(2.0 / max(start.elapsed_time(end), 1e-3))))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    replays = int(min(50, max(2, target_s * 1e3 / once)))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def compare(got, ref, what: str, row_rtol: float = 0.0) -> float:
    """Max abs error; raises unless |got - ref| <= ATOL + RTOL * |ref|, or,
    with ``row_rtol``, unless |got - ref| <= row_rtol * max |ref| over the
    last axis."""
    import torch

    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (got - ref).abs()
    if row_rtol:
        bad = err > row_rtol * ref.abs().amax(dim=-1, keepdim=True)
    else:
        bad = err > KERNEL_ATOL + KERNEL_RTOL * ref.abs()
    if bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements out of tolerance, max abs err "
            f"{float(err.max()):.4g}")
    return float(err.max())


def rotating(make, nbytes: int, min_total: int = 256 << 20):
    """Enough copies of an input set that cycling through them reads more than
    the 50 MB L2 cache, so a timed call finds its data cold, as it would in
    the model (every layer has its own weights and cache)."""
    return [make(i) for i in range(max(1, math.ceil(min_total / max(nbytes, 1))))]


def bound(nbytes: float, ops: float, peak: float):
    """(bound_ms, bound_by): the larger of nbytes at the memory rate and ops
    at ``peak``."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int4_bound(r: int, in_dim: int, out_dim: int):
    """int4_matmul's bound: packed weights, scales, x and y once each; 2 R IN
    OUT bf16 operations."""
    nbytes = in_dim * out_dim // 2 + in_dim // 128 * out_dim * 4 + 2 * r * (in_dim + out_dim)
    return bound(nbytes, 2.0 * r * in_dim * out_dim, PEAK_BF16_S)


def _model_gb(model) -> float:
    """GB of a model's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers())) / 1e9


def int4pack_library(torch, i4, packed, scales):
    """``torch._weight_int4pack_mm``'s operands for the same weights:
    unsigned codes q + 8 in its packed layout (``_convert_weight_to_int4pack``,
    8 inner K tiles) and (groups, OUT, 2) bf16 scales with zeros 0, which it
    applies as (code - 8) * scale + zero.  Made once, outside any timing."""
    codes = (i4.unpack_values(packed) + 8).t().contiguous()  # (OUT, IN), 0..15
    w = ((codes[:, 0::2] << 4) | codes[:, 1::2]).to(torch.uint8)
    w = torch._convert_weight_to_int4pack(w.contiguous(), 8)
    sz = torch.stack([scales, torch.zeros_like(scales)], dim=-1).to(torch.bfloat16)
    return w, sz.contiguous()


def kernel_wrappers():
    """Every kernel's wrapper by name, the decoder glue's (``GLUE``) last;
    each counts its launches."""
    from chatts_tpu_torch.ops import flash_attention as fa
    from chatts_tpu_torch.ops import fused_glue as glue
    from chatts_tpu_torch.ops import int4_matmul as i4
    from chatts_tpu_torch.ops import ragged_decode_attention as rda

    return {"flash_attention": fa.flash_attention,
            "ragged_decode_attention": rda.ragged_decode_attention,
            "ragged_decode_attention_int8": rda.ragged_decode_attention_int8,
            "int4_matmul": i4.int4_matmul,
            "int4_matmul_a8": i4.int4_matmul_a8,
            "add_rms_norm": glue.add_rms_norm,
            "silu_mul": glue.silu_mul,
            "qkv_decode": glue.qkv_decode}


# The decoder glue's kernels (csrc/fused_glue.cu), which replace no TPU
# kernel (XLA fuses the glue there).
GLUE = ("add_rms_norm", "silu_mul", "qkv_decode")


def glue_eager() -> dict:
    """The glue's call sites that ran eagerly so far, process-wide (the
    CPU's plain runs and training included), by kernel."""
    from chatts_tpu_torch.ops import fused_glue

    return dict(fused_glue.eager)


class GlueWatch:
    """Wraps ``models/qwen.py``'s ``add_rms_norm`` and ``silu_mul`` for the
    run: counts, by kernel, the calls whose gate let them through (CUDA bf16
    tensors, autograd off, no mesh: ``fused_glue.engaged``) that still ran
    eagerly, their shapes not the kernel's.  ``mark`` and ``read`` bracket a
    path, as ``reset_launches`` and ``read_launches`` do."""

    def __init__(self):
        from chatts_tpu_torch.models import qwen
        from chatts_tpu_torch.ops import fused_glue

        self.fallbacks, self.since = dict.fromkeys(GLUE[:2], 0), {}
        for name in self.fallbacks:
            setattr(qwen, name, self._watch(name, getattr(qwen, name),
                                            getattr(fused_glue, name), fused_glue.engaged))

    def _watch(self, name, inner, kernel, engaged):
        import inspect

        signature = inspect.signature(inner)

        def watched(*args, **kw):
            before = kernel.launches
            out = inner(*args, **kw)
            given = signature.bind(*args, **kw).arguments
            if kernel.launches == before and engaged(given.get("mesh"), *(
                    a for a in given.values() if hasattr(a, "is_cuda"))):
                self.fallbacks[name] += 1
            return out
        return watched

    def mark(self) -> None:
        self.since = dict(self.fallbacks)

    def read(self) -> dict:
        return {k: n - self.since.get(k, 0) for k, n in self.fallbacks.items()}


def check_glue_captures(stats: dict, cfg, path: str) -> None:
    """Raises unless each decode-step capture in a ``ServeEngine``'s
    ``stats()`` ran the decoder glue fused at every call site (4 a layer
    and the final norm) and eagerly at none."""
    want = {"fused": 4 * cfg.llm.num_hidden_layers + 1, "eager": 0}
    for cap in stats["graph_captures"]:
        if cap["kind"] == "decode" and cap["glue_calls"] != want:
            raise AssertionError(f"the {path} path's decode-step capture ran the glue "
                                 f"{cap['glue_calls']}, not {want}")


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
    if GRAPH_LEDGER is not None:
        GRAPH_LEDGER.mark()
    if GLUE_WATCH is not None:
        GLUE_WATCH.mark()


def read_launches(path: str, required) -> dict:
    """Every kernel's launches since ``reset_launches``; raises unless each
    kernel in ``required`` launched, and if a glue call site that its gate
    let through ran eagerly (``GLUE_WATCH``).  A kernel inside a CUDA graph
    counts once where the graph is captured; the graphs' replays since
    ``reset_launches`` are logged and kept by ``GRAPH_LEDGER``, per path."""
    launches = {name: fn.launches for name, fn in kernel_wrappers().items()}
    log(f"  kernel launches on the {path} path: {launches}")
    fallbacks = GLUE_WATCH.read() if GLUE_WATCH is not None else {}
    if any(fallbacks.values()):
        raise AssertionError(f"the {path} path ran the decoder glue eagerly on CUDA bf16 "
                             f"inference tensors: {fallbacks}")
    if GRAPH_LEDGER is not None:
        for kernels, replays in GRAPH_LEDGER.read(path):
            log(f"  a CUDA graph on the {path} path replayed {replays} times, each replay "
                f"launching {kernels}")
    for name in required:
        if launches[name] < 1:
            raise AssertionError(f"the {path} path never launched {name}")
    return launches


class _CountedGraph:
    """A captured graph whose replays are counted."""

    def __init__(self, graph, entry: dict):
        self.graph, self.entry = graph, entry

    def replay(self) -> None:
        self.entry["replays"] += 1
        self.graph.replay()


class GraphLedger:
    """Wraps ``runtime/graphs.py::capture`` for the run: for each CUDA graph
    the engines capture, the kernels its one step launches (each wrapper
    counts those once, at the capture) and its replays (which no wrapper
    sees).  ``mark`` and ``read`` bracket a path, as ``reset_launches`` and
    ``read_launches`` do; ``by_path`` keeps each path's (kernels a replay,
    replays) per graph."""

    def __init__(self):
        from chatts_tpu_torch.runtime import graphs

        self.module, self.inner = graphs, graphs.capture
        self.graphs, self.since, self.by_path = [], {}, {}
        graphs.capture = self._capture

    def _capture(self, warmup, step, generator, pool=None):
        entry = dict(kernels={}, replays=0)

        def counted_step():
            before = {k: fn.launches for k, fn in kernel_wrappers().items()}
            eager = glue_eager()
            step()
            entry["kernels"] = {k: fn.launches - before[k] for k, fn in kernel_wrappers().items()
                                if fn.launches > before[k]}
            entry["glue_eager"] = {k: n - eager[k] for k, n in glue_eager().items()}

        graph, pool_bytes = self.inner(warmup, counted_step, generator, pool)
        self.graphs.append(entry)
        # A step that runs a glue kernel runs every call site fused but a
        # prefill's or mixed step's qkv epilogue (the steps that launch the
        # prefill attention), which has no kernel; a decode step's, one qkv
        # epilogue and one SiLU a layer.
        ran = entry["kernels"]
        allowed = ("qkv_decode",) if "flash_attention" in ran else ()
        strays = {k: n for k, n in entry["glue_eager"].items() if n and k not in allowed}
        if any(k in ran for k in GLUE) and (strays or (
                not allowed and ran.get("qkv_decode") != ran.get("silu_mul"))):
            raise AssertionError(f"a CUDA graph's step ran the decoder glue eagerly at "
                                 f"{strays}, launching {ran}")
        return _CountedGraph(graph, entry), pool_bytes

    def mark(self) -> None:
        self.since = {id(e): e["replays"] for e in self.graphs}

    def read(self, path: str) -> list:
        out = [[e["kernels"], e["replays"] - self.since.get(id(e), 0)] for e in self.graphs
               if e["replays"] > self.since.get(id(e), 0)]
        self.by_path[path] = out
        return out


GRAPH_LEDGER = None  # main() installs a GraphLedger
GLUE_WATCH = None  # and a GlueWatch


# ---------------------------------------------------------------------------
# Phases 0-2: environment, build, kernels
# ---------------------------------------------------------------------------

def phase_environment():
    import torch

    with Phase(0, "environment"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: this script runs only on the card")
        smi = nvidia_smi_line()
        log(f"  nvidia-smi: {smi}")
        log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} device(s), {torch.cuda.get_device_name(0)}")
        cap = torch.cuda.get_device_capability(0)
        log(f"  capability {cap}")
        if tuple(cap) != (9, 0):
            raise RuntimeError(f"the kernels are built for sm_90a; this card is {cap}")
        from chatts_tpu_torch.kernels import build

        nvcc = subprocess.run([build.nvcc_path(), "--version"], check=True,
                              capture_output=True, text=True, timeout=60)
        log("  nvcc: " + nvcc.stdout.strip().splitlines()[-1])
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return smi


def phase_build():
    from chatts_tpu_torch.kernels import build

    with Phase(1, "build"):
        start = time.perf_counter()
        infos = build.build()
        log(f"  built {len(infos)} libraries in {time.perf_counter() - start:.1f} s "
            f"(nvcc {', '.join(f'{i.name} {i.seconds:.1f} s' for i in infos)})")
        for info in infos:
            for line in info.log.splitlines():
                if any(key in line for key in ("registers", "spill", "arning")):
                    log(f"  {info.name}: {line.strip()}")


def _flash_case(torch, gen, t: int, dev, b: int = 4, s: int = 0, q0=None, h: int = 40,
                kvh: int = 8):
    """B rows of T queries over S keys (S = T unless given) at the 14B head
    shape (or H heads over KVH kv heads).  The queries are positions q0 ..
    q0 + T of S (the last T unless
    given: a prefill chunk's or a mixed step's queries over a cache prefix
    sit earlier, and the keys after them are masked by position); the rows
    are valid up to S, S - 37, S - 300 and S / 2 in turn, and every fourth
    row's first 5 keys are invalid: with T = S its queries 0..4 have no
    valid key."""
    d = 128
    s = s or t
    q0 = s - t if q0 is None else q0
    q = torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, kvh, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, kvh, d), generator=gen, device=dev).to(torch.bfloat16)
    kv_pos = torch.arange(s, dtype=torch.int32, device=dev)[None].repeat(b, 1).contiguous()
    q_pos = (kv_pos[:, :t] + q0).contiguous()
    seq_lens = torch.tensor(([s, s - 37, s - 300, s // 2] * -(-b // 4))[:b], device=dev)
    kv_valid = kv_pos < seq_lens[:, None]
    kv_valid[3::4, :5] = False
    return q, k, v, q_pos, kv_pos, kv_valid.contiguous()


def _library_ms(torch, out, ref, call, what: str, rows=None) -> float:
    """The device time of ``call``, one PyTorch call computing the kernel's
    function, after its output ``out`` is held against the plain version
    (on ``rows`` only, where given)."""
    torch.cuda.synchronize()
    if rows is not None:
        out, ref = out[rows], ref[rows]
    compare(out, ref, f"{what}, library call")
    return graph_ms(call)


def _int4_weights(torch, gen, dev, in_dim: int, out_dim: int):
    """Random packed weights with some 0x88 bytes (both nibbles -8), and
    scales that keep the outputs near 1."""
    packed = torch.randint(-128, 128, (in_dim // 2, out_dim), generator=gen, device=dev,
                           dtype=torch.int8)
    packed[0, :7] = -120  # 0x88
    scales = (torch.rand((in_dim // 128, out_dim), generator=gen, device=dev) + 0.5) \
        / (7 * math.sqrt(in_dim))
    return packed, scales


def _int4_close(got, ref, what: str) -> None:
    """Raises unless |got - ref| <= INT4_ULP_RTOL |ref| + INT4_ROW_ATOL
    max_row |ref|."""
    import torch

    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    tol = INT4_ULP_RTOL * ref.abs() + INT4_ROW_ATOL * ref.abs().amax(dim=-1, keepdim=True)
    if not torch.isfinite(got).all() or bool((err > tol).any()):
        raise AssertionError(f"{what}: max abs err {float(err.max()):.4g} against the grouped "
                             f"plain version, beyond one bf16 ulp")


def phase_int4(torch, gen, dev):
    """int4_matmul at the 14B projection shapes: every path the kernel has at
    each R, held against both plain versions (the grouped one to one bf16
    ulp, the dequantizing one to the shared tolerance) and run twice to the
    bit; the times of every path, of the plain version, of
    ``torch._weight_int4pack_mm`` and the bound.  Returns the JSON entry:
    the sums over the five shapes at R = 24, one serving decode step's
    projections of a layer and the head."""
    from chatts_tpu_torch.ops import int4_matmul as i4

    names = {v: k for k, v in i4.PATHS.items()}
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    errs, library_note = [], None
    for name, (in_dim, out_dim) in INT4_SHAPES.items():
        weights = rotating(lambda _: _int4_weights(torch, gen, dev, in_dim, out_dim),
                           in_dim * out_dim // 2)
        try:
            packs = [int4pack_library(torch, i4, *w) for w in weights]
        except (RuntimeError, AttributeError) as exc:  # the op is missing on this build
            packs, library_note = None, f"none: torch._weight_int4pack_mm failed ({exc})"
        turn = [0]

        def cycled(fn, x):
            def run():
                turn[0] = (turn[0] + 1) % len(weights)
                return fn(x, turn[0])
            return run

        for r in INT4_ROWS + (INT4_PREFILL_ROWS if name != "lm_head" else ()):
            x = torch.randn((r, in_dim), generator=gen, device=dev).to(torch.bfloat16)
            grouped = i4.int4_matmul_grouped_reference(x, *weights[0])
            plain_out = i4.int4_matmul_reference(x, *weights[0])
            times = {}
            for path in i4.PATHS.values():
                got = i4.int4_matmul_on_path(x, *weights[0], path)
                again = i4.int4_matmul_on_path(x, *weights[0], path)
                torch.cuda.synchronize()
                what = f"int4 {name} R={r} {names[path]}"
                if not torch.equal(got, again):
                    raise AssertionError(f"{what}: two calls differ")
                errs.append(compare(got, plain_out, what))
                _int4_close(got, grouped, what)
                times[path] = graph_ms(cycled(
                    lambda x, i, path=path: i4.int4_matmul_on_path(x, *weights[i], path), x))
            got = i4.int4_matmul(x, *weights[0])
            torch.cuda.synchronize()
            if not torch.equal(got, i4.int4_matmul_on_path(x, *weights[0], i4.int4_path(r))):
                raise AssertionError(f"int4 {name} R={r}: int4_matmul left its path")
            ms = times[i4.int4_path(r)]
            eager = time_ms(cycled(lambda x, i: i4.int4_matmul(x, *weights[i]), x))
            plain = graph_ms(cycled(lambda x, i: i4.int4_matmul_reference(x, *weights[i]), x))
            lib = None
            if packs is not None:
                def library(x, i):
                    return torch._weight_int4pack_mm(x, packs[i][0], 128, packs[i][1])

                try:
                    lib = _library_ms(torch, library(x, 0), plain_out, cycled(library, x),
                                      f"int4 {name} R={r}")
                except (RuntimeError, AssertionError) as exc:
                    packs, library_note = None, f"none: torch._weight_int4pack_mm: {exc}"
            bound_ms, bound_by = int4_bound(r, in_dim, out_dim)
            paths = ", ".join(f"{names[p]} {t:.4f}" for p, t in times.items())
            log(f"  int4_matmul {name} {in_dim}->{out_dim} R={r}: kernel {ms:.4f} ms "
                f"({names[i4.int4_path(r)]}; paths: {paths}; eager {eager:.4f}), plain "
                f"{plain:.3f} ms, int4pack_mm {'none' if lib is None else f'{lib:.4f} ms'}, bound "
                f"{bound_ms:.4f} ms ({bound_by}; {bound_ms / ms:.1%} of it), "
                f"max_abs_err {errs[-1]:.3g}")
            if r == 24:
                total["ms"] += ms
                total["plain_ms"] += plain
                total["bound_ms"] += bound_ms
                total["library_ms"] = None if lib is None or total["library_ms"] is None \
                    else total["library_ms"] + lib
        del weights, packs
        torch.cuda.empty_cache()
    if library_note:
        log(f"  int4_matmul library call: {library_note}")
    return dict(max_abs_err=max(errs), bound_by="bytes", library_note=library_note, **total)


def phase_int4_unfused(torch, gen, dev) -> list:
    """B3 and B5 at the projection widths of an imported GPTQ checkpoint,
    which keeps q/k/v and gate/up apart (IN 5,120; OUT 1,024 for k and v,
    5,120 for q, 13,824 for gate and up) at the rows decode, the batch
    prefill and a serving wave's prefill give them: each against its plain
    version (B3 also against the grouped one to one bf16 ulp, B5 to the bit),
    the kernel's, the plain version's and, for B3, ``_weight_int4pack_mm``'s
    device times, and the bound. At OUT 1,024 (four blocks of B5's
    two-warpgroup width) both of B5's block widths, to the bit. Returns one
    dict a (kernel, OUT, R)."""
    from chatts_tpu_torch.ops import int4_matmul as i4

    names = {v: k for k, v in i4.PATHS.items()}
    in_dim, rows_out = 5120, []
    for out_dim in INT4_UNFUSED_OUT:
        weights = rotating(lambda _: _int4_weights(torch, gen, dev, in_dim, out_dim),
                           in_dim * out_dim // 2)
        try:
            packs = [int4pack_library(torch, i4, *w) for w in weights]
        except (RuntimeError, AttributeError):  # the op is missing on this build
            packs = None
        turn = [0]

        def cycled(fn):
            """fn(i) on the weights of set i, a new set each call."""
            def run():
                turn[0] = (turn[0] + 1) % len(weights)
                return fn(turn[0])
            return run

        for r in INT4_UNFUSED_ROWS:
            what = f"int4 unfused {in_dim}->{out_dim} R={r}"
            x = torch.randn((r, in_dim), generator=gen, device=dev).to(torch.bfloat16)
            got = i4.int4_matmul(x, *weights[0])
            plain_out = i4.int4_matmul_reference(x, *weights[0])
            torch.cuda.synchronize()
            err = compare(got, plain_out, what)
            _int4_close(got, i4.int4_matmul_grouped_reference(x, *weights[0]), what)
            ms = graph_ms(cycled(lambda i: i4.int4_matmul(x, *weights[i])))
            plain = graph_ms(cycled(lambda i: i4.int4_matmul_reference(x, *weights[i])))
            lib = None
            if packs is not None:
                def library(i):
                    return torch._weight_int4pack_mm(x, packs[i][0], 128, packs[i][1])

                try:
                    lib = _library_ms(torch, library(0), plain_out, cycled(library), what)
                except (RuntimeError, AssertionError):
                    packs = None
            bound_ms, bound_by = int4_bound(r, in_dim, out_dim)
            rows_out.append(dict(kernel="int4_matmul", out=out_dim, rows=r, ms=ms, plain_ms=plain,
                                 library_ms=lib, bound_ms=bound_ms, max_abs_err=err))
            log(f"  int4_matmul unfused {in_dim}->{out_dim} R={r}: kernel {ms:.4f} ms "
                f"({names[i4.int4_path(r)]}), plain {plain:.3f} ms, int4pack_mm "
                f"{'none' if lib is None else f'{lib:.4f} ms'}, bound {bound_ms:.4f} ms "
                f"({bound_by}; {bound_ms / ms:.1%} of it), max_abs_err {err:.3g}")

            x_q = torch.randint(-127, 128, (r, in_dim), generator=gen, device=dev, dtype=torch.int8)
            x_scale = (torch.rand((r,), generator=gen, device=dev) + 0.5) / 127
            ref = i4.int4_matmul_a8_reference(x_q, x_scale, *weights[0])
            by_width = []
            for wgs in (i4.A8_WARPGROUPS if out_dim == 1024 else (i4.a8_warpgroups(r),)):
                out = i4.int4_matmul_a8_on_width(x_q, x_scale, *weights[0], wgs)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(f"int4_matmul_a8 unfused {in_dim}->{out_dim} R={r}, "
                                         f"{wgs} warpgroups a block: not bit-equal")
                t = graph_ms(cycled(lambda i, w=wgs: i4.int4_matmul_a8_on_width(
                    x_q, x_scale, *weights[i], w)))
                by_width.append(f"{wgs} warpgroups {t:.4f}")
            if not torch.equal(i4.int4_matmul_a8(x_q, x_scale, *weights[0]), ref):
                raise AssertionError(f"int4_matmul_a8 unfused {in_dim}->{out_dim} R={r}: "
                                     "not bit-equal")
            ms = graph_ms(cycled(lambda i: i4.int4_matmul_a8(x_q, x_scale, *weights[i])))
            plain = graph_ms(cycled(lambda i: i4.int4_matmul_a8_reference(
                x_q, x_scale, *weights[i])), target_s=0.1)
            bound_ms, _ = bound(in_dim * out_dim // 2 + in_dim // 128 * out_dim * 4
                                + r * (in_dim + 4) + 2 * r * out_dim,
                                2.0 * r * in_dim * out_dim, PEAK_INT8_S)
            rows_out.append(dict(kernel="int4_matmul_a8", out=out_dim, rows=r, ms=ms,
                                 plain_ms=plain, library_ms=None, bound_ms=bound_ms,
                                 max_abs_err=0.0))
            log(f"  int4_matmul_a8 unfused {in_dim}->{out_dim} R={r}: bit-equal, kernel "
                f"{ms:.4f} ms (by block width: {', '.join(by_width)}), plain {plain:.3f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_ms / ms:.1%} of it)")
        del weights, packs
        torch.cuda.empty_cache()
    return rows_out


# B3 at the shapes of phases 13 (bench.py's 8B shape, fused) and 13q
# (Qwen3-8B, its checkpoint's projections kept apart as the loader keeps
# them; the fused widths, qkv 6,144 and gate_up 24,576, a fused model's):
# (name, IN, OUT) at the rows of a decode step at 32 slots and of a block
# admission (8 x 512), the heads at the decode rows only.
NEW_INT4 = (("8b qkv", 3584, 4608), ("8b o", 3584, 3584), ("8b gate_up", 3584, 37888),
            ("8b down", 18944, 3584), ("8b head", 3584, 152064),
            ("qwen3_8b q, o", 4096, 4096), ("qwen3_8b k, v", 4096, 1024),
            ("qwen3_8b gate, up", 4096, 12288), ("qwen3_8b down", 12288, 4096),
            ("qwen3_8b head", 4096, 151936), ("qwen3_8b qkv fused", 4096, 6144),
            ("qwen3_8b gate_up fused", 4096, 24576))
NEW_INT4_ROWS = (32, 4096)


def phase_int4_new_shapes(torch, gen, dev) -> list:
    """B3 at ``NEW_INT4``: against both plain versions (the grouped one to
    one bf16 ulp), with the device times by graph replay of the kernel, the
    plain version and ``_weight_int4pack_mm``, and the bound.  Returns one
    row a (shape, R)."""
    from chatts_tpu_torch.ops import int4_matmul as i4

    rows = []
    for name, in_dim, out_dim in NEW_INT4:
        weights = rotating(lambda _: _int4_weights(torch, gen, dev, in_dim, out_dim),
                           in_dim * out_dim // 2)
        packs = [int4pack_library(torch, i4, *w) for w in weights]
        turn = [0]

        def cycled(fn):
            def run():
                turn[0] = (turn[0] + 1) % len(weights)
                return fn(turn[0])
            return run

        for r in NEW_INT4_ROWS[:1] if name.endswith("head") else NEW_INT4_ROWS:
            what = f"int4 {name} {in_dim}->{out_dim} R={r}"
            x = torch.randn((r, in_dim), generator=gen, device=dev).to(torch.bfloat16)
            got = i4.int4_matmul(x, *weights[0])
            plain_out = i4.int4_matmul_reference(x, *weights[0])
            err = compare(got, plain_out, what)
            _int4_close(got, i4.int4_matmul_grouped_reference(x, *weights[0]), what)

            def library(i):
                return torch._weight_int4pack_mm(x, packs[i][0], 128, packs[i][1])

            try:
                lib = _library_ms(torch, library(0), plain_out, cycled(library), what)
            except (RuntimeError, AssertionError) as exc:  # as phase_int4: no library time
                lib = None
                log(f"  {what}: torch._weight_int4pack_mm: {exc}")
            bound_ms, bound_by = int4_bound(r, in_dim, out_dim)
            rows.append(dict(
                shape=what[5:], path=i4.int4_path(r), max_abs_err=err,
                ms=graph_ms(cycled(lambda i: i4.int4_matmul(x, *weights[i]))),
                plain_ms=graph_ms(cycled(lambda i: i4.int4_matmul_reference(x, *weights[i]))),
                library_ms=lib, bound_ms=bound_ms, bound_by=bound_by))
            row = rows[-1]
            log(f"  int4_matmul {row['shape']}: max_abs_err {err:.3g}, kernel {row['ms']:.4f} ms, "
                f"plain {row['plain_ms']:.3f} ms, int4pack_mm "
                f"{'none' if lib is None else f'{lib:.4f} ms'}, bound {bound_ms:.4f} ms "
                f"({bound_by}; {bound_ms / row['ms']:.1%} of it)")
        del weights, packs
        torch.cuda.empty_cache()
    return rows


# B3's band (``ops/int4_matmul.py::STREAM_MAX_ROWS``): both configurations
# at the rows around it (512: the most a mixed step packs) and at the
# prefill rows, on the dense projections of
# the three families the benchmark serves: ChatTS-14B fused (qkv, o,
# gate_up, down), Qwen3-8B as its checkpoint keeps them (q and o, k and v,
# gate and up, down; a projection listed once, summed with its count) and
# Moonlight-16B-A3B's (q || kv_a padded to 3,712, kv_b, o, the shared
# experts' gate_up and down, layer 0's dense gate_up and down).
INT4_BAND_ROWS = (512, 640, 641, 1024, 2048) + INT4_PREFILL_ROWS
INT4_BAND_SHAPES = {
    "14b": (("qkv", 5120, 7168, 1), ("o", 5120, 5120, 1), ("gate_up", 5120, 27648, 1),
            ("down", 13824, 5120, 1)),
    "qwen3_8b unfused": (("q, o", 4096, 4096, 2), ("k, v", 4096, 1024, 2),
                         ("gate, up", 4096, 12288, 2), ("down", 12288, 4096, 1)),
    "moonlight dense": (("q || kv_a", 2048, 3712, 1), ("kv_b", 512, 4096, 1),
                        ("o", 2048, 2048, 1), ("shared gate_up", 2048, 5632, 1),
                        ("shared down", 2816, 2048, 1), ("layer 0 gate_up", 2048, 22528, 1),
                        ("layer 0 down", 11264, 2048, 1)),
}


def phase_int4_band(torch, gen, dev) -> dict:
    """B3's streaming and GEMM configurations at ``INT4_BAND_ROWS`` on
    ``INT4_BAND_SHAPES``: the GEMM's output held to the grouped plain version
    (one bf16 ulp) and run twice to the bit, both configurations' device
    times by graph replay, summed a family and R with the bound.  Returns,
    per family, the sums by R and the crossover: the least R of the rows at
    which the GEMM's sum is the smaller (None if none)."""
    from chatts_tpu_torch.ops import int4_matmul as i4

    out = {}
    for family, shapes in INT4_BAND_SHAPES.items():
        sums = {r: dict(stream_ms=0.0, gemm_ms=0.0, bound_ms=0.0) for r in INT4_BAND_ROWS}
        for name, in_dim, out_dim, count in shapes:
            weights = rotating(lambda _: _int4_weights(torch, gen, dev, in_dim, out_dim),
                               in_dim * out_dim // 2)
            turn = [0]
            for r in INT4_BAND_ROWS:
                what = f"int4 band {family} {name} {in_dim}->{out_dim} R={r}"
                x = torch.randn((r, in_dim), generator=gen, device=dev).to(torch.bfloat16)
                got = i4.int4_matmul_on_path(x, *weights[0], i4.GEMM)
                again = i4.int4_matmul_on_path(x, *weights[0], i4.GEMM)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"{what}: two calls differ")
                _int4_close(got, i4.int4_matmul_grouped_reference(x, *weights[0]), what)
                times = {}
                for path in (i4.STREAM, i4.GEMM):
                    def run(x=x, path=path):
                        turn[0] = (turn[0] + 1) % len(weights)
                        return i4.int4_matmul_on_path(x, *weights[turn[0]], path)

                    times[path] = graph_ms(run, target_s=0.1)
                bound_ms, _ = int4_bound(r, in_dim, out_dim)
                sums[r]["stream_ms"] += count * times[i4.STREAM]
                sums[r]["gemm_ms"] += count * times[i4.GEMM]
                sums[r]["bound_ms"] += count * bound_ms
                log(f"  int4 band {family} {name} {in_dim}->{out_dim} R={r}: streaming "
                    f"{times[i4.STREAM]:.4f} ms, GEMM {times[i4.GEMM]:.4f} ms, bound "
                    f"{bound_ms:.4f} ms (GEMM {bound_ms / times[i4.GEMM]:.1%} of it)")
            del weights
            torch.cuda.empty_cache()
        crossover = next((r for r in INT4_BAND_ROWS
                          if sums[r]["gemm_ms"] < sums[r]["stream_ms"]), None)
        for r, t in sums.items():
            log(f"  int4 band {family} R={r}, summed: streaming {t['stream_ms']:.4f} ms, GEMM "
                f"{t['gemm_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (GEMM "
                f"{t['bound_ms'] / t['gemm_ms']:.1%} of it)")
        log(f"  int4 band {family}: the GEMM is the faster from R = {crossover} of "
            f"{INT4_BAND_ROWS} (the band ends at {i4.STREAM_MAX_ROWS})")
        out[family] = dict(crossover=crossover, sums={str(r): t for r, t in sums.items()})
    return out


def near_bits(torch, got, want, what: str, share: float = 1e-3) -> int:
    """Raises unless bf16 ``got`` equals ``want`` but for one ulp in under
    ``share`` of the elements (a norm's sum of squares in another order);
    returns the count one ulp off."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    ulps = (ordered(got) - ordered(want)).abs()
    off = int((ulps > 0).sum())
    if int(ulps.max()) > 1 or off >= share * ulps.numel():
        raise AssertionError(f"{what}: {off} of {ulps.numel()} elements off, up to "
                             f"{int(ulps.max())} bf16 ulps")
    return off


# The glue's shapes (models/qwen.py's decode step and block prefill):
# (hidden, heads, kv heads, intermediate, qkv bias, q/k norms, cache), and
# the rows of a decode step (B = 32) and of a block prefill (R = 4,096).
GLUE_MODELS = {"14b": (5120, 40, 8, 13824, True, False, "int8"),
               "qwen3_8b": (4096, 32, 8, 12288, False, True, "bf16")}
GLUE_ROWS = (32, 4096)


def phase_glue(torch, gen, dev) -> dict:
    """The decoder glue's kernels (``ops/fused_glue.py``) against their
    eager compositions in ``models/qwen.py`` at the 14B and Qwen3-8B
    shapes: ``add_rms_norm`` (the residual add bit-equal, the norm one ulp
    off in under 0.1% of the elements; the norm-only variant at B = 32) and
    ``silu_mul`` (bit-equal) at B = 32 and R = 4,096, ``qkv_decode`` at
    B = 32 over a cache of 2,048 positions (the 14B's int8 cache with its
    qkv bias bit-equal, codes and scales as ``quantize_kv`` makes them;
    Qwen3's bf16 cache with its q/k norms one ulp off in under 0.1%).  The
    device times of the kernel, of the eager composition (its kernels and
    their gaps in one graph, as the decode step replays them) and of
    ``F.rms_norm``, the one PyTorch call for the norm (without the add); the
    bound, the bytes read and written once.  Then the decode step at full
    depth with the glue fused and eager (``glue_decode_step``).  Returns
    each kernel's entry, its rows under ``more_shapes``."""
    import torch.nn.functional as F

    from chatts_tpu_torch.models import qwen
    from chatts_tpu_torch.ops import fused_glue as glue

    def bf16(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def around_one(n):
        return (torch.rand((n,), generator=gen, device=dev) + 0.5).to(torch.bfloat16)

    rows = {name: [] for name in GLUE}

    def row(name, shape, ms, plain_ms, nbytes, library_ms=None, **extra):
        bound_ms, bound_by = bound(nbytes, 0.0, PEAK_BF16_S)
        rows[name].append(dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=library_ms, **extra))
        log(f"  {name} {shape}: kernel {ms:.4f} ms, eager {plain_ms:.4f} ms"
            + ("" if library_ms is None else f", F.rms_norm {library_ms:.4f} ms")
            + f", bound {bound_ms:.4f} ms ({bound_ms / ms:.1%} of it)"
            + "".join(f", {k} {v}" for k, v in extra.items()))

    for model, (hid, h, kvh, inter, bias, norms, cache) in GLUE_MODELS.items():
        w = around_one(hid)
        for r in GLUE_ROWS:
            x, br = bf16((r, hid), 4), bf16((r, hid))
            for add in (True, False) if r == 32 else (True,):
                branch = br if add else None
                resid, normed = glue.add_rms_norm(x, branch, w, 1e-6)
                want = x + br if add else x
                if not torch.equal(resid, want):
                    raise AssertionError(f"add_rms_norm {model} R={r}: the residual is not "
                                         f"x + branch to the bit")
                what = f"add_rms_norm {model} R={r}{'' if add else ' norm only'}"
                off = near_bits(torch, normed, qwen.rms_norm(want, w, 1e-6), what)
                lib = _library_ms(torch, F.rms_norm(want, (hid,), w, 1e-6), normed,
                                  lambda: F.rms_norm(want, (hid,), w, 1e-6), what)
                row("add_rms_norm", f"{model} R{r} H{hid}{'' if add else ' norm only'}",
                    graph_ms(lambda: glue.add_rms_norm(x, branch, w, 1e-6)),
                    graph_ms(lambda: (qwen.rms_norm(x + br, w, 1e-6) if add
                                      else qwen.rms_norm(x, w, 1e-6))),
                    (3 + add) * 2 * r * hid + 2 * hid, lib, ulp_off=off)
            gate, up = bf16((r, 2 * inter), 4).chunk(2, dim=-1)
            if not torch.equal(glue.silu_mul(gate, up), F.silu(gate) * up):
                raise AssertionError(f"silu_mul {model} R={r}: not bit-equal to F.silu * up")
            row("silu_mul", f"{model} R{r} I{inter}", graph_ms(lambda: glue.silu_mul(gate, up)),
                graph_ms(lambda: F.silu(gate) * up), 3 * 2 * r * inter)

        b, d, s = 32, 128, 2048
        widths = [h * d, kvh * d, kvh * d]
        y = bf16((b, sum(widths)), 3)
        bvec = bf16((sum(widths),), 0.1) if bias else None
        biases = [None] * 3 if bvec is None else list(bvec.split(widths))
        qn, kn = (around_one(d), around_one(d)) if norms else (None, None)
        pos = torch.randint(500, 800, (b,), generator=gen, device=dev, dtype=torch.int32)
        cos, sin = qwen.rope_cos_sin(pos[:, None], d, 1e6)
        if cache == "int8":
            base = [torch.randint(-127, 128, (b, kvh, s, d), generator=gen, device=dev,
                                  dtype=torch.int8) for _ in range(2)]
            base += [torch.rand((b, kvh, s), generator=gen, device=dev) for _ in range(2)]
            written = 2 * b * kvh * (d + 4)
        else:
            base = [bf16((b, kvh, s, d)) for _ in range(2)]
            written = 2 * b * kvh * d * 2
        got_kv, want_kv = [c.clone() for c in base], [c.clone() for c in base]
        ix = (torch.arange(b, device=dev)[:, None, None],
              torch.arange(kvh, device=dev)[None, :, None], pos.long()[:, None, None])

        def fused(kv):
            return glue.qkv_decode(*y.split(widths, dim=-1), biases, qn, kn, 1e-6,
                                   cos.reshape(b, d), sin.reshape(b, d), pos, kv, h, kvh, d)

        def eager(kv):
            yb = y if bvec is None else (y.float() + bvec.float()).to(torch.bfloat16)
            q, k, v = yb.split(widths, dim=-1)
            q, k = q.reshape(b, 1, h, d), k.reshape(b, 1, kvh, d)
            v = v.reshape(b, 1, kvh, d).contiguous()
            if norms:
                q, k = qwen.rms_norm(q, qn, 1e-6), qwen.rms_norm(k, kn, 1e-6)
            q, k = qwen.apply_rope(q, cos, sin), qwen.apply_rope(k, cos, sin)
            qwen._write_cache(kv, ix, qwen._cache_values(kv, k.transpose(1, 2),
                                                           v.transpose(1, 2)))
            return q[:, 0].contiguous()

        q_got, q_want = fused(got_kv), eager(want_kv)
        what = f"qkv_decode {model} {cache}"
        if norms:
            off = near_bits(torch, q_got, q_want, f"{what} q")
            for g, w_ in zip(got_kv, want_kv):
                off += near_bits(torch, g, w_, f"{what} cache")
        else:
            off = 0
            if not (torch.equal(q_got, q_want)
                    and all(torch.equal(g, w_) for g, w_ in zip(got_kv, want_kv))):
                raise AssertionError(f"{what}: q or the cache is not bit-equal to the eager "
                                     f"epilogue's")
        row("qkv_decode", f"{model} B{b} H{h} KVH{kvh} D{d} {cache}",
            graph_ms(lambda: fused(got_kv)), graph_ms(lambda: eager(want_kv)),
            2 * y.numel() + (0 if bvec is None else 2 * bvec.numel()) + 2 * 2 * b * d * 4
            + 2 * b * h * d + written, ulp_off=off)
        del base, got_kv, want_kv
    results = {name: dict(**rows[name][0], more_shapes=rows[name][1:]) for name in GLUE}
    results["decode_step"] = glue_decode_step(torch, dev)
    return results


def glue_decode_step(torch, dev) -> list:
    """The decode step at full depth (the 14B's 48 layers, int8 cache;
    Qwen3-8B's 36, bf16 cache) on ``glue_model``'s weights, 32 slots at 500
    to 800 cached positions: embedding, layers, head and argmax captured in
    a CUDA graph with the glue fused and with it eager (the gate forced
    off), in turns, each replayed between CUDA events; the glue's call
    sites one step runs on each path."""
    from chatts_tpu_torch.ops import fused_glue as glue
    from chatts_tpu_torch.runtime import kv_cache

    out = []
    for name, make, layers in (("14b", chatts_14b_config, 48),
                               ("qwen3_8b", qwen3_8b_config, 36)):
        cfg = make(layers)
        llm = glue_model(torch, cfg, dev, SEED + 19).llm
        cache = torch.int8 if GLUE_MODELS[name][-1] == "int8" else torch.bfloat16
        b = 32
        caches = kv_cache.allocate(cfg.llm, b, 2048, cache, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 19)
        tokens = torch.randint(0, 400, (b,), generator=gen, device=dev, dtype=torch.int32)
        lens = torch.randint(500, 800, (b,), generator=gen, device=dev, dtype=torch.int32)

        def step():
            positions = lens[:, None]
            hidden, _ = llm(llm.embed(tokens[:, None]), positions, kv_caches=caches,
                            write_pos=positions, kv_lengths=lens + 1)
            return llm.compute_logits(hidden)[:, 0].argmax(dim=-1)

        times, calls = {"fused": [], "eager": []}, {}
        engaged = glue.engaged
        for path in ("fused", "eager", "fused", "eager"):
            if path == "eager":
                glue.engaged = lambda *a: False
            try:
                with torch.no_grad():
                    before = glue.counts()
                    step()
                    calls[path] = {k: v - before[k] for k, v in glue.counts().items()}
                    times[path].append(graph_ms(step))
            finally:
                glue.engaged = engaged
        want = 4 * layers + 1
        if calls["fused"] != {"fused": want, "eager": 0} or calls["eager"] != {
                "fused": 0, "eager": want}:
            raise AssertionError(f"decode step {name}: glue call sites {calls}, not {want} "
                                 f"fused, then {want} eager")
        row = dict(model=name, layers=layers, shape=f"B{b} {cache} cache, 500-800 positions",
                   fused_ms=times["fused"], eager_ms=times["eager"], calls=calls)
        log(f"  decode step {name} ({layers} layers): glue fused "
            f"{', '.join(f'{t:.3f}' for t in times['fused'])} ms, eager "
            f"{', '.join(f'{t:.3f}' for t in times['eager'])} ms; call sites {calls}")
        out.append(row)
        del llm, caches
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from chatts_tpu_torch.ops import flash_attention as fa
    from chatts_tpu_torch.ops import int4_matmul as i4
    from chatts_tpu_torch.ops import ragged_decode_attention as rda

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    none_a8 = ("none: no one PyTorch call applies per-group weight scales to an "
               "int8 x int4 product")
    with Phase(2, "kernels against their plain versions (bf16)"):
        # Flash prefill attention: three ragged and aligned lengths, the main
        # paths' own shapes (the batch prefill, B4 T = S = 1280; a serving
        # wave, B8 T = S = 512), a chunk of 256 queries over a prefix (T < S,
        # offset query positions) and one short prompt admitted alone (T = 37:
        # the 64-row query tile's side of the wrapper's choice); then the
        # chunked paths' shapes: a 512-token prefill chunk over the 2,048
        # prefix at query offsets 0, 512 and 1,024 (phase 8a), and a mixed
        # step's 64 prompt tokens a row over the 2,048 and 4,096 prefixes of
        # its two rounds, at their last offsets (phase 8b); then a block
        # admission of 8 x 512 at the 8B shape and Qwen3-8B's heads (phases
        # 13 and 13q: H, KVH given).  The library call: SDPA with GQA and the
        # boolean mask kv_valid & kv_pos <= q_pos, on head-major views.
        errs, times = [], {}
        for b, t, s_len, q0, *heads in (
                (4, 640, 640, None), (4, 1152, 1152, None), (4, 600, 600, None),
                (4, 1280, 1280, None), (8, 512, 512, None), (4, 256, 1280, None),
                (1, 37, 37, None), (4, 512, 2048, 0), (4, 512, 2048, 512),
                (4, 512, 2048, 1024), (4, 64, 2048, 1984), (4, 64, 4096, 4032),
                (8, 512, 512, None, 28, 4), (8, 512, 512, None, 32, 8)):
            q, k, v, q_pos, kv_pos, kv_valid = _flash_case(torch, gen, t, dev, b, s_len, q0,
                                                           *heads)
            kw = dict(q_positions=q_pos, kv_positions=kv_pos, kv_valid=kv_valid)
            what = (f"flash B={b} H={q.shape[2]} KVH={k.shape[2]} T={t} S={s_len}"
                    + ("" if q0 is None else f" q0={q0}"))
            got = fa.flash_attention(q, k, v, **kw)
            ref = fa.flash_attention_reference(q, k, v, **kw)
            torch.cuda.synchronize()
            errs.append(compare(got, ref, what))
            if t == s_len and b >= 4 and got[3::4, :5].abs().max() != 0:
                raise AssertionError("flash: a query with no valid key did not give 0")
            by_tile = {}
            for block_q in fa.BLOCKS_Q:
                out = fa.flash_attention_on_tile(q, k, v, **kw, block_q=block_q)
                again = fa.flash_attention_on_tile(q, k, v, **kw, block_q=block_q)
                torch.cuda.synchronize()
                if not torch.equal(out, again):
                    raise AssertionError(f"{what} tile {block_q}: two calls differ")
                compare(out, ref, f"{what} tile {block_q}")
                tiled = fa.flash_attention_tiled_reference(q, k, v, **kw, block_q=block_q)
                by_tile[block_q] = (
                    graph_ms(lambda: fa.flash_attention_on_tile(q, k, v, **kw, block_q=block_q)),
                    float((out.float() - tiled.float()).abs().max()))
            if not torch.equal(got, fa.flash_attention_on_tile(
                    q, k, v, **kw, block_q=fa.default_block_q(t))):
                raise AssertionError(f"{what}: flash_attention left its tile")
            ms = by_tile[fa.default_block_q(t)][0]
            eager = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
            plain = graph_ms(lambda: fa.flash_attention_reference(q, k, v, **kw))
            mask = kv_valid[:, None, None, :] & (kv_pos[:, None, None, :] <= q_pos[:, None, :, None])
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)

            lib = _library_ms(torch, sdpa().transpose(1, 2), ref, sdpa, what,
                              rows=mask[:, 0].any(-1))
            # q, k, v, both position arrays and kv_valid read once, the output
            # written once; 4 D operations a head for each (query, visible key).
            _, _, h, d = q.shape
            visible = int(mask.sum())
            nbytes = (2 * (2 * q.numel() + k.numel() + v.numel())
                      + 4 * (q_pos.numel() + kv_pos.numel()) + kv_valid.numel())
            bound_ms, bound_by = bound(nbytes, 4.0 * d * h * visible, PEAK_BF16_S)
            times[(b, t, s_len, q0, *heads)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                                    bound_ms=bound_ms, bound_by=bound_by)
            tiles = ", ".join(f"{bq} rows {t_ms:.3f} ms (|kernel - tiled plain| {dist:.3g})"
                              for bq, (t_ms, dist) in by_tile.items())
            log(f"  flash_attention B={b} H={h} KVH={k.shape[2]} D=128 T={t} S={s_len}"
                f"{'' if q0 is None else f' q0={q0}'}: max_abs_err "
                f"{errs[-1]:.3g}, kernel {ms:.3f} ms ({4.0 * d * h * visible / ms / 1e9:.0f} "
                f"TFLOP/s of visible work; eager {eager:.3f}; tiles: {tiles}), plain "
                f"{plain:.3f} ms, sdpa {lib:.3f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}; {bound_ms / ms:.1%} of it)")
        results["flash_attention"] = dict(
            max_abs_err=max(errs), **times[(4, 1152, 1152, None)],
            more_shapes=[dict(shape=f"B{key[0]} H{key[4]} KVH{key[5]} T=S={key[1]}", **row)
                         for key, row in times.items() if len(key) > 4])
        log("  flash chunk shapes: " + json.dumps(
            [dict(b=b, t=t, s=s_len, q0=q0, **row) for (b, t, s_len, q0, *_), row in times.items()
             if q0 is not None]))

        # Ragged decode attention (bf16 cache): the case that stands, then
        # lengths on and beside the plan's chunk boundaries with a row of
        # length 0, one long row at the engine's default capacity, and G = 7
        # (28 heads over 4 kv heads, the 7B shape); then every slot of the
        # serving decode steps of phases 13, 13q and 8f, lengths spread
        # evenly over the capacity.
        def chunk_of(b, kvh, cap):
            return rda.split_plan(cap, b, kvh)[1]

        def spread(b, cap):
            return [round(i * cap / (b - 1)) for i in range(b)]

        c4 = chunk_of(6, 8, 2048)
        more = {"8b c32": "B32 H28 KVH4 S1024", "qwen3_8b c32": "B32 H32 KVH8 S1024",
                "14b cap 6144": "B24 H40 KVH8 S6144"}
        results["ragged_decode_attention"] = dict(more_shapes=[])
        for name, h, kvh, cap, lens in (
                ("main", 40, 8, 2048, [1, 255, 257, 2048]),
                ("boundaries", 40, 8, 2048, [0, c4 - 1, c4, c4 + 1, 3 * c4, 2047]),
                ("long", 40, 8, 6144, [6001]),
                ("g7", 28, 4, 2048, [0, 129, 1000, 2048]),
                ("8b c32", 28, 4, 1024, spread(32, 1024)),
                ("qwen3_8b c32", 32, 8, 1024, spread(32, 1024)),
                ("14b cap 6144", 40, 8, 6144, spread(24, 6144))):
            b, d = len(lens), 128
            plan = rda.split_plan(cap, b, kvh)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)

            def make_cache(_):
                return (torch.randn((b, kvh, cap, d), generator=gen, device=dev).to(torch.bfloat16),
                        torch.randn((b, kvh, cap, d), generator=gen, device=dev).to(torch.bfloat16))

            caches = rotating(make_cache, 2 * b * kvh * cap * d * 2)
            q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
            got = rda.ragged_decode_attention(q, *caches[0], lengths)
            again = rda.ragged_decode_attention(q, *caches[0], lengths)
            ref = rda.ragged_decode_attention_reference(q, *caches[0], lengths)
            split = rda.ragged_decode_attention_split_reference(q, *caches[0], lengths,
                                                                chunk=plan[1])
            torch.cuda.synchronize()
            what = f"ragged decode {name}"
            if not torch.equal(got, again):
                raise AssertionError(f"{what}: two calls differ")
            err = compare(got, ref, what)
            if got[lengths == 0].abs().sum() != 0:
                raise AssertionError(f"{what}: a row of length 0 did not give 0")
            of_split = float((got.float() - split.float()).abs().max())
            turn = [0]

            def cycle(fn):
                def run():
                    turn[0] = (turn[0] + 1) % len(caches)
                    fn(q, *caches[turn[0]], lengths)
                return run

            ms = graph_ms(cycle(rda.ragged_decode_attention))
            eager = time_ms(cycle(rda.ragged_decode_attention))
            plain = graph_ms(cycle(rda.ragged_decode_attention_reference))
            # The library call: SDPA with q as (B, H, 1, D), the head-major
            # cache as it is and a length mask, on the rows of length >= 1.
            lmask = (torch.arange(cap, device=dev)[None, :] < lengths[:, None])[:, None, None, :]

            def sdpa_decode(q, k, v, _lengths):
                return F.scaled_dot_product_attention(q[:, :, None, :], k, v, attn_mask=lmask,
                                                      enable_gqa=True)[:, :, 0]

            lib = _library_ms(torch, sdpa_decode(q, *caches[0], lengths), ref,
                              cycle(sdpa_decode), what, rows=lengths > 0)
            # The cache up to each row's length, q, the lengths and the output
            # once; 4 D operations a head for each position.
            n_pos = sum(lens)
            bound_ms, bound_by = bound(2 * 2 * n_pos * kvh * d + 2 * 2 * q.numel() + 4 * b,
                                       4.0 * d * h * n_pos, PEAK_BF16_S)
            log(f"  ragged_decode_attention {name} B={b} H={h} KVH={kvh} D=128 S={cap} lengths "
                f"{lens if b < 8 else f'{lens[0]}..{lens[-1]}'}, {plan[0]} splits of {plan[1]} "
                f"keys: max_abs_err {err:.3g} (|kernel - "
                f"split plain| {of_split:.3g}), two calls bit-equal, kernel {ms:.4f} ms (eager "
                f"{eager:.3f}), plain {plain:.3f} ms, sdpa {lib:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}; {bound_ms / ms:.1%} of it)")
            if name in more:
                results["ragged_decode_attention"]["more_shapes"].append(dict(
                    shape=more[name], plan=list(plan), max_abs_err=err, ms=ms, plain_ms=plain,
                    library_ms=lib, bound_ms=bound_ms, bound_by=bound_by))
            if name == "main":
                results["ragged_decode_attention"].update(
                    max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound_ms,
                    bound_by=bound_by)
                # Other chunks at the same shape, for the plan's constants.
                other = []
                for chunk in (128, 256, 512, 2048):
                    alt = (-(-cap // chunk), chunk)
                    out = rda.ragged_decode_attention_on_plan(q, *caches[0], lengths, alt)
                    torch.cuda.synchronize()
                    compare(out, ref, f"{what} chunk {chunk}")
                    other.append((chunk, graph_ms(cycle(
                        lambda *a, alt=alt: rda.ragged_decode_attention_on_plan(*a, alt)))))
                log("    by chunk: " + ", ".join(f"{c} keys {t:.4f} ms" for c, t in other))
            else:
                results["ragged_decode_attention"]["max_abs_err"] = max(
                    err, results["ragged_decode_attention"]["max_abs_err"])
            del caches
            torch.cuda.empty_cache()

        # Ragged decode attention over the int8 cache: the serving shape (24
        # slots, cap 1024) and the engine's default cap of 6144, then lengths
        # on and beside the plan's chunk boundaries with a row of length 0,
        # and G = 7 (28 heads over 4 kv heads, the 7B shape).
        c24 = chunk_of(24, 8, 1024)
        for name, h, kvh, cap, lens in (
                ("serving", 40, 8, 1024,
                 [0, 1, 255, 256, 257, 600, 1024, 2, 17, 128, 129, 383, 384, 511, 512, 513,
                  700, 767, 768, 900, 1000, 1023, 64, 640]),
                ("long", 40, 8, 6144,
                 [0, 1, 6144, 6143, 256, 257, 4097, 3000, 2048, 1024, 512, 5000, 100, 6000,
                  300, 4500, 1500, 2500, 3500, 5500, 700, 800, 900, 6100]),
                ("boundaries", 40, 8, 1024,
                 [0, c24 - 1, c24, c24 + 1, 2 * c24 - 1, 2 * c24, 2 * c24 + 1, 3 * c24,
                  1023, 1024] + [0] * 14),
                ("g7", 28, 4, 1024, [0, 129, 1000, 1024, 300, 31, 32, 33])):
            b, d = len(lens), 128
            plan = rda.split_plan(cap, b, kvh)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)

            def make_int8(_):
                k = torch.randint(-127, 128, (b, kvh, cap, d), generator=gen, device=dev,
                                  dtype=torch.int8)
                v = torch.randint(-127, 128, (b, kvh, cap, d), generator=gen, device=dev,
                                  dtype=torch.int8)
                ks = (torch.rand((b, kvh, cap), generator=gen, device=dev) + 0.5) / 127
                vs = (torch.rand((b, kvh, cap), generator=gen, device=dev) + 0.5) / 127
                return k, v, ks, vs

            caches8 = rotating(make_int8, 2 * b * kvh * cap * (d + 4))
            q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
            got = rda.ragged_decode_attention_int8(q, *caches8[0], lengths)
            again = rda.ragged_decode_attention_int8(q, *caches8[0], lengths)
            ref = rda.ragged_decode_attention_int8_reference(q, *caches8[0], lengths)
            split = rda.ragged_decode_attention_int8_split_reference(q, *caches8[0], lengths,
                                                                     chunk=plan[1])
            torch.cuda.synchronize()
            what = f"ragged decode int8 {name}"
            if not torch.equal(got, again):
                raise AssertionError(f"{what}: two calls differ")
            err = compare(got, ref, what, row_rtol=INT8_ROW_RTOL)
            if got[lengths == 0].abs().sum() != 0:
                raise AssertionError(f"{what}: a row of length 0 did not give 0")
            row_max = ref.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
            of_row = float(((got.float() - ref.float()).abs() / row_max).max())
            of_split = float((got.float() - split.float()).abs().max())
            turn = [0]

            def cycle8(fn):
                def run():
                    turn[0] = (turn[0] + 1) % len(caches8)
                    fn(q, *caches8[turn[0]], lengths)
                return run

            ms = graph_ms(cycle8(rda.ragged_decode_attention_int8))
            eager = time_ms(cycle8(rda.ragged_decode_attention_int8))
            plain = graph_ms(cycle8(rda.ragged_decode_attention_int8_reference))
            # Codes and scales up to each row's length, q, lengths, output.
            n_pos = sum(lens)
            bound_ms, bound_by = bound(2 * n_pos * kvh * (d + 4) + 2 * 2 * q.numel() + 4 * b,
                                       4.0 * d * h * n_pos, PEAK_BF16_S)
            log(f"  ragged_decode_attention_int8 {name} B={b} H={h} KVH={kvh} D=128 S={cap} "
                f"lengths {min(lens)}..{max(lens)} (mean {sum(lens) / b:.0f}), {plan[0]} splits "
                f"of {plan[1]} keys: max_abs_err {err:.3g} ({of_row:.3g} of its row's largest; "
                f"tolerance {INT8_ROW_RTOL}; |kernel - split plain| {of_split:.3g}), two calls "
                f"bit-equal, kernel {ms:.4f} ms (eager {eager:.3f}), plain {plain:.3f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}; {bound_ms / ms:.1%} of it)")
            if name == "serving":
                results["ragged_decode_attention_int8"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None,
                    library_note="none: no one PyTorch call applies per-position K and V "
                                 "scales inside attention")
                # Other chunks at the same shape, for the plan's constants.
                other = []
                for chunk in (128, 256, 512, 1024):
                    alt = (-(-cap // chunk), chunk)
                    out = rda.ragged_decode_attention_int8_on_plan(q, *caches8[0], lengths, alt)
                    torch.cuda.synchronize()
                    compare(out, ref, f"{what} chunk {chunk}", row_rtol=INT8_ROW_RTOL)
                    other.append((chunk, graph_ms(cycle8(
                        lambda *a, alt=alt: rda.ragged_decode_attention_int8_on_plan(*a, alt)))))
                log("    by chunk: " + ", ".join(f"{c} keys {t:.4f} ms" for c, t in other))
                # The wrapper reads no length on the host: a call captured in a
                # CUDA graph and replayed with other lengths gives their result.
                held = lengths.clone()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    out = rda.ragged_decode_attention_int8(q, *caches8[0], held)
                held.copy_(torch.flip(lengths, dims=(0,)))
                graph.replay()
                torch.cuda.synchronize()
                if not torch.equal(out, rda.ragged_decode_attention_int8(q, *caches8[0], held)):
                    raise AssertionError(f"{what}: a graph replayed with other lengths did not "
                                         f"give their result")
                compare(out, rda.ragged_decode_attention_int8_reference(q, *caches8[0], held),
                        f"{what} replayed", row_rtol=INT8_ROW_RTOL)
                log("    captured in a CUDA graph and replayed with other lengths: their result")
                del graph
            else:
                results["ragged_decode_attention_int8"]["max_abs_err"] = max(
                    err, results["ragged_decode_attention_int8"]["max_abs_err"])
            del caches8
            torch.cuda.empty_cache()

        results["int4_matmul"] = phase_int4(torch, gen, dev)

        # B5, the int8-activation matmul, at the projection shapes an a8
        # prefill runs (the head stays bf16 x int4): a one-row admission of
        # a short prompt, a serving wave (8 x 512) and the batch (4 x 1280).
        # phase_int4 times the bf16 int4 matmul at the same rows.
        errs, layer = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
        for name in ("qkv", "o", "gate_up", "down"):
            in_dim, out_dim = INT4_SHAPES[name]
            weights = rotating(lambda _: _int4_weights(torch, gen, dev, in_dim, out_dim),
                               in_dim * out_dim // 2)
            if name == "qkv":
                # Both block widths on both sides of the wrapper's choice
                # (one warpgroup a block up to 64 rows, two above).
                by_width = []
                for r in (1, 37, 64, 65):
                    x_q = torch.randint(-127, 128, (r, in_dim), generator=gen, device=dev,
                                        dtype=torch.int8)
                    x_scale = (torch.rand((r,), generator=gen, device=dev) + 0.5) / 127
                    ref = i4.int4_matmul_a8_reference(x_q, x_scale, *weights[0])
                    for wgs in i4.A8_WARPGROUPS:
                        got = i4.int4_matmul_a8_on_width(x_q, x_scale, *weights[0], wgs)
                        torch.cuda.synchronize()
                        if not torch.equal(got, ref):
                            raise AssertionError(f"int4_matmul_a8 {name} R={r}, {wgs} warpgroups "
                                                 f"a block: not bit-equal to the plain version")
                        turn = [0]

                        def run_width(x_q=x_q, x_scale=x_scale, wgs=wgs):
                            turn[0] = (turn[0] + 1) % len(weights)
                            i4.int4_matmul_a8_on_width(x_q, x_scale, *weights[turn[0]], wgs)

                        by_width.append(f"R={r} x{wgs} {graph_ms(run_width):.4f}")
                    if not torch.equal(i4.int4_matmul_a8(x_q, x_scale, *weights[0]), ref):
                        raise AssertionError(f"int4_matmul_a8 {name} R={r}: not bit-equal")
                log(f"  int4_matmul_a8 {name} by rows and warpgroups a block (the wrapper takes "
                    f"{[i4.a8_warpgroups(r) for r in (1, 37, 64, 65)]}), bit-equal, ms: "
                    + ", ".join(by_width))
            for r in (37, 4096, 5120):
                x_q = torch.randint(-127, 128, (r, in_dim), generator=gen, device=dev,
                                    dtype=torch.int8)
                x_scale = (torch.rand((r,), generator=gen, device=dev) + 0.5) / 127
                got = i4.int4_matmul_a8(x_q, x_scale, *weights[0])
                ref = i4.int4_matmul_a8_reference(x_q, x_scale, *weights[0])
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs()
                if not torch.isfinite(got.float()).all() or bool(
                        (err > A8_ULP_RTOL * ref.float().abs()).any()):
                    raise AssertionError(f"int4_matmul_a8 {name} R={r}: max abs err "
                                         f"{float(err.max()):.4g} beyond one bf16 ulp")
                errs.append(float(err.max()))
                exact = float((got == ref).float().mean())
                if exact != 1.0:
                    raise AssertionError(f"int4_matmul_a8 {name} R={r}: {exact:.4%} of the "
                                         f"outputs bit-equal to the plain version, not all")
                turn = [0]

                def run_a8(fn, x_q=x_q, x_scale=x_scale):
                    turn[0] = (turn[0] + 1) % len(weights)
                    fn(x_q, x_scale, *weights[turn[0]])

                ms = graph_ms(lambda: run_a8(i4.int4_matmul_a8))
                eager = time_ms(lambda: run_a8(i4.int4_matmul_a8))
                plain = graph_ms(lambda: run_a8(i4.int4_matmul_a8_reference), target_s=0.1)
                # Packed weights, scales, int8 x, row scales and the bf16
                # output once; 2 R IN OUT int8 operations.
                bound_ms, _ = bound(in_dim * out_dim // 2 + in_dim // 128 * out_dim * 4
                                    + r * (in_dim + 4) + 2 * r * out_dim,
                                    2.0 * r * in_dim * out_dim, PEAK_INT8_S)
                if r == 4096:
                    layer["ms"] += ms
                    layer["plain_ms"] += plain
                    layer["bound_ms"] += bound_ms
                tops = 2 * r * in_dim * out_dim / (ms * 1e9)
                log(f"  int4_matmul_a8 {name} {in_dim}->{out_dim} R={r}: max_abs_err "
                    f"{errs[-1]:.3g} ({exact:.4%} bit-equal), kernel {ms:.3f} ms "
                    f"({tops:.0f} TOP/s; eager {eager:.3f}), plain {plain:.3f} ms, bound {bound_ms:.4f} ms "
                    f"({bound_ms / ms:.1%} of it)")
            del weights
            torch.cuda.empty_cache()
        # One layer's four projections in a serving wave's prefill (R = 4096).
        results["int4_matmul_a8"] = dict(
            max_abs_err=max(errs), bound_by="operations", library_ms=None,
            library_note=none_a8, **layer)
        unfused = phase_int4_unfused(torch, gen, dev)
        log("  unfused int4 stats: " + json.dumps(unfused))
        rows = phase_int4_new_shapes(torch, gen, dev)
        log("  int4 band: " + json.dumps(phase_int4_band(torch, gen, dev)))
        results["int4_matmul"].update(more_shapes=rows, max_abs_err=max(
            [results["int4_matmul"]["max_abs_err"]] + [row["max_abs_err"] for row in rows]))
        results.update(phase_glue(torch, gen, dev))
    return results


# ---------------------------------------------------------------------------
# Phases 3-4: the model and the slice
# ---------------------------------------------------------------------------

def chatts_14b_config(num_layers: int):
    """ChatTS-14B: Qwen2.5-14B widths plus a 5-layer TS encoder (the shape
    ``bench.py`` pins for the 14B model)."""
    from chatts_tpu_torch.core.config import ChatTSConfig, QwenConfig, TSEncoderConfig

    vocab = 152064
    return ChatTSConfig(
        llm=QwenConfig(
            vocab_size=vocab, hidden_size=5120, intermediate_size=13824,
            num_hidden_layers=num_layers, num_attention_heads=40,
            num_key_value_heads=8, head_dim=128, rope_theta=1e6,
            attention_bias=True, dtype="bfloat16",
        ),
        ts=TSEncoderConfig(patch_size=16, num_layers=5, hidden_size=5120,
                           max_sequence_length=4096),
        ts_token_start_index=vocab - 10,
    )


def chatts_8b_config(num_layers: int):
    """The reference's headline serving shape (``bench.py:253-263``): a
    Qwen2.5-7B-class decoder (the "8B shape") plus a 5-layer TS encoder."""
    from chatts_tpu_torch.core.config import ChatTSConfig, QwenConfig, TSEncoderConfig

    vocab = 152064
    return ChatTSConfig(
        llm=QwenConfig(
            vocab_size=vocab, hidden_size=3584, intermediate_size=18944,
            num_hidden_layers=num_layers, num_attention_heads=28,
            num_key_value_heads=4, head_dim=128, rope_theta=1e6,
            attention_bias=True, dtype="bfloat16",
        ),
        ts=TSEncoderConfig(patch_size=16, num_layers=5, hidden_size=3584,
                           max_sequence_length=4096),
        ts_token_start_index=vocab - 10,
    )


def qwen3_8b_config(num_layers: int):
    """Qwen3-8B's published widths (the ``Qwen/Qwen3-8B`` config.json on the
    Hugging Face hub: hidden 4,096, 36 layers, 32 heads over 8 kv heads,
    head_dim 128, intermediate 12,288, vocab 151,936, rope theta 1e6, no
    attention bias, q/k norms, an untied head) with ChatTS's 5-layer TS
    encoder at its width: ``Qwen3TSForCausalLM``."""
    from chatts_tpu_torch.core.config import ChatTSConfig, QwenConfig, TSEncoderConfig

    vocab = 151936
    return ChatTSConfig(
        llm=QwenConfig(
            vocab_size=vocab, hidden_size=4096, intermediate_size=12288,
            num_hidden_layers=num_layers, num_attention_heads=32,
            num_key_value_heads=8, head_dim=128, rope_theta=1e6,
            tie_word_embeddings=False, attention_bias=False, qk_norm=True,
            dtype="bfloat16",
        ),
        ts=TSEncoderConfig(patch_size=16, num_layers=5, hidden_size=4096,
                           max_sequence_length=4096),
        ts_token_start_index=vocab - 10,
    )


def glue_model(torch, cfg, dev, seed: int):
    """A random int4 ChatTS model of ``cfg`` on ``dev``
    (``init_quantized_params``, fused projections) with the decoder glue's
    operands drawn away from their neutral values from ``seed``: every norm
    weight (input, post-attention, q/k, final) uniform in [0.5, 1.5] and
    every qkv bias 0.1 N(0, 1), so that a weight or a bias skipped or applied
    to the wrong rows shows.  Phase 2's decode step and the glue's card
    tests (``tests/test_torch_kernels_gpu.py``) share it."""
    from chatts_tpu_torch.models.quantize import init_quantized_params

    gen = torch.Generator(device=dev).manual_seed(seed)
    model = init_quantized_params(cfg, gen, dev)
    llm = model.llm
    norms = [llm.norm] + [w for layer in llm.layers for w in (
        layer.input_layernorm, layer.post_attention_layernorm, layer.self_attn.q_norm,
        layer.self_attn.k_norm) if w is not None]
    with torch.no_grad():
        for w in norms:
            w.copy_(torch.rand(w.shape, generator=gen, device=dev) + 0.5)
        for layer in llm.layers:
            bias = layer.self_attn.qkv_proj.bias
            if bias is not None:
                bias.copy_(torch.randn(bias.shape, generator=gen, device=dev) * 0.1)
    return model


def first_layers(model, cfg, n: int):
    """(config, model) of ``model``'s first n decoder layers, sharing its
    tensors (embeddings, encoder, final norm and head)."""
    import dataclasses

    from chatts_tpu_torch.models.chatts import ChatTSModel
    from chatts_tpu_torch.models.qwen import QwenModel

    cut = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_hidden_layers=n))
    llm = model.llm
    view = QwenModel(cut.llm, llm.embed_tokens, list(llm.layers[:n]), llm.norm,
                     lm_head=llm.lm_head, lm_head_q=llm.lm_head_q)
    return cut, ChatTSModel(cut, model.ts_encoder, view)


class WordTokenizer:
    """A stand-in tokenizer: one id in [10, 400) per whitespace word (CRC32),
    far from the <ts> placeholder ids at the top of the vocabulary."""

    pad_token_id = 0
    eos_token_id = 1

    def encode(self, text: str, add_special_tokens: bool = False):
        import zlib

        return [10 + zlib.crc32(word.encode()) % 390 for word in text.split()]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        """Each id as ``t<id>``, so a client can read the ids back."""
        return " ".join(f"t{int(i)}" for i in ids)


def make_batch(cfg, specs, seed: int):
    """Prompts of filler words with one or more ``<ts><ts/>`` holes, and
    random-walk series; ``specs`` is a list of (words, [series lengths])."""
    import numpy as np

    from chatts_tpu_torch.processor.processor import ChatTSProcessor

    rng = np.random.default_rng(seed)
    texts, series = [], []
    for n_words, lengths in specs:
        holes = " ".join(f"series {j}: <ts><ts/>" for j in range(len(lengths)))
        words = " ".join(f"w{int(i)}" for i in rng.integers(0, 10 ** 6, n_words))
        texts.append(f"Please analyze {holes} and then answer. {words}")
        series.extend(rng.normal(0.0, 10.0, size=n).cumsum() for n in lengths)
    return ChatTSProcessor(WordTokenizer(), cfg)(texts, series)


def tail_logits(model, batch, device, n: int, act_int8: bool = False):
    """Logits (B, n, vocab) at each row's last n prompt positions (the last
    one at index n - 1), from one monolithic forward of the batch."""
    import torch

    def tensor(a, dtype):
        return torch.as_tensor(a, device=device).to(dtype)

    positions = tensor(batch.positions, torch.int32)
    seq_lens = tensor(batch.seq_lens, torch.int64)
    with torch.inference_mode():
        hidden, _ = model(
            tensor(batch.input_ids, torch.int64), positions,
            ts_values=tensor(batch.ts_values, torch.float32),
            ts_mask=tensor(batch.ts_mask, torch.float32),
            scatter_seq=tensor(batch.scatter_seq, torch.int64),
            scatter_tok=tensor(batch.scatter_tok, torch.int64),
            kv_valid=positions < seq_lens[:, None],
            kv_positions=positions,
            act_int8=act_int8,
        )
        pos = seq_lens[:, None] - n + torch.arange(n, device=device)[None, :]
        idx = pos[:, :, None].expand(-1, -1, hidden.shape[-1])
        return model.compute_logits(hidden.gather(1, idx)).float()


def cpu_plain_model(model):
    """``model`` moved to the CPU in f32, each int4 projection (and the
    head) a float ``Dense`` holding its weights dequantized once in f32.
    On a CPU tensor the int4 branch computes x @ dequantize(q, s) in f32
    (``int4_matmul_reference``) on every call; dequantizing once gives the
    same product without the per-call unpacking of 1.5 G weights a step.
    The weights are dequantized where they lie (on the card, many times
    faster than on the CPU; each value is one f32 product either way), then
    moved.  Not for ``act_int8``, which a float ``Dense`` ignores."""
    from chatts_tpu_torch.models.qwen import Dense
    from chatts_tpu_torch.ops import int4_matmul as i4

    for module in list(model.modules()):
        for name, child in list(module.named_children()):
            if (isinstance(child, Dense) and child.kernel_q4 is not None
                    and child.perm4 is None and child.zeros4 is None):
                setattr(module, name, Dense(i4.dequantize(child.kernel_q4, child.scales4),
                                            bias=child.bias))
    return model.to("cpu").float()


def phase_model():
    import torch

    from chatts_tpu_torch.models.quantize import init_quantized_params

    dev = torch.device("cuda", 0)
    with Phase(3, "ChatTS-14B widths, 2 layers, int4: kernel path (card, bf16) "
                  "against plain path (CPU, f32)"):
        cfg = chatts_14b_config(num_layers=2)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        model = init_quantized_params(cfg, gen, dev)
        batch = make_batch(cfg, [(250, [256]), (200, [800]), (150, [1024, 256]), (270, [300])],
                           seed=SEED)
        log(f"  prompt tokens {batch.seq_lens.tolist()}, padded to {batch.input_ids.shape[1]}")
        # The last position of each row is the one generation samples from;
        # the 31 before it add rows whose top-2 margin clears the tolerance
        # (random weights leave many near-ties).
        n = 32
        got = tail_logits(model, batch, dev, n).cpu()
        model.to("cpu").float()
        ref = tail_logits(model, batch, torch.device("cpu"), n)
        del model
        out = check_logits(torch, got, ref, "phase 3")
        torch.cuda.empty_cache()
        return out


def check_logits(torch, got, ref, what: str) -> dict:
    """Phase 3's rule for logits (B, n, vocab) of the card against the CPU's
    f32 plain path: within ``LOGIT_RTOL_OF_MAX`` of the largest plain logit,
    and the same argmax wherever the plain top-2 margin exceeds that."""
    b, n = ref.shape[:2]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite logits on the card")
    err = float((got - ref).abs().max())
    tol = LOGIT_RTOL_OF_MAX * float(ref.abs().max())
    top2 = ref.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    decided = margin > tol
    agree = got.argmax(-1) == ref.argmax(-1)
    log(f"  {what}: max |logit diff| {err:.4g} over the last {n} positions of {b} rows "
        f"(tolerance {tol:.4g} = {LOGIT_RTOL_OF_MAX} x max |plain logit| "
        f"{float(ref.abs().max()):.4g})")
    log(f"  {what}: argmax agrees on {int(agree.sum())}/{agree.numel()} positions; "
        f"{int(decided.sum())} have a top-2 margin above tolerance, and all of them must "
        f"agree (median top-2 margin {float(margin.median()):.3g}); last positions: "
        f"{int(agree[:, -1].sum())}/{b} agree, {int(decided[:, -1].sum())} decided")
    if err > tol:
        raise AssertionError(f"{what}: logits differ by {err:.4g} > {tol:.4g}")
    if not agree[decided].all():
        raise AssertionError(f"{what}: argmax differs where the top-2 margin exceeds the "
                             "tolerance")
    return dict(max_abs_logit_err=err, tolerance=tol)


def phase_model_a8():
    import torch

    from chatts_tpu_torch.models.quantize import init_quantized_params
    from chatts_tpu_torch.ops import int4_matmul as i4

    dev = torch.device("cuda", 0)
    with Phase("3c", "ChatTS-14B widths, 2 layers, int4, act_int8 prefill: B5 path (card, "
                     "bf16) against the plain a8 path (CPU, f32)"):
        cfg = chatts_14b_config(num_layers=2)
        model = init_quantized_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        batch = make_batch(cfg, [(250, [256]), (200, [800]), (150, [1024, 256]), (270, [300])],
                           seed=SEED)
        n = 32
        i4.int4_matmul_a8.launches = 0
        got = tail_logits(model, batch, dev, n, act_int8=True).cpu()
        if i4.int4_matmul_a8.launches != INT4_PROJECTIONS_PER_LAYER * cfg.llm.num_hidden_layers:
            raise AssertionError(f"the a8 prefill launched B5 {i4.int4_matmul_a8.launches} "
                                 "times, not once per int4 projection")
        bf16 = tail_logits(model, batch, dev, n).cpu()
        model.to("cpu").float()
        ref = tail_logits(model, batch, torch.device("cpu"), n, act_int8=True)
        del model
        if not torch.isfinite(got).all():
            raise AssertionError("non-finite logits on the card")
        err = float((got - ref).abs().max())
        tol = LOGIT_RTOL_OF_MAX * float(ref.abs().max())
        vs_bf16 = float((got - bf16).abs().max()) / float(bf16.abs().max())
        agree = float((got.argmax(-1) == bf16.argmax(-1)).float().mean())
        log(f"  prompt tokens {batch.seq_lens.tolist()}, padded to {batch.input_ids.shape[1]}; "
            f"max |logit diff| against the plain a8 path {err:.4g} (tolerance {tol:.4g} = "
            f"{LOGIT_RTOL_OF_MAX} x max |plain logit| {float(ref.abs().max()):.4g})")
        log(f"  a8 against the card's bf16 prefill: max |logit diff| {vs_bf16:.4g} of the "
            f"largest logit; argmax agrees at {agree:.1%} of the last {n} positions "
            f"(near-ties: not gated)")
        if err > tol:
            raise AssertionError(f"a8 logits differ by {err:.4g} > {tol:.4g}")
        torch.cuda.empty_cache()
        return dict(max_abs_logit_err=err, tolerance=tol, of_max_vs_bf16=vs_bf16)


class LogitRecorder:
    """Wraps a model's ``compute_logits`` to keep a host copy of every call's
    logits, for comparing what the engine computed step by step."""

    def __init__(self, llm):
        self.llm, self.inner, self.calls = llm, llm.compute_logits, []
        llm.compute_logits = self

    def __call__(self, hidden):
        logits = self.inner(hidden)  # (rows, 1, vocab) in prefill and decode
        self.calls.append(logits[:, -1].float().cpu())
        return logits

    def remove(self):
        del self.llm.compute_logits


class EagerDecodeRounds:
    """Stands in for ``ServeEngine``'s decode graph: each round runs its
    steps eagerly, as on the CPU, so that Python wrappers see every step."""

    def __init__(self, *args):
        self.args = args

    def round(self):
        from chatts_tpu_torch.serve import scheduler

        return scheduler._decode_all_slots(*self.args)


class EagerMixedRounds:
    """Stands in for ``ServeEngine``'s mixed-step graphs: each scan-sliced
    round runs its steps eagerly, as on the CPU."""

    def __init__(self, *args, pool=None):
        self.args = args

    def round(self):
        from chatts_tpu_torch.serve import scheduler

        return scheduler._mixed_round(*self.args)


class EagerBatchDecode:
    """Stands in for ``InferenceEngine``'s decode graph: each chunk runs its
    steps eagerly, as on the CPU."""

    def __init__(self, engine, state, gen_cfg):
        self.engine, self.state, self.gen_cfg = engine, state, gen_cfg

    def chunk(self, steps, generator):
        from chatts_tpu_torch.runtime import engine as engine_module

        engine_module._decode_chunk(self.engine, self.state, steps, generator, self.gen_cfg)


@contextlib.contextmanager
def eager_rounds(*kinds):
    """Within the block, the engines' graphs of the given kinds ("decode":
    ``ServeEngine``'s decode step, "mixed": its mixed steps, "batch":
    ``InferenceEngine``'s decode step) are replaced by their eager stand-ins
    wherever an engine makes one."""
    from chatts_tpu_torch.runtime import engine as engine_module
    from chatts_tpu_torch.serve import scheduler

    swaps = {"decode": (scheduler, "_DecodeStepGraph", EagerDecodeRounds),
             "mixed": (scheduler, "_MixedStepGraph", EagerMixedRounds),
             "batch": (engine_module, "_BatchDecodeGraph", EagerBatchDecode)}
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in map(swaps.get, kinds)]
    for owner, name, stand_in in map(swaps.get, kinds):
        setattr(owner, name, stand_in)
    try:
        yield
    finally:
        for owner, name, inner in saved:
            setattr(owner, name, inner)


class RoundClock:
    """Wraps the ``round`` method of the given classes with CUDA events on
    the current stream: each call's span on the device's clock, in order,
    read once the work has ended.  For a graph's round it is the replays'
    device time (they are enqueued back to back)."""

    def __init__(self, *classes):
        import torch

        self.events, self.saved = [], []
        for cls in classes:
            inner = cls.round

            def timed(obj, inner=inner):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = inner(obj)
                end.record()
                self.events.append((start, end))
                return out

            cls.round = timed
            self.saved.append((cls, inner))

    def read_ms(self) -> list:
        import torch

        torch.cuda.synchronize()
        return [start.elapsed_time(end) for start, end in self.events]

    def remove(self) -> None:
        for cls, inner in self.saved:
            cls.round = inner


def phase_serving_model():
    import numpy as np
    import torch

    from chatts_tpu_torch.models.qwen import embed_tokens
    from chatts_tpu_torch.models.quantize import init_quantized_params
    from chatts_tpu_torch.runtime import kv_cache
    from chatts_tpu_torch.serve.scheduler import Request, SamplingParams, ServeEngine
    from chatts_tpu_torch.processor.processor import ChatTSProcessor

    dev = torch.device("cuda", 0)
    n_steps = 8  # each is run again on the CPU in f32: most of this phase's time
    with Phase("3b", "ChatTS-14B widths, 2 layers, int4, int8 KV: ServeEngine on the card "
                     "against the same schedule on the CPU (plain, f32)"):
        cfg = chatts_14b_config(num_layers=2)
        model = init_quantized_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 3), dev)
        proc = ChatTSProcessor(WordTokenizer(), cfg)
        rng = np.random.default_rng(SEED + 3)
        # Every prompt under 256 tokens: one length class, one admission.
        specs = []
        for n_words, lengths in [(150, [256]), (100, [512, 256]), (200, [300]), (60, [800])]:
            holes = " ".join(f"series {j}: <ts><ts/>" for j in range(len(lengths)))
            words = " ".join(f"w{int(x)}" for x in rng.integers(0, 10 ** 6, n_words))
            specs.append((f"Please analyze {holes} and then answer. {words}",
                          [rng.normal(0.0, 10.0, size=n).cumsum() for n in lengths]))

        def serve(eager: bool):
            """The four requests as one admission and one decode round; with
            ``eager`` the round runs eagerly and every step's logits are
            recorded, else it replays the engine's CUDA graph."""
            reqs = [Request(prompt, series,
                            SamplingParams(max_tokens=n_steps + 1, temperature=0.0))
                    for prompt, series in specs]
            engine = ServeEngine(model, cfg, proc, device=dev, max_batch_size=len(reqs),
                                 max_model_len=1024, cache_dtype=torch.int8,
                                 decode_chunk=n_steps, fuse=False)
            recorder = LogitRecorder(model.llm) if eager else None
            try:
                engine.waiting.requeue(reqs)  # one monolithic admission of all four
                with eager_rounds("decode") if eager else contextlib.nullcontext(), engine:
                    deadline = time.time() + 300
                    while any(r.finished_s is None and r.error is None for r in reqs):
                        if time.time() > deadline:
                            raise TimeoutError("phase 3b requests did not finish")
                        time.sleep(0.01)
            finally:
                if recorder is not None:
                    recorder.remove()
            for r in reqs:
                if r.error or len(r.output_tokens) != n_steps + 1:
                    raise AssertionError(f"phase 3b request: error {r.error}, "
                                         f"{len(r.output_tokens)} tokens")
            stats = engine.stats()
            if stats.get("rounds_mono") != 1 or stats.get("rounds_decode") != 1:
                raise AssertionError(f"phase 3b ran another schedule: {stats}")
            return reqs, recorder

        def serve_block(eager: bool):
            """A runner decodes while a late request is admitted by a fused
            block round (``block_early_emit`` off), driven on this thread:
            the round's decode chunk replays the decode graph with the
            admitted row live, or, with ``eager``, every round runs eagerly."""
            engine = ServeEngine(model, cfg, proc, device=dev, max_batch_size=2,
                                 max_model_len=1024, cache_dtype=torch.int8,
                                 decode_chunk=n_steps, fuse=False)
            runner, late = (Request(prompt, series, SamplingParams(max_tokens=n, temperature=0.0))
                            for (prompt, series), n in zip(specs[:2], (3 * n_steps, n_steps + 1)))
            with eager_rounds("decode") if eager else contextlib.nullcontext(), \
                    torch.inference_mode():
                engine.submit(runner)
                engine._admit()
                engine._complete_round(engine._dispatch_round())  # a pure decode round
                engine.submit(late)
                engine._admit()
                if (engine._pending_mixed or {}).get("mode") != "block":
                    raise AssertionError("the late request was not staged as a block admission")
                while engine._pending_mixed is not None or engine.live_host.any():
                    engine._complete_round(engine._dispatch_round())
            for r, n in ((runner, 3 * n_steps), (late, n_steps + 1)):
                if r.error or len(r.output_tokens) != n:
                    raise AssertionError(f"phase 3b fused block round: error {r.error}, "
                                         f"{len(r.output_tokens)} tokens")
            return [runner.output_tokens, late.output_tokens], engine.stats()

        reqs, recorder = serve(eager=True)
        got = recorder.calls  # prefill (4, V), then n_steps decode steps (4, V)
        replayed, _ = serve(eager=False)
        if [r.output_tokens for r in replayed] != [r.output_tokens for r in reqs]:
            raise AssertionError("the decode graph served other tokens than the eager round")
        block_eager, _ = serve_block(eager=True)
        block_graph, block_stats = serve_block(eager=False)
        if block_stats["graph_rounds"].get("block") != 1:
            raise AssertionError(f"the fused block round did not replay the decode graph: "
                                 f"{block_stats['graph_rounds']}")
        if block_graph != block_eager:
            raise AssertionError("the fused block round's graph served other tokens than its "
                                 "eager round")

        # The same schedule on the CPU in f32, the card's tokens fed back.
        cpu_plain_model(model)
        batch = proc([r.prompt for r in reqs], [ts for r in reqs for ts in r.timeseries])
        tokens = torch.tensor([r.output_tokens for r in reqs], dtype=torch.int64)
        seq_lens = torch.as_tensor(batch.seq_lens, dtype=torch.int64)
        b, t = batch.input_ids.shape
        cpu = torch.device("cpu")
        with torch.inference_mode():
            caches = kv_cache.allocate(cfg.llm, b, 1024, torch.int8, cpu)
            positions = torch.arange(t, dtype=torch.int32)[None].repeat(b, 1)
            hidden, _ = model(
                torch.as_tensor(batch.input_ids, dtype=torch.int64), positions,
                ts_values=torch.as_tensor(batch.ts_values, dtype=torch.float32),
                ts_mask=torch.as_tensor(batch.ts_mask, dtype=torch.float32),
                scatter_seq=torch.as_tensor(batch.scatter_seq, dtype=torch.int64),
                scatter_tok=torch.as_tensor(batch.scatter_tok, dtype=torch.int64),
                kv_caches=caches, kv_valid=positions < seq_lens[:, None],
                kv_positions=positions)
            last = (seq_lens - 1)[:, None, None].expand(b, 1, hidden.shape[-1])
            want = [model.compute_logits(hidden.gather(1, last))[:, 0]]
            cur = seq_lens.to(torch.int32)
            for step in range(n_steps):
                pos = cur[:, None]
                hidden, _ = model.llm(embed_tokens(model.llm.embed_tokens, tokens[:, step:step + 1]),
                                      pos, kv_caches=caches, write_pos=pos, kv_lengths=cur + 1)
                want.append(model.compute_logits(hidden)[:, 0])
                cur = cur + 1
        del model
        if len(got) != len(want):
            raise AssertionError(f"the engine computed logits {len(got)} times, not {len(want)}")
        got_t, want_t = torch.stack(got), torch.stack(want)
        if not torch.isfinite(got_t).all():
            raise AssertionError("non-finite logits on the card")
        errs = (got_t - want_t).abs().amax(dim=(1, 2))
        tol = SERVE_LOGIT_RTOL_OF_MAX * float(want_t.abs().max())
        agree = (got_t.argmax(-1) == want_t.argmax(-1)).float().mean()
        log(f"  prompt tokens {batch.seq_lens.tolist()}, padded to {t}; max |logit diff| "
            f"first token {float(errs[0]):.4g}, decode steps {float(errs[1:].max()):.4g} "
            f"(tolerance {tol:.4g} = {SERVE_LOGIT_RTOL_OF_MAX} x max |plain logit| "
            f"{float(want_t.abs().max()):.4g}); argmax agrees at {float(agree):.0%}; the "
            f"decode graph served the eager round's tokens, and a fused block round from "
            f"the graph its eager round's ({[len(t) for t in block_graph]} tokens)")
        if float(errs.max()) > tol:
            raise AssertionError(f"int8-KV logits differ by {float(errs.max()):.4g} > {tol:.4g}")
        torch.cuda.empty_cache()


class SampleTape:
    """Stands in for ``sampling.sample_per_slot``: records every call's
    tokens on the host, or, given a recorded tape, returns its tokens in
    order, so that a second run takes the first run's tokens."""

    def __init__(self, replay=None):
        from chatts_tpu_torch.runtime import sampling

        self.sampling, self.inner = sampling, sampling.sample_per_slot
        self.replay, self.calls = replay, []
        sampling.sample_per_slot = self

    def __call__(self, logits, generator, temperature, top_p):
        if self.replay is not None:
            return self.replay.pop(0).to(logits.device)
        out = self.inner(logits, generator, temperature, top_p)
        self.calls.append(out.cpu())
        return out

    def remove(self):
        self.sampling.sample_per_slot = self.inner


def drive_scan_sliced(engine, runner, late) -> None:
    """Phase 3d's schedule on the calling thread, with no engine loop, so
    that the card and the CPU run the same one: the runner's monolithic
    admission, then the late request staged as a scan-sliced admission
    (``block_token_budget`` 0), then rounds until neither is left."""
    import torch

    engine.block_token_budget = 0
    with torch.inference_mode():
        engine.submit(runner)
        engine._admit()
        engine.submit(late)
        engine._admit()
        if (engine._pending_mixed or {}).get("mode") != "mixed":
            raise AssertionError("the late request was not staged as a scan-sliced admission")
        while engine._pending_mixed is not None or engine.live_host.any():
            engine._complete_round(engine._dispatch_round())


def phase_mixed_model():
    """Phase 3d: the scan-sliced mixed admission at the 14B widths (2 layers,
    int4, int8 KV) on the card against the same schedule on the CPU."""
    import numpy as np
    import torch

    from chatts_tpu_torch.models.quantize import init_quantized_params
    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.serve.scheduler import MIXED_NPT, Request, SamplingParams, ServeEngine

    dev = torch.device("cuda", 0)
    decode_chunk = 8
    with Phase("3d", "ChatTS-14B widths, 2 layers, int4, int8 KV: a scan-sliced admission "
                     "next to a decoding runner, card against the same schedule on the CPU "
                     "(plain, f32)"):
        cfg = chatts_14b_config(num_layers=2)
        model = init_quantized_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 4), dev)
        proc = ChatTSProcessor(WordTokenizer(), cfg)
        rng = np.random.default_rng(SEED + 4)

        def request(n_words, lengths, max_tokens):
            holes = " and ".join(f"series {j}: <ts><ts/>" for j in range(len(lengths)))
            words = " ".join(f"w{int(x)}" for x in rng.integers(0, 10 ** 6, n_words))
            return (f"Please analyze {holes} and then answer. {words}",
                    [rng.normal(0.0, 10.0, size=n).cumsum() for n in lengths], max_tokens)

        # The late prompt takes two rounds of 8 steps of 64 tokens; the
        # runner's budget ends with the second, and the late request's one
        # token ends it at its first: no pure decode round.
        specs = [request(150, [256], 2 * decode_chunk + 1), request(560, [1024, 1024], 1)]

        def serve(device, replay=None, graph=False):
            """The schedule, every round eager with each step's logits and
            tokens recorded (``replay`` feeds recorded tokens back), or with
            ``graph`` the mixed rounds replayed from their graphs."""
            reqs = [Request(p, ts, SamplingParams(max_tokens=n, temperature=0.0))
                    for p, ts, n in specs]
            engine = ServeEngine(model, cfg, proc, device=device, max_batch_size=2,
                                 max_model_len=1024, cache_dtype=torch.int8,
                                 decode_chunk=decode_chunk, fuse=False)
            if graph:
                drive_scan_sliced(engine, *reqs)
                recorder = tape = None
            else:
                recorder, tape = LogitRecorder(model.llm), SampleTape(replay)
                try:
                    with eager_rounds("decode", "mixed"):
                        drive_scan_sliced(engine, *reqs)
                finally:
                    tape.remove()
                    recorder.remove()
            for r in reqs:
                if r.error or len(r.output_tokens) != r.params.max_tokens:
                    raise AssertionError(f"phase 3d request: error {r.error}, "
                                         f"{len(r.output_tokens)} tokens")
            if engine.mixed_rounds_run != 2 or engine._decode_graph is not None:
                raise AssertionError(f"phase 3d ran another schedule: {engine.mixed_rounds_run} "
                                     "mixed rounds")
            if graph:
                stats = engine.stats()
                captures = [c for c in stats["graph_captures"] if c["kind"] == "mixed"]
                if stats["graph_rounds"] != {"mixed": 2} or len(captures) != 2:
                    raise AssertionError(f"phase 3d's mixed rounds did not replay two graphs: "
                                         f"{stats['graph_rounds']}, {captures}")
                return reqs, captures
            return reqs, recorder.calls, tape.calls

        reset_launches()
        reqs, got, tokens = serve(dev)
        replayed, captures = serve(dev, graph=True)
        launches = read_launches("scan-sliced model (3d)", (
            "flash_attention", "ragged_decode_attention_int8", "int4_matmul", "add_rms_norm",
            "silu_mul"))
        if [r.output_tokens for r in replayed] != [r.output_tokens for r in reqs]:
            raise AssertionError("the mixed rounds' graphs served other tokens than their eager "
                                 "rounds")
        log(f"  the mixed rounds from their graphs served the eager rounds' tokens; captures "
            f"(a, npt, kv_limit) {[c['key'] for c in captures]} in "
            f"{[round(c['seconds'], 3) for c in captures]} s, pool bytes "
            f"{[c['pool_bytes'] for c in captures]}")
        cpu_plain_model(model)
        _, want, _ = serve(torch.device("cpu"), replay=list(tokens))
        del model
        # The runner's prefill (1 row), 16 mixed steps (2 rows: the runner,
        # then the admission's slot, which is not live), the first token.
        if not len(got) == len(want) == 2 * decode_chunk + 2:
            raise AssertionError(f"logits computed {len(got)} times on the card, {len(want)} "
                                 f"on the CPU")
        pick = [0] + [slice(0, 1)] * (2 * decode_chunk) + [0]
        got_t = torch.cat([g[p].reshape(1, -1) for g, p in zip(got, pick)])
        want_t = torch.cat([w[p].reshape(1, -1) for w, p in zip(want, pick)])
        if not torch.isfinite(got_t).all():
            raise AssertionError("non-finite logits on the card")
        errs = (got_t - want_t).abs().amax(dim=1)
        tol = SERVE_LOGIT_RTOL_OF_MAX * float(want_t.abs().max())
        log(f"  prompt tokens {[r.prompt_tokens for r in reqs]}; npt {MIXED_NPT}, 2 mixed rounds of "
            f"{decode_chunk} steps; max |logit diff| runner prefill {float(errs[0]):.4g}, runner "
            f"in the mixed steps {float(errs[1:-1].max()):.4g}, the admission's first token "
            f"{float(errs[-1]):.4g} (tolerance {tol:.4g} = {SERVE_LOGIT_RTOL_OF_MAX} x max "
            f"|plain logit| {float(want_t.abs().max()):.4g})")
        if float(errs.max()) > tol:
            raise AssertionError(f"mixed-round logits differ by {float(errs.max()):.4g} > {tol:.4g}")
        torch.cuda.empty_cache()
    return launches


def slice_batch(cfg):
    """Phase 4's batch: 4 prompts of 512 to 1,300 tokens with 1 or 2 series."""
    return make_batch(cfg, [(500, [256]), (1050, [2000, 1000]), (700, [1500]),
                            (900, [256, 700])], seed=SEED + 1)


def phase_slice(smi: str):
    import torch

    from chatts_tpu_torch.models.quantize import init_quantized_params
    from chatts_tpu_torch.runtime.engine import InferenceEngine
    from chatts_tpu_torch.core.config import GenerationConfig

    dev = torch.device("cuda", 0)
    with Phase(4, "slice at full size: ChatTS-14B shape, 48 layers, int4, generate"):
        cfg = chatts_14b_config(num_layers=48)
        torch.cuda.reset_peak_memory_stats(dev)
        start = time.perf_counter()
        model = init_quantized_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        torch.cuda.synchronize(dev)
        weight_gb = _model_gb(model)
        log(f"  random int4 weights on the card: {weight_gb:.2f} GB in "
            f"{time.perf_counter() - start:.1f} s")
        engine = InferenceEngine(model, cfg, device=dev, cache_dtype=torch.bfloat16)
        batch = slice_batch(cfg)
        lens = batch.seq_lens.tolist()
        log(f"  prompt tokens {lens}, padded to {batch.input_ids.shape[1]}")
        if min(lens) < 512 or max(lens) > 1300:
            raise AssertionError(f"prompt lengths {lens} outside 512..1300")
        n_new = 64
        greedy = GenerationConfig(max_new_tokens=n_new, greedy=True)
        sampled = GenerationConfig(max_new_tokens=n_new, temperature=0.2)

        reset_launches()
        g1 = engine.generate(batch, greedy)
        g2 = engine.generate(batch, greedy)
        s1 = engine.generate(batch, sampled,
                             generator=torch.Generator(device=dev).manual_seed(SEED + 2))
        s2 = engine.generate(batch, sampled,
                             generator=torch.Generator(device=dev).manual_seed(SEED + 2))
        launches = read_launches("batch", ("flash_attention", "ragged_decode_attention",
                                           "int4_matmul") + GLUE)
        if launches["int4_matmul_a8"]:
            raise AssertionError("the bf16 prefill launched the int8-activation matmul")
        for r in (g1, g2, s1, s2):
            if [len(t) for t in r.token_ids] != [n_new] * len(lens):
                raise AssertionError(f"expected {n_new} tokens a row, got "
                                     f"{[len(t) for t in r.token_ids]}")
            if any(not 0 <= tok < cfg.llm.vocab_size for row in r.token_ids for tok in row):
                raise AssertionError("token id outside the vocabulary")
        if g1.token_ids != g2.token_ids:
            raise AssertionError("greedy generation is not deterministic")
        if s1.token_ids != s2.token_ids:
            raise AssertionError("sampled generation is not deterministic under one seed")
        if s1.token_ids == g1.token_ids:
            log("  note: sampled tokens equal the greedy ones at temperature 0.2")
        # Greedy and sampled are two keys: each captured once, replayed by
        # the second call.
        if (engine.decode_chunks["eager"] or len(engine.graph_captures) != 2
                or engine.decode_chunks["graph"] != 4 * -(-(n_new - 1) // engine.decode_chunk)):
            raise AssertionError(f"decode chunks {engine.decode_chunks}, captures "
                                 f"{engine.graph_captures}")
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        # The same calls with the decode chunks run eagerly, on an engine of
        # their own (the graph keeps its key's cache).
        with eager_rounds("batch"):
            eager = InferenceEngine(model, cfg, device=dev, cache_dtype=torch.bfloat16)
            e_g = eager.generate(batch, greedy)
            e_s = eager.generate(batch, sampled,
                                 generator=torch.Generator(device=dev).manual_seed(SEED + 2))
        del eager
        if e_g.token_ids != g1.token_ids or e_s.token_ids != s1.token_ids:
            raise AssertionError("decoding from the graph gave other tokens than eager decoding "
                                 f"(greedy {'equal' if e_g.token_ids == g1.token_ids else 'not'}, "
                                 f"sampled {'equal' if e_s.token_ids == s1.token_ids else 'not'})")
        stats = dict(
            batch=len(lens), prompt_tokens=lens, new_tokens=n_new,
            ttft_s=[g1.ttft_s, g2.ttft_s, s1.ttft_s, s2.ttft_s],
            tpot_s=[g1.tpot_s, g2.tpot_s, s1.tpot_s, s2.tpot_s],
            decode_tok_s=[len(lens) / r.tpot_s for r in (g1, g2, s1, s2)],
            eager_tpot_s=[e_g.tpot_s, e_s.tpot_s], eager_ttft_s=[e_g.ttft_s, e_s.ttft_s],
            graph_captures=engine.graph_captures, decode_chunks=engine.decode_chunks,
            peak_memory_gb=peak_gb, card=smi,
        )
        log(f"  TTFT {g2.ttft_s * 1e3:.1f} ms, TPOT {g2.tpot_s * 1e3:.2f} ms from the decode "
            f"graph, {len(lens) / g2.tpot_s:.1f} tok/s (greedy, second run; batch {len(lens)}); "
            f"eager decoding TPOT {e_g.tpot_s * 1e3:.2f} ms greedy, {e_s.tpot_s * 1e3:.2f} ms "
            f"sampled, the same tokens; captures (greedy, sampled) "
            f"{[round(c['seconds'], 3) for c in engine.graph_captures]} s, pool bytes "
            f"{[c['pool_bytes'] for c in engine.graph_captures]}; peak memory {peak_gb:.2f} GB; "
            f"card {smi}")
        log("  slice stats: " + json.dumps(stats))
        # The decode step's device time, outside the launch counts read above.
        step = profile_batch_decode_step(torch, engine, batch, greedy)
        log("  batch decode step profile: " + json.dumps(step))
        del engine
        torch.cuda.empty_cache()
    return launches, model, cfg, g2


def phase_slice_a8(smi: str, model, cfg, bf16_run):
    """Phase 4's batch again, with int8-activation prefill."""
    import torch

    from chatts_tpu_torch.runtime.engine import InferenceEngine
    from chatts_tpu_torch.core.config import GenerationConfig

    dev = torch.device("cuda", 0)
    with Phase("6a", "act_int8 slice at full size: ChatTS-14B shape, 48 layers, int4, "
                     "InferenceEngine(prefill_act_int8=True)"):
        engine = InferenceEngine(model, cfg, device=dev, cache_dtype=torch.bfloat16,
                                 prefill_act_int8=True)
        batch = slice_batch(cfg)
        lens = batch.seq_lens.tolist()
        n_new = 64
        greedy = GenerationConfig(max_new_tokens=n_new, greedy=True)
        reset_launches()
        g1 = engine.generate(batch, greedy)
        g2 = engine.generate(batch, greedy)
        launches = read_launches("batch_a8", ("flash_attention", "ragged_decode_attention",
                                              "int4_matmul", "int4_matmul_a8"))
        want = 2 * INT4_PROJECTIONS_PER_LAYER * cfg.llm.num_hidden_layers
        if launches["int4_matmul_a8"] != want:
            raise AssertionError(f"B5 launched {launches['int4_matmul_a8']} times, not {want}: "
                                 "once per int4 projection per prefill, none in decode or "
                                 "for the head")
        for r in (g1, g2):
            if [len(t) for t in r.token_ids] != [n_new] * len(lens):
                raise AssertionError(f"expected {n_new} tokens a row, got "
                                     f"{[len(t) for t in r.token_ids]}")
            if any(not 0 <= tok < cfg.llm.vocab_size for row in r.token_ids for tok in row):
                raise AssertionError("token id outside the vocabulary")
        if g1.token_ids != g2.token_ids:
            raise AssertionError("greedy generation with act_int8 is not deterministic")
        first_agree = sum(a[0] == b[0] for a, b in zip(g2.token_ids, bf16_run.token_ids))
        stats = dict(batch=len(lens), prompt_tokens=lens, new_tokens=n_new,
                     ttft_s=[g1.ttft_s, g2.ttft_s], tpot_s=[g1.tpot_s, g2.tpot_s],
                     bf16_prefill_ttft_s=bf16_run.ttft_s, card=smi)
        log(f"  TTFT {g2.ttft_s * 1e3:.1f} ms with act_int8 against {bf16_run.ttft_s * 1e3:.1f} ms "
            f"with the bf16 prefill (phase 4, greedy, second run); TPOT {g2.tpot_s * 1e3:.2f} ms; "
            f"first tokens equal to phase 4's in {first_agree}/{len(lens)} rows (near-ties: "
            f"not gated); card {smi}")
        log("  a8 slice stats: " + json.dumps(stats))
        del engine
        torch.cuda.empty_cache()
    return launches


class WaveGate:
    """Stands in for ``engine.submit`` under the server: it holds the
    requests that the server submits until a whole wave is in, then queues
    the wave in the order of its prompts with one ``requeue``, so every run
    admits the same waves into the same slots whatever order the server's
    threads submit them in (a sampled token depends on its slot's noise)."""

    def __init__(self, engine, size: int):
        import threading

        self.engine, self.size = engine, size
        self.held, self.all = [], []
        self.lock = threading.Lock()
        engine.submit = self.submit

    def submit(self, req):
        with self.lock:
            self.engine.total_requests += 1
            self.held.append(req)
            self.all.append(req)
            if len(self.held) == self.size:
                self.engine.waiting.requeue(sorted(self.held, key=lambda r: r.prompt))
                self.held = []
                self.engine._wake.set()
        return req


def chat_bodies(count: int, n_new: int, stream: int = -1) -> list:
    """``count`` bench-like chat requests (bench.py's _bench_prompt: 478
    prompt tokens, two series), greedy, ``n_new`` tokens; request ``stream``
    streams."""
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    filler = " ".join(f"word{i}" for i in range(400))
    bodies = []
    for i in range(count):
        parts = [{"type": "text", "text": "here are two metrics "},
                 {"type": "timeseries", "timeseries": rng.normal(0, 50, 256).cumsum().tolist()},
                 {"type": "text", "text": " and "},
                 {"type": "timeseries", "timeseries": rng.normal(0, 5, 512).cumsum().tolist()},
                 {"type": "text", "text": f". {filler} analyze their local changes."}]
        bodies.append({"model": "chatts", "max_tokens": n_new, "temperature": 0.0,
                       "stream": i == stream,
                       "messages": [{"role": "user", "content": parts}]})
    return bodies


def _post_chat(port: int, body: dict, timeout: float = 240.0) -> dict:
    """One /v1/chat/completions call; returns the token ids, the finish
    reason and the completion count as the client reads them."""
    import re
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read().decode()
    if body.get("stream"):
        chunks = [json.loads(line[6:]) for line in raw.split("\n\n")
                  if line.startswith("data: {")]
        if not raw.rstrip().endswith("data: [DONE]") or any("error" in c for c in chunks):
            raise AssertionError(f"bad stream: {raw[-300:]}")
        text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
        finish = chunks[-1]["choices"][0]["finish_reason"]
        ids = [int(x) for x in re.findall(r"t(\d+)", text)]
        return dict(ids=ids, finish=finish, completion_tokens=len(ids))
    data = json.loads(raw)
    choice = data["choices"][0]
    return dict(ids=[int(x) for x in re.findall(r"t(\d+)", choice["message"]["content"])],
                finish=choice["finish_reason"],
                completion_tokens=data["usage"]["completion_tokens"])


def device_kernels(prof, what: str, mark=()) -> dict:
    """The kernels of a ``torch.profiler`` trace by device time
    (``key_averages``): prints the ten with the most and returns the sums,
    with the share of the kernels whose name holds one of ``mark``."""
    from torch.autograd import DeviceType

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    if busy_ms <= 0:
        raise AssertionError(f"{what}: the profiler saw no device time")
    marked = [e for e in kernels if any(m in e.key for m in mark)]
    marked_ms = sum(device_us(e) for e in marked) / 1e3
    log(f"  {what}, under torch.profiler: {sum(e.count for e in kernels)} kernel "
        f"launches, {busy_ms:.3f} ms of device time; top kernels:")
    top = []
    for e in kernels[:10]:
        ms = device_us(e) / 1e3
        top.append(dict(kernel=e.key[:120], ms=ms, launches=e.count))
        log(f"    {ms:9.3f} ms {ms / busy_ms:6.1%} {e.count:6d} x  {e.key[:100]}")
    return dict(busy_ms=busy_ms, launches=sum(e.count for e in kernels), top=top,
                marked_ms=marked_ms, marked_launches=sum(e.count for e in marked))


def profile_decode_round(torch, engine, live: int = 16, steps: int = 4) -> dict:
    """The kernels of ``steps`` steps of a decode round under
    ``torch.profiler``, which does not see inside a CUDA graph's replay: the
    engine's round function runs once eagerly, from this thread while the
    engine idles, on copies of its state with ``live`` slots live at the
    lengths the served requests reached (its K/V writes land past them, in
    freed slots).  Every step of a round launches the same kernels, so a few
    steps give the round's shares at a fraction of the trace (a whole round
    of 32 steps took about 100 s to profile).  Prints the ten kernels with
    the most device time and the steps' device time."""
    from torch.profiler import ProfilerActivity, profile

    from chatts_tpu_torch.serve import scheduler

    dev, b = engine.device, engine.max_batch_size
    active = torch.arange(b, device=dev) < live
    budget = torch.full((b,), steps, dtype=torch.int32, device=dev)
    args = (engine.model, steps, engine.caches, engine.tokens.clone(),
            engine.cur_lens.clone(), active, engine.temperature.clone(), engine.top_p.clone(),
            engine._eos_dev, budget, torch.Generator(device=dev).manual_seed(SEED))
    with torch.inference_mode():
        scheduler._decode_all_slots(*args)
        budget.fill_(steps)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            scheduler._decode_all_slots(*args)
            torch.cuda.synchronize()
    out = device_kernels(prof, f"{steps} steps of a decode round ({b} slots, {live} live)",
                         mark=("ragged_decode_int8_kernel", "decode_merge_kernel"))
    calls = steps * engine.cfg.llm.num_hidden_layers
    if out["marked_launches"] < calls:
        raise AssertionError("the decode round's profile holds no int8 decode attention")
    log(f"  {steps} decode steps: {out['busy_ms']:.3f} ms of device time "
        f"({out['busy_ms'] / steps:.3f} ms a step), of it ragged_decode_attention_int8 (split "
        f"and merge) {out['marked_ms']:.3f} ms ({out['marked_ms'] / out['busy_ms']:.1%}) in "
        f"{out['marked_launches']} launches ({out['marked_ms'] / calls * 1e3:.1f} us a call)")
    out["steps"] = steps
    return out


def profile_batch_decode_step(torch, engine, batch, gen_cfg, steps: int = 16) -> dict:
    """One decode step of the batch engine as ``generate`` runs it on the
    card: the step captured in a CUDA graph (``_BatchDecodeGraph``) at the
    batch's prompt lengths, over a cache of ``generate``'s capacity filled
    with random values.  Its device time from CUDA events over ``steps``
    replays, then one replay under ``torch.profiler`` with the bf16 decode
    attention's share; where the profiler sees no kernel inside the replay,
    the same step run eagerly is profiled instead, and the log says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chatts_tpu_torch.runtime import engine as engine_module
    from chatts_tpu_torch.runtime import kv_cache
    from chatts_tpu_torch.runtime.engine import default_cache_len

    dev = engine.device
    b, t = batch.input_ids.shape
    cache_len = default_cache_len(t, gen_cfg.max_new_tokens)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    seq_lens = torch.as_tensor(batch.seq_lens, device=dev).to(torch.int32)
    with torch.inference_mode():
        caches = kv_cache.allocate(engine.cfg.llm, b, cache_len, engine.cache_dtype, dev)
        for layer in caches:
            for part in layer:
                part.copy_(torch.randn(part.shape, generator=gen, device=dev))
        state = engine_module._DecodeState(None, caches, b, steps, gen_cfg, dev)
        state.tokens.copy_(torch.randint(10, 400, (b,), generator=gen, device=dev))
        state.cur_lens.copy_(seq_lens)
        graph = engine_module._BatchDecodeGraph(engine, state, gen_cfg)
        graph.chunk(steps, gen)  # warm
        state.cur_lens.copy_(seq_lens)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.chunk(steps, gen)
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / steps
        state.cur_lens.copy_(seq_lens)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            graph.chunk(1, gen)
            torch.cuda.synchronize()
        seen = any(e.device_type == DeviceType.CUDA for e in prof.key_averages())
        if not seen:
            log("  torch.profiler saw no kernel inside the graph's replay: the same step run "
                "eagerly is profiled instead")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                engine._decode_step(caches, state.tokens, state.cur_lens, gen, gen_cfg)
                torch.cuda.synchronize()
    out = device_kernels(prof, f"one batch decode step ({b} rows at {batch.seq_lens.tolist()} "
                               f"tokens, capacity {cache_len}; "
                               f"{'a graph replay' if seen else 'eager'})",
                         mark=("ragged_decode_split_kernel", "decode_merge_kernel",
                               "ragged_decode_kernel<"))  # the last: before the split
    layers = engine.cfg.llm.num_hidden_layers
    if out["marked_launches"] < layers:
        raise AssertionError("the batch decode step's profile holds no decode attention")
    out.update(replay_step_ms=step_ms, profiled="replay" if seen else "eager")
    log(f"  batch decode step: {step_ms:.3f} ms a step replayed from its graph (CUDA events over "
        f"{steps} replays); under the profiler ({out['profiled']}) {out['busy_ms']:.3f} ms of "
        f"device time, of it ragged_decode_attention {out['marked_ms']:.3f} ms "
        f"({out['marked_ms'] / out['busy_ms']:.1%}) in {out['marked_launches']} launches "
        f"({out['marked_ms'] / layers * 1e3:.1f} us a layer)")
    del graph, state, caches
    return out


def phase_serving(smi: str, model, cfg, act_int8: bool = False):
    """Phase 5, or with ``act_int8`` phase 6b: the same schedule with
    int8-activation prefill."""
    import concurrent.futures
    import urllib.request

    import numpy as np
    import torch

    from chatts_tpu_torch.serve.scheduler import ServeEngine
    from chatts_tpu_torch.serve.server import ChatTSServer
    from chatts_tpu_torch.processor.processor import ChatTSProcessor

    dev = torch.device("cuda", 0)
    path = "serving_a8" if act_int8 else "serving"
    required = ("flash_attention", "ragged_decode_attention_int8", "int4_matmul") + GLUE + (
        ("int4_matmul_a8",) if act_int8 else ())
    wave, n_new = 8, 64
    with Phase("6b" if act_int8 else 5,
               f"{'act_int8 ' if act_int8 else ''}serving slice at full size: ChatTS-14B, "
               f"48 layers, int4, int8 KV, ServeEngine"
               f"{'(prefill_act_int8=True)' if act_int8 else ''} behind ChatTSServer"):
        torch.cuda.reset_peak_memory_stats(dev)
        tokenizer = WordTokenizer()
        # bench.py's 14B serving engine (bench.py:843-859).
        engine = ServeEngine(model, cfg, ChatTSProcessor(tokenizer, cfg), device=dev,
                             max_batch_size=24, max_model_len=1024, cache_dtype=torch.int8,
                             decode_chunk=32, fuse=False, block_early_emit=True,
                             admission_bucket=8, prefill_act_int8=act_int8)
        gate = WaveGate(engine, wave)
        server = ChatTSServer(engine, tokenizer, host="127.0.0.1", port=0)
        bodies = chat_bodies(2 * wave, n_new, stream=wave + 3)
        runs = []
        server.start_background()
        try:
            if server._httpd is None:
                raise RuntimeError("the server did not come up")
            port = server._httpd.server_address[1]
            with concurrent.futures.ThreadPoolExecutor(2 * wave) as pool:
                reset_launches()
                for run in range(2):
                    start = time.perf_counter()
                    n_before = len(gate.all)
                    log_before = len(engine.round_snapshot())
                    futs = [pool.submit(_post_chat, port, bodies[i]) for i in range(wave)]
                    deadline = time.time() + 600
                    while (len(gate.all) < n_before + wave
                           or any(r.first_token_s is None for r in gate.all[n_before:])):
                        if time.time() > deadline or any(f.done() for f in futs):
                            raise RuntimeError("wave 1 did not start decoding")
                        time.sleep(0.005)
                    # Wave 1 is decoding: wave 2 joins through block admission.
                    futs += [pool.submit(_post_chat, port, bodies[i])
                             for i in range(wave, 2 * wave)]
                    results = [f.result(timeout=300) for f in futs]
                    wall = time.perf_counter() - start
                    reqs = gate.all[n_before:]
                    decode = [r["round_s"] for r in engine.round_snapshot()[log_before:]
                              if r["kind"] == "decode"]
                    runs.append((results, reqs, wall, decode))
                launches = read_launches(path, required)
            stats = engine.stats()
            check_glue_captures(stats, cfg, path)
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                        timeout=60) as r:
                metrics = json.loads(r.read())
            # 6b's decode rounds are phase 5's (act_int8 changes the prefill
            # only): profile them once, in phase 5.
            profile = None if act_int8 else profile_decode_round(torch, engine)
        finally:
            server.shutdown()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

        admissions = sum(stats.get(k, 0) for k in ("rounds_mono", "rounds_block_pre",
                                                   "rounds_block"))
        want = INT4_PROJECTIONS_PER_LAYER * cfg.llm.num_hidden_layers * admissions * act_int8
        if launches["int4_matmul_a8"] != want:
            raise AssertionError(f"B5 launched {launches['int4_matmul_a8']} times over "
                                 f"{admissions} admissions, not {want}")
        for results, reqs, _, _ in runs:
            for res in results:
                if (res["finish"] != "length" or res["completion_tokens"] != n_new
                        or len(res["ids"]) != n_new):
                    raise AssertionError(f"a request ended {res['finish']} with "
                                         f"{res['completion_tokens']} tokens")
                if any(not 0 <= tok < cfg.llm.vocab_size for tok in res["ids"]):
                    raise AssertionError("token id outside the vocabulary")
            if any(r.error for r in reqs):
                raise AssertionError(f"engine errors: {[r.error for r in reqs if r.error]}")
        for kind in ("rounds_mono", "rounds_block_pre", "rounds_decode"):
            if stats.get(kind, 0) < 1:
                raise AssertionError(f"{kind} is 0: {stats}")
        if metrics["total_requests"] != 4 * wave:
            raise AssertionError(f"/metrics counts {metrics['total_requests']} requests")
        if [r["ids"] for r in runs[0][0]] != [r["ids"] for r in runs[1][0]]:
            raise AssertionError("the second run of the schedule gave other tokens")

        summary = []
        for results, reqs, wall, decode in runs:
            ttft = np.asarray([r.ttft_s for r in reqs]) * 1e3
            first = min(r.first_token_s for r in reqs)
            last = max(r.finished_s for r in reqs)
            decode_tok_s = sum(len(r.output_tokens) - 1 for r in reqs) / (last - first)
            summary.append(dict(
                ttft_p50_ms=float(np.percentile(ttft, 50)),
                ttft_p90_ms=float(np.percentile(ttft, 90)),
                wave1_ttft_mean_ms=float(ttft[:wave].mean()),
                wave2_ttft_mean_ms=float(ttft[wave:].mean()),
                decode_tok_s=decode_tok_s, wall_s=wall,
                decode_round_ms=[x * 1e3 for x in decode]))
        rounds = {k: v for k, v in stats.items() if k.startswith("round")}
        for i, s in enumerate(summary):
            log(f"  run {i + 1}: TTFT p50 {s['ttft_p50_ms']:.1f} ms, p90 {s['ttft_p90_ms']:.1f} ms "
                f"(wave 1 mean {s['wave1_ttft_mean_ms']:.1f}, wave 2 mean "
                f"{s['wave2_ttft_mean_ms']:.1f}); aggregate decode {s['decode_tok_s']:.1f} tok/s; "
                f"{2 * wave} requests x {n_new} tokens in {s['wall_s']:.2f} s; decode rounds "
                f"{', '.join(f'{x:.1f}' for x in s['decode_round_ms'])} ms")
        log(f"  rounds (both runs): {json.dumps(rounds)}; every decode round replayed one "
            f"CUDA graph, captured in the first ({json.dumps(stats['graph_captures'])}; "
            f"launches count a captured kernel once)")
        log(f"  prompt tokens {sorted({r.prompt_tokens for r in runs[0][1]})}; peak memory "
            f"{peak_gb:.2f} GB; card {smi}")
        log(f"  {path} stats: " + json.dumps(dict(runs=summary, rounds=rounds,
                                                  graph_rounds=stats["graph_rounds"],
                                                  graph_captures=stats["graph_captures"],
                                                  peak_memory_gb=peak_gb, card=smi,
                                                  decode_round_profile=profile)))
        del engine
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 8: chunked prefill and the scan-sliced mixed admission at full size
# ---------------------------------------------------------------------------

class ShapeSpy:
    """While a region runs, counts the query lengths T of the decoder's
    prefill attention calls and the rows R of its int4 projections (by
    wrapping the names ``models/qwen.py`` calls; the wrappers still count
    the launches), and each kernel's launches inside the region."""

    def __init__(self):
        import collections

        from chatts_tpu_torch.models import qwen

        self.qwen, self.attention, self.int4 = qwen, qwen.attention, qwen.int4_matmul
        self.t, self.r = collections.Counter(), collections.Counter()
        self.regions, self.notes, self.wrapped, self.on = {}, {}, [], False
        qwen.attention, qwen.int4_matmul = self._attention, self._int4

    def _attention(self, q, *args, **kw):
        if self.on:
            self.t[q.shape[1]] += 1
        return self.attention(q, *args, **kw)

    def _int4(self, x, *args, **kw):
        if self.on:
            self.r[x.shape[0]] += 1
        return self.int4(x, *args, **kw)

    def region(self, owner, name: str, label: str, note=None) -> None:
        """Wrap ``owner.name``: launches inside its calls add to
        ``regions[label]``, and ``note(args)`` of each call to ``notes[label]``."""
        inner = getattr(owner, name)
        counts = self.regions.setdefault(label, {k: 0 for k in kernel_wrappers()})
        notes = self.notes.setdefault(label, [])

        def wrapped(*args, **kw):
            before = {k: fn.launches for k, fn in kernel_wrappers().items()}
            self.on = True
            try:
                return inner(*args, **kw)
            finally:
                self.on = False
                for k, fn in kernel_wrappers().items():
                    counts[k] += fn.launches - before[k]
                if note is not None:
                    notes.append(note(args))

        setattr(owner, name, wrapped)
        self.wrapped.append((owner, name, inner))

    def remove(self) -> None:
        self.qwen.attention, self.qwen.int4_matmul = self.attention, self.int4
        for owner, name, inner in self.wrapped:
            setattr(owner, name, inner)


def long_chat_bodies(count: int, n_new: int) -> list:
    """Phase 8b's second wave: ``count`` chat requests of about 2,400 to
    2,900 prompt tokens, four series of 512 points each and a long text,
    greedy, ``n_new`` tokens."""
    import numpy as np

    rng = np.random.default_rng(SEED + 8)
    bodies = []
    for i in range(count):
        parts = [{"type": "text", "text": "here are four metrics "}]
        for j in range(4):
            parts += [{"type": "timeseries", "timeseries": rng.normal(0, 10, 512).cumsum().tolist()},
                      {"type": "text", "text": f" metric {j} "}]
        filler = " ".join(f"word{k}" for k in range(2250 + 150 * i))
        parts.append({"type": "text", "text": f". {filler} compare their local changes."})
        bodies.append({"model": "chatts", "max_tokens": n_new, "temperature": 0.0,
                       "messages": [{"role": "user", "content": parts}]})
    return bodies


def wave1_rate(reqs) -> dict:
    """Phase 8's wave 1 decode rate while wave 2 is admitted: the tokens
    after the first over the time from the first first token to the last
    finish (tokens/s, all requests), and the mean time a token a request."""
    n = sum(len(r.output_tokens) - 1 for r in reqs)
    if not n:
        return {}
    span = max(r.finished_s for r in reqs) - min(r.first_token_s for r in reqs)
    tpot = [(r.finished_s - r.first_token_s) / (len(r.output_tokens) - 1) for r in reqs]
    return dict(wave1_tok_s=n / span, wave1_tpot_ms=1e3 * sum(tpot) / len(tpot))


def profile_mixed_round(torch, engine, steps: int = 4, live: int = 8, a: int = 4,
                        npt: int = 64, kv_limit: int = 4096) -> dict:
    """The steps of a scan-sliced mixed round under ``torch.profiler``, as
    phase 8b's second round runs them: the engine's round function with
    ``steps`` steps (an eighth of the 32-step round: its steps have the same
    shapes, and a whole round's 180,000 launches cost the profiler minutes),
    run eagerly from this thread after the engine stopped, on copies of its
    decode state with ``live`` slots live and ``a`` admission rows of
    ``npt`` tokens a step in the last slots at offset kv_limit / 2 (its K/V
    writes land in slots and positions no request reads).  Prints the ten
    kernels with the most device time, and the share of the int8 prefix's
    dequantized, token-major copies (``qwen._cache_prefix``, timed alone by
    CUDA events for one layer, times the layers and steps)."""
    from torch.profiler import ProfilerActivity, profile

    from chatts_tpu_torch.models import qwen
    from chatts_tpu_torch.serve import scheduler

    dev, b, chunk = engine.device, engine.max_batch_size, steps
    hdim, layers = engine.cfg.llm.hidden_size, engine.cfg.llm.num_hidden_layers
    gen = torch.Generator(device=dev).manual_seed(SEED)
    slots = torch.arange(b - a, b, device=dev)
    seq_lens = torch.full((a,), kv_limit - 100, dtype=torch.int32, device=dev)
    embeds = torch.randn((a, chunk * npt, hdim), generator=gen, device=dev).to(torch.bfloat16)
    active = torch.arange(b, device=dev) < live
    budget = torch.full((b,), chunk, dtype=torch.int32, device=dev)

    with torch.inference_mode():
        inp = scheduler._MixedInputs(b, a, npt, chunk, hdim, torch.bfloat16, dev)
        inp.load(embeds, 0, slots, a, seq_lens, torch.zeros((a, hdim), device=dev), active,
                 budget)
        inp.off.fill_(kv_limit // 2)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            scheduler._mixed_round(
                engine.model, chunk, npt, kv_limit, engine.caches, engine.tokens.clone(),
                engine.cur_lens.clone(), active, engine.temperature.clone(),
                engine.top_p.clone(), engine._eos_dev, budget, gen, inp)
            torch.cuda.synchronize()
        prefix_ms = graph_ms(lambda: qwen._cache_prefix(engine.caches[0], slots, kv_limit,
                                                         torch.bfloat16))
    out = device_kernels(prof, f"{chunk} steps of a mixed round ({b} slots, {live} live, "
                               f"a {a} x npt {npt}, kv_limit {kv_limit})",
                         mark=("ragged_decode_int8_kernel", "decode_merge_kernel"))
    prefix_steps_ms = prefix_ms * layers * chunk
    out.update(steps=chunk, prefix_layer_ms=prefix_ms, prefix_steps_ms=prefix_steps_ms)
    log(f"  {chunk} mixed steps: {out['busy_ms']:.3f} ms of device time "
        f"({out['busy_ms'] / chunk:.2f} ms a step); the int8 decode attention "
        f"{out['marked_ms']:.3f} ms ({out['marked_ms'] / out['busy_ms']:.1%}); the dequantized "
        f"prefix copies {prefix_ms:.4f} ms a layer-step, {prefix_steps_ms:.1f} ms "
        f"({prefix_steps_ms / out['busy_ms']:.1%} of the device time)")
    return out


def phase_chunked(smi: str, model, cfg, bf16_run) -> dict:
    """Phase 8 at the 14B shape on phase 4's weights: (a) phase 4's batch
    with ``prefill_chunk=512``; (b) ``ServeEngine`` at cap 6,144 behind
    ``ChatTSServer``: 8 of phase 5's requests, then, while they decode, 4
    requests of 2,400 to 2,900 tokens that no block can take (4 x T >
    8,192): two scan-sliced rounds; (m) the same two waves with the block
    budget raised to 4 x 6,144, so that wave 2 is admitted as one block
    prefill next to the decoding slots, the route the scan-sliced one
    replaces; (c) the same engine with ``prefill_chunk=1024`` and the 4 long
    requests on an idle engine.  Each run twice, token-identical; then one
    mixed round profiled.  Returns each path's launches."""
    import concurrent.futures

    import numpy as np
    import torch

    from chatts_tpu_torch.core.config import GenerationConfig
    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.runtime.engine import InferenceEngine
    from chatts_tpu_torch.serve import scheduler
    from chatts_tpu_torch.serve.scheduler import ServeEngine
    from chatts_tpu_torch.serve.server import ChatTSServer

    dev = torch.device("cuda", 0)
    paths, stats = {}, dict(card=smi)
    layers = cfg.llm.num_hidden_layers
    with Phase("8a", "chunked prefill at full size: phase 4's batch, prefill_chunk=512"):
        batch = slice_batch(cfg)
        mono = InferenceEngine(model, cfg, device=dev, cache_dtype=torch.bfloat16)
        chunked = InferenceEngine(model, cfg, device=dev, cache_dtype=torch.bfloat16,
                                  prefill_chunk=512)
        first = {}
        for name, engine in (("mono", mono), ("chunked", chunked)):
            recorder = LogitRecorder(model.llm)
            try:
                engine.generate(batch, GenerationConfig(max_new_tokens=1, greedy=True))
            finally:
                recorder.remove()
            first[name] = recorder.calls[0]
        err = float((first["chunked"] - first["mono"]).abs().max())
        tol = LOGIT_RTOL_OF_MAX * float(first["mono"].abs().max())
        if not torch.isfinite(first["chunked"]).all() or err > tol:
            raise AssertionError(f"chunked first-token logits differ by {err:.4g} > {tol:.4g}")
        spy = ShapeSpy()
        spy.region(chunked, "_chunked_prefill", "chunked")
        greedy = GenerationConfig(max_new_tokens=64, greedy=True)
        try:
            reset_launches()
            g1 = chunked.generate(batch, greedy)
            g2 = chunked.generate(batch, greedy)
            paths["chunked_batch"] = read_launches("chunked batch (8a)", (
                "flash_attention", "ragged_decode_attention", "int4_matmul") + GLUE)
        finally:
            spy.remove()
        region = spy.regions["chunked"]
        n_chunks = -(-batch.input_ids.shape[1] // 512)
        if g1.token_ids != g2.token_ids:
            raise AssertionError("chunked greedy generation is not deterministic")
        if [len(t) for t in g1.token_ids] != [64] * len(g1.token_ids):
            raise AssertionError("expected 64 tokens a row")
        if (region["int4_matmul_a8"] or region["flash_attention"] != 2 * n_chunks * layers
                or set(spy.t) != {512}):
            raise AssertionError(f"chunked prefill launches {region}, attention T {dict(spy.t)}")
        agree = sum(a == b for a, b in zip(g2.token_ids, bf16_run.token_ids))
        stats["a"] = dict(ttft_s=[g1.ttft_s, g2.ttft_s], tpot_s=[g1.tpot_s, g2.tpot_s],
                          mono_ttft_s=bf16_run.ttft_s, first_logit_err=err, tolerance=tol,
                          chunk_launches=region, attention_t=dict(spy.t), int4_rows=dict(spy.r))
        log(f"  {n_chunks} chunks of 512 over {batch.input_ids.shape[1]} tokens "
            f"({batch.seq_lens.tolist()}); first-token logits against the monolithic prefill: "
            f"max |diff| {err:.4g} (tolerance {tol:.4g}); TTFT {g1.ttft_s * 1e3:.1f}, "
            f"{g2.ttft_s * 1e3:.1f} ms against phase 4's {bf16_run.ttft_s * 1e3:.1f} ms; TPOT "
            f"{g2.tpot_s * 1e3:.2f} ms; rows equal to phase 4's tokens: {agree}/{len(batch.seq_lens)}"
            f" (not gated); inside the chunked prefills: {region}, attention T {dict(spy.t)}, "
            f"int4 R {dict(spy.r)}")
        del mono, chunked
        torch.cuda.empty_cache()

    with Phase("8b", "scan-sliced admission at full size: ServeEngine, cap 6,144, int8 KV, "
                     "behind ChatTSServer; then (8c) prefill_chunk=1024 on an idle engine"):
        torch.cuda.reset_peak_memory_stats(dev)
        tokenizer = WordTokenizer()
        engine = ServeEngine(model, cfg, ChatTSProcessor(tokenizer, cfg), device=dev,
                             max_batch_size=24, max_model_len=6144, cache_dtype=torch.int8,
                             decode_chunk=32, fuse=False, block_early_emit=True,
                             admission_bucket=8)
        gate = WaveGate(engine, 8)
        server = ChatTSServer(engine, tokenizer, host="127.0.0.1", port=0)
        wave1, wave2 = chat_bodies(8, 64), long_chat_bodies(4, 64)
        sampled2 = [dict(body, temperature=0.8) for body in wave2]
        spy = ShapeSpy()
        # Each mixed step's shapes: the warm-up and the capture of a graph,
        # and every step of an eager round.
        spy.region(scheduler, "_mixed_step", "mixed", note=lambda args: args[1:3])
        clock = RoundClock(scheduler._MixedStepGraph, EagerMixedRounds)
        # "b" twice, "m" twice, "c" twice as described; "e" is 8b's schedule
        # with eager mixed rounds, "cs" and "ce" 8c's wave sampled from one
        # seed, its mixed rounds from the graphs and eager.
        forms = ("b", "b", "m", "m", "c", "c", "e", "cs", "ce")
        runs = {form: [] for form in forms}
        server.start_background()
        try:
            if server._httpd is None:
                raise RuntimeError("the server did not come up")
            port = server._httpd.server_address[1]
            with concurrent.futures.ThreadPoolExecutor(12) as pool:
                reset_launches()
                for form in forms:
                    start = time.perf_counter()
                    n_before, log_before = len(gate.all), len(engine.round_snapshot())
                    n_spans = len(clock.events)
                    futs = []
                    engine.block_token_budget = 4 * 6144 if form == "m" else 8192
                    engine.prefill_chunk = 1024 if form[0] == "c" else None
                    graphs = dict(engine._mixed_graphs)
                    if form in ("e", "ce"):
                        engine._mixed_graphs.clear()  # made again as eager stand-ins
                    if form in ("cs", "ce"):
                        engine.generator.manual_seed(SEED + 9)
                    with eager_rounds("mixed") if form in ("e", "ce") else contextlib.nullcontext():
                        if form[0] != "c":
                            gate.size = 8
                            futs = [pool.submit(_post_chat, port, body) for body in wave1]
                            deadline = time.time() + 600
                            while (len(gate.all) < n_before + 8
                                   or any(r.first_token_s is None for r in gate.all[n_before:])):
                                if time.time() > deadline or any(f.done() for f in futs):
                                    raise RuntimeError("wave 1 did not start decoding")
                                time.sleep(0.005)
                        # Wave 1 decodes (8b, 8m, 8e) or the engine idles (8c): wave 2.
                        gate.size = 4
                        futs += [pool.submit(_post_chat, port, body)
                                 for body in (sampled2 if form in ("cs", "ce") else wave2)]
                        results = [f.result(timeout=600) for f in futs]
                    if form in ("e", "ce"):
                        engine._mixed_graphs.clear()
                        engine._mixed_graphs.update(graphs)
                    runs[form].append((results, gate.all[n_before:], time.perf_counter() - start,
                                       engine.round_snapshot()[log_before:], n_spans,
                                       len(clock.events)))
                paths["serving_6144"] = read_launches("serving at cap 6,144 (8b, 8m, 8c)", (
                    "flash_attention", "ragged_decode_attention_int8", "int4_matmul") + GLUE)
            engine_stats = engine.stats()
        finally:
            server.shutdown()
            spy.remove()
            clock.remove()
        spans_ms = clock.read_ms()
        profile = profile_mixed_round(torch, engine)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

        region = spy.regions["mixed"]
        captures = [c for c in engine_stats["graph_captures"]
                    if c["kind"] == "mixed" and c["pool_bytes"] is not None]
        if sorted(c["key"] for c in captures) != [[4, 64, 2048], [4, 64, 4096]]:
            raise AssertionError(f"mixed graphs captured: {captures}")
        if region["int4_matmul_a8"] or not region["ragged_decode_attention_int8"]:
            raise AssertionError(f"the mixed rounds launched {region}")
        if set(spy.t) != {64} or 24 + 4 * 64 not in spy.r:
            raise AssertionError(f"mixed rounds: attention T {dict(spy.t)}, int4 R {dict(spy.r)}")
        if sorted({tuple(n) for n in spy.notes["mixed"]}) != [(64, 2048), (64, 4096)]:
            raise AssertionError(f"mixed rounds (npt, kv_limit): {spy.notes['mixed']}")
        summary = {}
        ids = {form: [r["ids"] for r in form_runs[0][0]] for form, form_runs in runs.items()}
        log(f"  8cs (sampled, mixed graphs) against 8ce (sampled, eager mixed rounds): requests "
            f"equal {[a == b for a, b in zip(ids['cs'], ids['ce'])]}; against 8c (greedy): "
            f"{[a == b for a, b in zip(ids['cs'], ids['c'])]}")
        for form, form_runs in runs.items():
            for results, reqs, _, rounds, _, _ in form_runs:
                if any(r.error for r in reqs):
                    raise AssertionError(f"engine errors: {[r.error for r in reqs if r.error]}")
                for res in results:
                    if (res["finish"] != "length" or res["completion_tokens"] != 64
                            or len(res["ids"]) != 64):
                        raise AssertionError(f"a request ended {res['finish']} with "
                                             f"{res['completion_tokens']} tokens")
                n_mixed = sum(r["kind"] == "mixed" for r in rounds)
                if n_mixed != (0 if form == "m" else 2):
                    raise AssertionError(f"8{form} ran {n_mixed} mixed rounds")
            if len(form_runs) == 2 and ([r["ids"] for r in form_runs[0][0]]
                                        != [r["ids"] for r in form_runs[1][0]]):
                raise AssertionError(f"8{form}: the second run gave other tokens")
            lens = sorted(r.prompt_tokens for r in form_runs[0][1][-4:])
            if lens[0] < 2400 or lens[-1] > 3000:
                raise AssertionError(f"wave 2 prompt tokens {lens} outside 2,400..3,000")
            kinds = {r["kind"] for _, _, _, rounds, _, _ in form_runs for r in rounds}
            if form == "m" and ("block_pre" not in kinds or "mixed" in kinds):
                raise AssertionError(f"8m ran rounds {kinds}, not a block admission")
            summary[form] = [dict(
                wave2_ttft_ms=[r.ttft_s * 1e3 for r in reqs[-4:]],
                wave1_ttft_ms=[r.ttft_s * 1e3 for r in reqs[:-4]], wall_s=wall,
                rounds=[(r["kind"], round(r["round_s"], 4)) for r in rounds],
                mixed_host_s=[r["round_s"] for r in rounds if r["kind"] == "mixed"],
                mixed_device_ms=spans_ms[first:last], **wave1_rate(reqs[:-4]))
                for _, reqs, wall, rounds, first, last in form_runs]
        if ids["e"] != ids["b"]:
            raise AssertionError("8b's mixed rounds from their graphs served other tokens than "
                                 "the same schedule with eager mixed rounds (8e)")
        if ids["cs"] != ids["ce"]:
            raise AssertionError("8c's sampled wave from the mixed graphs served other tokens "
                                 "than with eager mixed rounds")
        same, same_m = ids["b"][-4:] == ids["c"], ids["b"] == ids["m"]
        for form in runs:
            for i, run in enumerate(summary[form]):
                mixed = ", ".join(f"{t:.3f} s ({ms:.1f} ms)" for t, ms in
                                  zip(run["mixed_host_s"], run["mixed_device_ms"]))
                wave2 = ", ".join(f"{x:.0f}" for x in run["wave2_ttft_ms"])
                wave1 = (f"; wave 1 TTFT mean {np.mean(run['wave1_ttft_ms']):.1f} ms, decode "
                         f"{run['wave1_tok_s']:.1f} tokens/s ({run['wave1_tpot_ms']:.2f} ms "
                         "a token a request)" if run["wave1_ttft_ms"] else "")
                log(f"  8{form} run {i + 1}: wave 2 TTFT mean {np.mean(run['wave2_ttft_ms']):.1f} "
                    f"ms ({wave2}){wave1}; mixed rounds, host (device span) {mixed}; rounds "
                    f"{[k for k, _ in run['rounds']]}; wall {run['wall_s']:.2f} s")
        log(f"  wave 2 prompt tokens {sorted(r.prompt_tokens for r in runs['b'][0][1][-4:])}; "
            f"mixed rounds (npt, kv_limit) {sorted({tuple(n) for n in spy.notes['mixed']})}; "
            f"inside them (eager steps, warm-ups and captures): {region}, attention T "
            f"{dict(spy.t)}, int4 R {dict(spy.r)}; mixed graphs (a, npt, kv_limit) "
            f"{[c['key'] for c in captures]} captured in "
            f"{[round(c['seconds'], 3) for c in captures]} s, pool bytes "
            f"{[c['pool_bytes'] for c in captures]}; 8b's tokens equal to 8e's (eager mixed "
            f"rounds) and 8cs's sampled ones to 8ce's; wave 2's tokens in 8c "
            f"{'equal' if same else 'not equal'} to 8b's, both waves' in 8m "
            f"{'equal' if same_m else 'not equal'} to 8b's (not gated); peak memory "
            f"{peak_gb:.2f} GB; card {smi}")
        stats.update({form: summary[form] for form in runs})
        stats.update(mixed_launches=region, attention_t=dict(spy.t), int4_rows=dict(spy.r),
                     mixed_captures=captures, graph_rounds=engine_stats["graph_rounds"],
                     peak_memory_gb=peak_gb, mixed_round_profile=profile, c_equals_b=same,
                     m_equals_b=same_m)
        log("  chunked stats: " + json.dumps(stats))
        del engine, server, gate
        gc.collect()
        torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# Phase 7: a checkpoint from disk
# ---------------------------------------------------------------------------

# The ChatTS-14B GPTQ-Int4 directory's tensors: every layer's seven packed
# projections with scales, zeros and g_idx, three fp16 biases and two norms,
# and, besides the layers, two fp16 vocab tables and the fp16 encoder. Used
# to cut the depth where the disk cannot hold 48 layers.
GPTQ_14B_LAYER_BYTES = 140_000_000
GPTQ_14B_FIXED_BYTES = 3_400_000_000
DISK_LAYERS = 48
DISK_LOGIT_LAYERS = 2


def _projections(model):
    """(layer index, name, Dense) of every decoder projection."""
    for i, layer in enumerate(model.llm.layers):
        for group in (layer.self_attn, layer.mlp):
            for name in ("q_proj", "k_proj", "v_proj", "o_proj", "qkv_proj", "gate_proj",
                         "up_proj", "down_proj", "gate_up_proj"):
                dense = getattr(group, name, None)
                if dense is not None:
                    yield i, name, dense


def _logits_against_cpu(torch, ckpt: str, cfg, dev, what: str, extra=None) -> dict:
    """The first ``DISK_LOGIT_LAYERS`` layers of ``ckpt`` loaded by the same
    loader on the card and on the CPU, both in bf16, and the CPU's model run
    in f32; their logits at the last positions of a small batch held to
    phase 3's rule, bf16 and act_int8 prefill, each against the CPU's plain
    path of the same kind; then each layer alone (``per_layer_against_cpu``).
    ``extra(model)`` checks the card's model first.

    The CPU loads in bf16 because the separate fp16 head is quantized at
    load from the model's type: loaded in f32, the CPU quantized the fp16
    values where the card quantizes their bf16 rounding, some int4 codes of
    the head differed, and the logits moved by 0.18, 2.8% of the largest,
    on an H100 (``PERF.md``)."""
    import dataclasses

    from chatts_tpu_torch.models import weights

    cut = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                           num_hidden_layers=DISK_LOGIT_LAYERS))
    _, card = weights.load_checkpoint(ckpt, cut, quantize_bits=4, device=dev)
    if extra is not None:
        extra(card)
    _, cpu = weights.load_checkpoint(ckpt, cut, quantize_bits=4, device="cpu")
    cpu.float()
    batch = make_batch(cut, [(120, [256]), (200, [300, 128])], seed=SEED + 7)
    n, out = 8, {}
    for act_int8 in (False, True):
        got = tail_logits(card, batch, dev, n, act_int8=act_int8).cpu()
        ref = tail_logits(cpu, batch, torch.device("cpu"), n, act_int8=act_int8)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what}: non-finite logits on the card")
        err = float((got - ref).abs().max())
        tol = LOGIT_RTOL_OF_MAX * float(ref.abs().max())
        kind = "act_int8" if act_int8 else "bf16"
        log(f"  {what}, {kind} prefill: max |logit diff| {err:.4g} against the CPU's f32 "
            f"plain path (tolerance {tol:.4g}); argmax agrees at "
            f"{float((got.argmax(-1) == ref.argmax(-1)).float().mean()):.0%} of the last {n} "
            f"positions of {batch.seq_lens.tolist()} tokens")
        if err > tol:
            raise AssertionError(f"{what}, {kind}: logits differ by {err:.4g} > {tol:.4g}")
        out[kind] = dict(max_abs_logit_err=err, tolerance=tol)
    out["per_layer"] = per_layer_against_cpu(torch, card,
                                             make_batch(cut, LAYER_CHECK_SPECS, SEED + 7), what)
    del card, cpu
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 7t: tensor-parallel serving, two ranks on the card
# ---------------------------------------------------------------------------

# Phase 7t runs ``TP_RANKS`` ranks on cuda:0 over gloo (NCCL refuses two
# ranks on one device); a rank that fails or outlives TP_TIMEOUT_S fails the
# run, and every rank is killed.
TP_RANKS = 2
TP_TIMEOUT_S = 600
TP_NEW_TOKENS = 32
TP_SERVE_TOKENS = 32
# The first-step logits of the batch at tp = 2 against the single-device
# model, both bf16 on the card, 48 layers: each row-parallel projection
# rounds its two halves to bf16 before their sum (as JAX's psum of the
# kernel's bf16 output does), one more bf16 rounding of the sublayer's
# output than the single-device product, twice a layer; the difference then
# travels through the rest of the stack.  The 2-layer card-against-CPU
# check (7e) allows 1.5% of the largest logit for bf16 against f32; 48
# layers of one extra rounding a sublayer are held to twice that.
TP_LOGIT_RTOL_OF_MAX = 3e-2


def tp_requests(cfg, seed: int):
    """Phase 7t's four serving requests: prompts of 200 to 500 words with one
    or two series, greedy, ``TP_SERVE_TOKENS`` new tokens."""
    import numpy as np

    from chatts_tpu_torch.serve.scheduler import Request, SamplingParams

    rng = np.random.default_rng(seed)
    reqs = []
    for n_words, lengths in [(200, [256]), (350, [512, 256]), (500, [300]), (260, [800])]:
        holes = " ".join(f"series {j}: <ts><ts/>" for j in range(len(lengths)))
        words = " ".join(f"w{int(x)}" for x in rng.integers(0, 10 ** 6, n_words))
        reqs.append(Request(f"Please analyze {holes} and then answer. {words}",
                            [rng.normal(0.0, 10.0, size=n).cumsum() for n in lengths],
                            SamplingParams(max_tokens=TP_SERVE_TOKENS, temperature=0.0)))
    return reqs


def tp_serve_engine(model, cfg, dev):
    """The serving engine of phase 7t, on one card or one rank: int8 KV,
    8 slots, cap 2,048, decode chunk 16, no length classes (the four
    requests admit as one wave on both)."""
    import torch

    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.serve.scheduler import ServeEngine

    return ServeEngine(model, cfg, ChatTSProcessor(WordTokenizer(), cfg), device=dev,
                       max_batch_size=8, max_model_len=2048, cache_dtype=torch.int8,
                       decode_chunk=16, fuse=False, admission_binning=False)


class FirstLogits:
    """Wraps a model's ``compute_logits`` for its next call only: keeps a
    host copy of that call's logits (an admission's first tokens), then
    steps aside, so that a decode graph captured later sees the model's own
    function."""

    def __init__(self, llm):
        self.llm, self.inner, self.logits = llm, llm.compute_logits, None
        llm.compute_logits = self

    def __call__(self, hidden):
        self.remove()
        logits = self.inner(hidden)
        self.logits = logits[:, -1].float().cpu()
        return logits

    def remove(self):
        self.llm.__dict__.pop("compute_logits", None)


def tp_serve(engine, reqs):
    """The requests as one admission through ``engine`` (the driver's loop
    under tensor parallelism); returns the first tokens' logits."""
    recorder = FirstLogits(engine.model.llm)
    try:
        engine.waiting.requeue(reqs)  # one monolithic admission of all four
        with engine:
            deadline = time.time() + 300
            while any(r.finished_s is None and r.error is None for r in reqs):
                if time.time() > deadline:
                    raise TimeoutError("phase 7t requests did not finish")
                time.sleep(0.01)
    finally:
        recorder.remove()
    for r in reqs:
        if r.error or len(r.output_tokens) != TP_SERVE_TOKENS:
            raise AssertionError(f"phase 7t request: error {r.error}, "
                                 f"{len(r.output_tokens)} tokens")
    return recorder.logits


class DistClock:
    """While on, each ``torch.distributed`` call of the process (the port's
    collectives and point-to-point sends look them up there when they run)
    is timed on the host between two device syncs; ``seconds`` and
    ``calls`` add up, ``bytes`` the tensors' sizes (an ``all_gather``'s
    output list whole; a ``broadcast_object_list``'s pickled objects are
    not counted)."""

    NAMES = ("all_reduce", "all_gather", "broadcast", "broadcast_object_list", "send", "recv")

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.seconds, self.calls, self.bytes, self.saved = dist, 0.0, 0, 0, []
        for name in self.NAMES:
            inner = getattr(dist, name)
            self.saved.append((name, inner))
            setattr(dist, name, self._timed(inner))

    def _timed(self, inner):
        import torch

        def timed(tensor, *args, **kw):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = inner(tensor, *args, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - start
            self.calls += 1
            for t in tensor if isinstance(tensor, list) else [tensor]:
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
            return out

        return timed

    def remove(self) -> None:
        for name, inner in self.saved:
            setattr(self.dist, name, inner)


class KernelInputs:
    """While on, keeps the inputs of the model's first call at each shape to
    B1 (``attention``), B3 (``int4_matmul_tp``, ``int4_matmul``), B2 and B4
    (the ``_tp`` wrappers) on the card, by patching those names in
    ``models/qwen.py``; the wrappers themselves, and so their launch counts,
    are untouched.  The int4 weights are kept by reference (the model's own),
    the rest copied.  ``check()`` then holds each kernel against its plain
    version on those inputs, with phase 2's tolerances."""

    NAMES = (("attention", "flash_attention"), ("int4_matmul_tp", "int4_matmul"),
             ("int4_matmul", "int4_matmul"),
             ("ragged_decode_attention_tp", "ragged_decode_attention"),
             ("ragged_decode_attention_int8_tp", "ragged_decode_attention_int8"))

    def __init__(self):
        from chatts_tpu_torch.models import qwen

        self.qwen, self.calls, self.saved = qwen, {}, []
        for name, kernel in self.NAMES:
            inner = getattr(qwen, name)
            self.saved.append((name, inner))
            setattr(qwen, name, self._kept(kernel, inner))

    def _kept(self, kernel: str, inner):
        import torch

        def copy(i, a):
            weight = kernel == "int4_matmul" and i in (1, 2)
            return a.detach().clone() if isinstance(a, torch.Tensor) and not weight else a

        def kept(*args, **kw):
            if (args[0].is_cuda and kw.get("impl", "auto") == "auto"
                    and not torch.cuda.is_current_stream_capturing()):
                key = (kernel,) + tuple(tuple(a.shape) for a in args)
                if key not in self.calls:
                    self.calls[key] = ([copy(i, a) for i, a in enumerate(args)],
                                       {k: copy(-1, v) for k, v in kw.items()
                                        if k not in ("impl", "mesh", "kind")})
            return inner(*args, **kw)

        return kept

    def remove(self) -> None:
        for name, inner in self.saved:
            setattr(self.qwen, name, inner)

    def check(self) -> list:
        """(kernel, shapes, max_abs_err) of each kept call; raises where a
        kernel disagrees with its plain version."""
        from chatts_tpu_torch.ops import flash_attention as fa
        from chatts_tpu_torch.ops import int4_matmul as i4
        from chatts_tpu_torch.ops import ragged_decode_attention as rda

        plain = {"flash_attention": (fa.flash_attention, fa.flash_attention_reference, 0.0),
                 "int4_matmul": (i4.int4_matmul, i4.int4_matmul_reference, 0.0),
                 "ragged_decode_attention": (rda.ragged_decode_attention,
                                             rda.ragged_decode_attention_reference, 0.0),
                 "ragged_decode_attention_int8": (rda.ragged_decode_attention_int8,
                                                  rda.ragged_decode_attention_int8_reference,
                                                  INT8_ROW_RTOL)}
        out = []
        for key, (args, kw) in self.calls.items():
            kernel, shapes = key[0], key[1:]
            wrapper, reference, row_rtol = plain[kernel]
            what = f"{kernel} at the rank's shapes {shapes}"
            got = wrapper(*args, **kw)
            err = compare(got, reference(*args, **kw), what, row_rtol=row_rtol)
            if kernel == "int4_matmul":
                _int4_close(got, i4.int4_matmul_grouped_reference(*args), what)
            out.append((kernel, shapes, err))
        return out


def tp_decode_step_share(torch, engine, batch, steps: int = 4) -> dict:
    """The host time of ``steps`` batch decode steps (``engine._decode_step``
    at the batch's prompt lengths on a cache of random values), and the
    share of it in collectives, each timed between device syncs."""
    from chatts_tpu_torch.core.config import GenerationConfig
    from chatts_tpu_torch.runtime import kv_cache
    from chatts_tpu_torch.runtime.engine import default_cache_len

    dev = engine.device
    b, t = batch.input_ids.shape
    cache_len = default_cache_len(t, TP_NEW_TOKENS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    greedy = GenerationConfig(max_new_tokens=TP_NEW_TOKENS, greedy=True)
    with torch.inference_mode():
        caches = kv_cache.allocate(engine.cfg.llm, b, cache_len, engine.cache_dtype, dev,
                                   kv_heads=engine.model.llm.kv_heads)
        for layer in caches:
            for part in layer:
                part.copy_(torch.randn(part.shape, generator=gen, device=dev))
        tokens = torch.randint(10, 400, (b,), generator=gen, device=dev, dtype=torch.int32)
        cur_lens = torch.as_tensor(batch.seq_lens, device=dev).to(torch.int32)
        engine._decode_step(caches, tokens, cur_lens, gen, greedy)
        clock = DistClock()
        try:
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(steps):
                engine._decode_step(caches, tokens, cur_lens, gen, greedy)
            torch.cuda.synchronize()
            total = time.perf_counter() - start
        finally:
            clock.remove()
    return dict(step_ms=total / steps * 1e3, collective_ms=clock.seconds / steps * 1e3,
                collectives_a_step=clock.calls / steps, collective_share=clock.seconds / total)


def _tp_rank(rank: int, sym_dir: str, layers: int):
    """One rank of phase 7t: its shard of the directory, the first-step
    logits of phase 4's batch, then the batch engine (greedy) and the
    serving engine (rank 0 drives, the other follows), each kernel's
    launches on that path, and the times."""
    import dataclasses

    import torch

    from chatts_tpu_torch.core.config import ChatTSConfig, GenerationConfig
    from chatts_tpu_torch.models import weights
    from chatts_tpu_torch.parallel.mesh import all_reduce_tp, create_mesh
    from chatts_tpu_torch.runtime.engine import InferenceEngine

    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = create_mesh(tp=TP_RANKS)
    cfg = ChatTSConfig.from_pretrained(sym_dir)
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_hidden_layers=layers))
    torch.cuda.synchronize(dev)
    start = time.perf_counter()
    cfg, model = weights.load_checkpoint(sym_dir, cfg, quantize_bits=4, device=dev, mesh=mesh)
    torch.cuda.synchronize(dev)
    out = dict(rank=rank, load_s=time.perf_counter() - start, model_gb=_model_gb(model),
               heads=model.llm.layers[0].self_attn.num_heads,
               kv_heads=model.llm.kv_heads, vocab_rows=model.llm.embed_tokens.shape[0],
               q_out=model.llm.layers[0].self_attn.q_proj.out_features,
               down_in=model.llm.layers[0].mlp.down_proj.in_features)
    engine = InferenceEngine(model, cfg, device=dev)
    batch = slice_batch(cfg)
    greedy = GenerationConfig(max_new_tokens=TP_NEW_TOKENS, greedy=True)
    out["logits"] = tail_logits(model, batch, dev, 1)[:, 0].cpu()
    reset_launches()
    kept = KernelInputs()
    try:
        g1 = engine.generate(batch, greedy)
        serve = tp_serve_engine(model, cfg, dev)
        if mesh.is_driver:
            reqs = tp_requests(cfg, SEED + 12)
            out["serve_logits"] = tp_serve(serve, reqs).cpu()
            out["serve_tokens"] = [r.output_tokens for r in reqs]
            out["serve_stats"] = serve.stats()
            out["serve_ttft_ms"] = [r.ttft_s * 1e3 for r in reqs]
        else:
            serve.follow()
        torch.cuda.synchronize(dev)
    finally:
        kept.remove()
    out["launches"] = {name: fn.launches for name, fn in kernel_wrappers().items()}
    # Each kernel against its plain version on this rank's shard tensors, at
    # every shape the path gave it (these launches come after the count).
    out["kernel_checks"] = kept.check()
    del kept
    torch.cuda.empty_cache()
    out.update(tokens=g1.token_ids, ttft_s=g1.ttft_s, tpot_s=g1.tpot_s)
    out["decode_step"] = tp_decode_step_share(torch, engine, batch)
    # One row-parallel sum alone over gloo, bf16: a decode step's (4, 5,120)
    # and the batch prefill's (4 x 1,280 rows, 5,120).
    for name, rows, calls in (("all_reduce_4_rows_ms", 4, 50),
                              ("all_reduce_prefill_ms", batch.input_ids.size, 5)):
        x = torch.ones((rows, cfg.llm.hidden_size), dtype=torch.bfloat16, device=dev)
        all_reduce_tp(mesh, x)
        torch.cuda.synchronize(dev)
        start = time.perf_counter()
        for _ in range(calls):
            all_reduce_tp(mesh, x)
        torch.cuda.synchronize(dev)
        out[name] = (time.perf_counter() - start) / calls * 1e3
        del x
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del engine, serve, model
    gc.collect()
    torch.cuda.empty_cache()
    out.update(_dp_serve_rank(sym_dir, cfg, dev))
    return out


def _dp_serve_rank(sym_dir: str, cfg, dev) -> dict:
    """7t's data-parallel part on one rank: the whole model on a dp =
    ``TP_RANKS`` mesh, the 4 requests served with world rank 0 driving and
    the other rank (its dp group's) following; the launches on both."""
    import torch

    from chatts_tpu_torch.models import weights
    from chatts_tpu_torch.parallel.mesh import create_mesh

    dp_mesh = create_mesh(dp=TP_RANKS, tp=1)
    torch.cuda.reset_peak_memory_stats(dev)
    _, model = weights.load_checkpoint(sym_dir, cfg, quantize_bits=4, device=dev, mesh=dp_mesh)
    out = dict(dp_model_gb=_model_gb(model), dp_heads=model.llm.layers[0].self_attn.num_heads)
    reset_launches()
    serve = tp_serve_engine(model, cfg, dev)
    out["dp_driver"] = serve.is_driver
    if serve.is_driver:
        reqs = tp_requests(cfg, SEED + 12)
        start = time.perf_counter()
        out["dp_serve_logits"] = tp_serve(serve, reqs).cpu()
        out.update(dp_serve_s=time.perf_counter() - start,
                   dp_serve_tokens=[r.output_tokens for r in reqs], dp_serve_stats=serve.stats(),
                   dp_serve_ttft_ms=[r.ttft_s * 1e3 for r in reqs])
    else:
        serve.follow()
    torch.cuda.synchronize(dev)
    out["dp_launches"] = {name: fn.launches for name, fn in kernel_wrappers().items()}
    out["dp_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del serve, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_tp(smi: str, sym_dir: str, layers: int, model, cfg, single_run) -> tuple:
    """Phase 7t: ``TP_RANKS`` ranks on cuda:0 (gloo) each load their shard of
    the directory and run the batch engine and the serving engine; the
    first-step logits are held to the single-device model of 7c, the tokens
    reported against 7f's and a single-device serving engine's; then the
    same ranks serve at dp = 2 (``phase_dp_serve``).  Returns the ranks'
    summed kernel launches of both paths ("tp", "dp_serve")."""
    import numpy as np
    import torch

    from chatts_tpu_torch.parallel.distributed import run_world

    dev = torch.device("cuda", 0)
    batch = slice_batch(cfg)
    want = tail_logits(model, batch, dev, 1)[:, 0].cpu()
    engine = tp_serve_engine(model, cfg, dev)
    reqs = tp_requests(cfg, SEED + 12)
    want_serve = tp_serve(engine, reqs).cpu()
    single_round_ms = engine.stats().get("round_decode_mean_ms")
    single_serve = [r.output_tokens for r in reqs]
    del engine
    torch.cuda.empty_cache()
    log(f"  {TP_RANKS} ranks on one card ({torch.cuda.get_device_name(0)}) over gloo, which "
        f"carries each collective through host memory: these times are not NCCL times; "
        f"card: {smi}")
    start = time.perf_counter()
    ranks = run_world(_tp_rank, TP_RANKS, (sym_dir, layers), backend="gloo",
                      timeout_s=TP_TIMEOUT_S)
    log(f"  the world of {TP_RANKS} ranks ran in {time.perf_counter() - start:.1f} s")
    stats = {}
    for r in ranks:
        log(f"  rank {r['rank']}: loaded in {r['load_s']:.1f} s, {r['model_gb']:.2f} GB "
            f"({r['heads']} heads over {r['kv_heads']} kv heads, q OUT {r['q_out']}, down IN "
            f"{r['down_in']}, {r['vocab_rows']} vocabulary rows); peak {r['peak_gb']:.2f} GB; "
            f"launches {r['launches']}")
        if r["heads"] * TP_RANKS != cfg.llm.num_attention_heads or (
                r["vocab_rows"] * TP_RANKS != cfg.llm.vocab_size):
            raise AssertionError(f"rank {r['rank']} holds no tp shard")
    # (a) the batch engine
    for r in ranks:
        if r["tokens"] != ranks[0]["tokens"]:
            raise AssertionError("the ranks' greedy tokens differ")
        got = r["logits"]
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"rank {r['rank']}: first-step logits {tuple(got.shape)}")
    got = ranks[0]["logits"]
    err = float((got - want).abs().max())
    tol = TP_LOGIT_RTOL_OF_MAX * float(want.abs().max())
    tokens = ranks[0]["tokens"]
    agree = np.mean([a == b for ra, rb in zip(tokens, single_run.token_ids)
                     for a, b in zip(ra, rb)])
    first_agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"  (a) batch, tp {TP_RANKS}: first-step logits max |diff| {err:.4g} against the "
        f"single-device model (tolerance {tol:.4g} = {TP_LOGIT_RTOL_OF_MAX} x max |logit| "
        f"{float(want.abs().max()):.4g}); first tokens agree at {first_agree:.0%}; all "
        f"{TP_NEW_TOKENS} greedy tokens agree with 7f's at {agree:.1%}")
    if err > tol:
        raise AssertionError(f"tp logits differ by {err:.4g} > {tol:.4g}")
    # (b) serving
    sgot = ranks[0]["serve_logits"]
    serr = float((sgot - want_serve).abs().max())
    stol = TP_LOGIT_RTOL_OF_MAX * float(want_serve.abs().max())
    sagree = np.mean([a == b for ra, rb in zip(ranks[0]["serve_tokens"], single_serve)
                      for a, b in zip(ra, rb)])
    sstats = ranks[0]["serve_stats"]
    log(f"  (b) serving, tp {TP_RANKS}, int8 KV, rank 0 driving: first-token logits max |diff| "
        f"{serr:.4g} (tolerance {stol:.4g}); tokens agree with the single-device engine at "
        f"{sagree:.1%}; rounds mono {sstats.get('rounds_mono')}, decode "
        f"{sstats.get('rounds_decode')}; decode graph {sstats['decode_graph']} "
        f"({sstats['eager_decode_reason']})")
    if serr > stol:
        raise AssertionError(f"tp serving logits differ by {serr:.4g} > {stol:.4g}")
    if (sstats["decode_graph"] or sstats["loop_error"] or sstats.get("rounds_mono") != 1
            or any(k.startswith("rounds_block") for k in sstats)):
        raise AssertionError(f"phase 7t serving ran another schedule: {sstats}")
    # (c) the kernels at the ranks' shapes, then the launches, summed
    for r in ranks:
        checks = r["kernel_checks"]
        for kernel, shapes, kerr in checks:
            log(f"  rank {r['rank']}: {kernel} against its plain version at {shapes}: max_abs_err "
                f"{kerr:.3g}")
        missing = {"flash_attention", "ragged_decode_attention", "ragged_decode_attention_int8",
                   "int4_matmul"} - {kernel for kernel, _, _ in checks}
        if missing:
            raise AssertionError(f"rank {r['rank']}: no call of {sorted(missing)} was checked")
    launches = {name: sum(r["launches"][name] for r in ranks) for name in REPLACES}
    read = [n for n in ("flash_attention", "ragged_decode_attention",
                        "ragged_decode_attention_int8", "int4_matmul") if launches[n] < TP_RANKS]
    if read or launches["int4_matmul_a8"]:
        raise AssertionError(f"phase 7t launches: {launches}")
    log(f"  (c) kernel launches on the tp path, both ranks: {launches}")
    # (d) times
    r0 = ranks[0]
    step = r0["decode_step"]
    stats = dict(card=smi, ranks=TP_RANKS, backend="gloo", layers=layers,
                 load_s=[r["load_s"] for r in ranks], model_gb=[r["model_gb"] for r in ranks],
                 ttft_s=r0["ttft_s"], tpot_s=r0["tpot_s"],
                 single_ttft_s=single_run.ttft_s, single_tpot_s=single_run.tpot_s,
                 serve_round_decode_ms=sstats.get("round_decode_mean_ms"),
                 single_serve_round_decode_ms=single_round_ms,
                 serve_ttft_ms=r0["serve_ttft_ms"], decode_step=step,
                 all_reduce_4_rows_ms=r0["all_reduce_4_rows_ms"],
                 all_reduce_prefill_ms=r0["all_reduce_prefill_ms"],
                 kernel_shapes_checked=[len(r["kernel_checks"]) for r in ranks],
                 logit_err=err, logit_tol=tol, token_agreement=float(agree),
                 serve_logit_err=serr, serve_token_agreement=float(sagree),
                 peak_gb=[r["peak_gb"] for r in ranks])
    log(f"  (d) two ranks sharing one card over gloo: TTFT {r0['ttft_s'] * 1e3:.1f} ms, "
        f"TPOT {r0['tpot_s'] * 1e3:.2f} ms (single device, second run {single_run.ttft_s * 1e3:.1f} "
        f"ms, {single_run.tpot_s * 1e3:.2f} ms); a serving decode round of 16 steps "
        f"{sstats.get('round_decode_mean_ms')} ms eager (single device, graph: {single_round_ms} "
        f"ms); a decode step {step['step_ms']:.2f} ms with {step['collectives_a_step']:.0f} "
        f"collectives taking {step['collective_ms']:.2f} ms ({step['collective_share']:.1%}), "
        f"each timed between device syncs; one (4, {cfg.llm.hidden_size}) bf16 all_reduce "
        f"{r0['all_reduce_4_rows_ms']:.3f} ms, one ({batch.input_ids.size}, "
        f"{cfg.llm.hidden_size}) {r0['all_reduce_prefill_ms']:.2f} ms; card {smi}")
    log("  tp stats: " + json.dumps(stats))
    return launches, phase_dp_serve(smi, ranks, want_serve, single_serve)


def phase_dp_serve(smi: str, ranks, want_serve, single_serve) -> dict:
    """7t's data-parallel part: ``ServeEngine`` at dp = ``TP_RANKS``, tp = 1,
    world rank 0 driving both replicas; the tokens must equal the
    single-device engine's.  Returns the ranks' summed launches."""
    drivers = [r["dp_driver"] for r in ranks]
    if drivers != [True] + [False] * (TP_RANKS - 1):
        raise AssertionError(f"dp serving: drivers {drivers}, expected world rank 0 alone")
    r0 = ranks[0]
    sstats = r0["dp_serve_stats"]
    got = r0["dp_serve_logits"]
    err = float((got - want_serve).abs().max())
    same = r0["dp_serve_tokens"] == single_serve
    launches = {name: sum(r["dp_launches"][name] for r in ranks) for name in REPLACES}
    log(f"  (e) serving at dp {TP_RANKS}, tp 1 ({r0['dp_model_gb']:.2f} GB a rank, "
        f"{r0['dp_heads']} heads), world rank 0 driving: 4 requests x {TP_SERVE_TOKENS} tokens "
        f"{'equal to' if same else 'DIFFER from'} the single-device engine's; first-token "
        f"logits max |diff| {err:.4g}; {r0['dp_serve_s']:.2f} s, TTFT "
        f"{[round(x, 1) for x in r0['dp_serve_ttft_ms']]} ms, decode round "
        f"{sstats.get('round_decode_mean_ms')} ms eager ({sstats['eager_decode_reason']}); "
        f"peak {[round(r['dp_peak_gb'], 2) for r in ranks]} GB; launches, both ranks "
        f"{launches}; card {smi}")
    if not same:
        raise AssertionError("dp serving tokens differ from the single-device engine's")
    if sstats["loop_error"] or sstats.get("rounds_mono") != 1:
        raise AssertionError(f"dp serving ran another schedule: {sstats}")
    each = [r["dp_launches"] for r in ranks]
    for name in ("flash_attention", "ragged_decode_attention_int8", "int4_matmul"):
        if any(c[name] == 0 for c in each):
            raise AssertionError(f"dp serving: a replica did not launch {name}: {each}")
    log("  dp stats: " + json.dumps(dict(
        card=smi, ranks=TP_RANKS, model_gb=r0["dp_model_gb"], serve_s=r0["dp_serve_s"],
        ttft_ms=r0["dp_serve_ttft_ms"], round_decode_ms=sstats.get("round_decode_mean_ms"),
        logit_err=err, peak_gb=[r["dp_peak_gb"] for r in ranks])))
    return launches


def phase_disk(smi: str, fused_run, fused_launches: dict) -> dict:
    """Phase 7: the user's path from a directory on disk. A ChatTS-14B
    GPTQ-Int4 directory is synthesized in the published format, diagnosed,
    loaded into the int4 layout, checked to the bit against the CPU's
    conversion, held to the CPU's plain path at 2 layers, and run through
    ``InferenceEngine`` and the OpenAI server's ``build``; then the
    activation-order and asymmetric exports at 2 layers. Returns each path's
    kernel launches."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from chatts_tpu_torch.core.config import GenerationConfig
    from chatts_tpu_torch.examples import serve_openai
    from chatts_tpu_torch.models import gptq, weights
    from chatts_tpu_torch.ops import int4_matmul as i4
    from chatts_tpu_torch.runtime.engine import InferenceEngine
    from chatts_tpu_torch.scripts import rehearse_real_checkpoint as rehearsal

    dev = torch.device("cuda", 0)
    root = tempfile.mkdtemp(prefix="chatts_phase7_")
    paths, stats = {}, dict(card=smi)
    try:
        sym_dir = f"{root}/sym"
        with Phase("7a", "synthesize a ChatTS-14B GPTQ-Int4 directory (symmetric)"):
            free = shutil.disk_usage(root).free
            layers = DISK_LAYERS
            if GPTQ_14B_FIXED_BYTES + layers * GPTQ_14B_LAYER_BYTES > 0.8 * free:
                layers = int((0.8 * free - GPTQ_14B_FIXED_BYTES) // GPTQ_14B_LAYER_BYTES)
                log(f"  DEPTH CUT: {free / 1e9:.1f} GB free under {root} holds {layers} layers, "
                    f"not {DISK_LAYERS}")
                if layers < DISK_LOGIT_LAYERS:
                    raise RuntimeError("the disk holds too few layers for phase 7")
            info = rehearsal.synthesize(sym_dir, shape="14b", device=dev, seed=SEED,
                                        num_layers=layers, log=log)
            stats.update(layers=layers, disk_gb=info["bytes"] / 1e9,
                         synthesize_s=info["seconds"], free_disk_gb=free / 1e9)

        with Phase("7b", "diagnose"):
            report = weights.diagnose(sym_dir)
            log("  " + report.summary().replace("\n", "\n  "))
            if not report.ok or report.unused or report.gptq_projections != 7 * layers:
                raise AssertionError(f"diagnose: ok {report.ok}, {len(report.unused)} unused, "
                                     f"{report.gptq_projections} GPTQ projections")

        with Phase("7c", "load_checkpoint(quantize_bits=4) onto the card"):
            torch.cuda.synchronize(dev)
            before_gb = torch.cuda.memory_allocated(dev) / 1e9
            torch.cuda.reset_peak_memory_stats(dev)
            start = time.perf_counter()
            cfg, model = weights.load_checkpoint(sym_dir, quantize_bits=4, device=dev)
            torch.cuda.synchronize(dev)
            stats.update(load_s=time.perf_counter() - start, model_gb=_model_gb(model),
                         load_peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                         allocated_before_gb=before_gb)
            log(f"  loaded in {stats['load_s']:.1f} s: {stats['model_gb']:.2f} GB on the card, "
                f"peak device memory {stats['load_peak_gb']:.2f} GB ({before_gb:.2f} GB "
                f"allocated before the load)")
            bad = [(i, name) for i, name, d in _projections(model)
                   if d.kernel_q4 is None or d.scales4 is None]
            head = model.llm.lm_head_q
            if bad or head is None or head.kernel_q4 is None:
                raise AssertionError(f"not all in the int4 layout: {bad[:5]}, head {head}")
            if sum(1 for _ in _projections(model)) != 7 * layers:
                raise AssertionError("the loaded model's projections are fused")

        with Phase("7d", "lossless: layers 0 and last, card against the CPU's conversion"):
            with weights.LazyStateDict(sym_dir) as sd:
                for i in (0, layers - 1):
                    for name, d in ((n, d) for j, n, d in _projections(model) if j == i):
                        key = (f"model.layers.{i}."
                               f"{'mlp' if name in ('gate_proj', 'up_proj', 'down_proj') else 'self_attn'}"
                               f".{name}")
                        cpu = gptq.to_native_int4(sd, key, "cpu")
                        if not (torch.equal(d.kernel_q4.cpu(), cpu["kernel_q4"])
                                and torch.equal(d.scales4.cpu(), cpu["scales4"])):
                            raise AssertionError(f"{key}: the card's int4 differs from the CPU's")
                        want = gptq.dequantize(np.asarray(sd[key + ".qweight"]),
                                               np.asarray(sd[key + ".qzeros"]),
                                               np.asarray(sd[key + ".scales"], np.float32))
                        got = i4.dequantize(d.kernel_q4, d.scales4).cpu().numpy()
                        if not np.array_equal(got, want.astype(np.float32)):
                            raise AssertionError(f"{key}: dequantized differs from gptq.dequantize")
            log(f"  layers 0 and {layers - 1}: kernel_q4 and scales4 bit-equal to the CPU's "
                f"conversion, dequantized equal to gptq.dequantize in f32")

        with Phase("7e", f"logits, {DISK_LOGIT_LAYERS} layers of the directory: card (bf16) "
                         f"against the CPU (f32, plain)"):
            reset_launches()
            stats["logits_sym"] = _logits_against_cpu(torch, sym_dir, cfg, dev, "symmetric")

        with Phase("7f", f"generate from the loaded {layers}-layer model"):
            launches_logits = read_launches("disk_logits (7e)", (
                "flash_attention", "int4_matmul", "int4_matmul_a8"))
            engine = InferenceEngine(model, cfg, device=dev)
            batch = slice_batch(cfg)
            n_new = 64
            greedy = GenerationConfig(max_new_tokens=n_new, greedy=True)
            reset_launches()
            g1 = engine.generate(batch, greedy)
            g2 = engine.generate(batch, greedy)
            paths["disk_batch"] = read_launches("disk_batch", (
                "flash_attention", "ragged_decode_attention", "int4_matmul"))
            if g1.token_ids != g2.token_ids:
                raise AssertionError("greedy generation from the loaded model is not deterministic")
            if [len(t) for t in g1.token_ids] != [n_new] * len(g1.token_ids):
                raise AssertionError("expected 64 tokens a row")
            per_step = paths["disk_batch"]["int4_matmul"] / (2 * n_new)
            fused_step = fused_launches["int4_matmul"] / (4 * n_new)
            engine_a8 = InferenceEngine(model, cfg, device=dev, prefill_act_int8=True)
            reset_launches()
            a8 = engine_a8.generate(batch, greedy)
            paths["disk_batch_a8"] = read_launches("disk_batch_a8", (
                "flash_attention", "ragged_decode_attention", "int4_matmul", "int4_matmul_a8"))
            if paths["disk_batch_a8"]["int4_matmul_a8"] != 7 * layers:
                raise AssertionError("B5 not launched once per projection of the a8 prefill")
            step = profile_batch_decode_step(torch, engine, batch, greedy)
            stats.update(ttft_s=[g1.ttft_s, g2.ttft_s], tpot_s=[g1.tpot_s, g2.tpot_s],
                         decode_step_device_ms=step["busy_ms"], decode_step_launches=step["launches"],
                         a8_ttft_s=a8.ttft_s, a8_tpot_s=a8.tpot_s,
                         fused_ttft_s=fused_run.ttft_s, fused_tpot_s=fused_run.tpot_s,
                         int4_launches_per_step=per_step, fused_int4_launches_per_step=fused_step)
            log(f"  TTFT {g2.ttft_s * 1e3:.1f} ms, TPOT {g2.tpot_s * 1e3:.2f} ms (greedy, second "
                f"run) against phase 4's fused {fused_run.ttft_s * 1e3:.1f} ms and "
                f"{fused_run.tpot_s * 1e3:.2f} ms; int4 launches a generated token "
                f"{per_step:.0f} unfused against {fused_step:.0f} fused; act_int8 TTFT "
                f"{a8.ttft_s * 1e3:.1f} ms; one decode step {step['busy_ms']:.3f} ms of device "
                f"time in {step['launches']} launches")
            del engine, engine_a8

        with Phase("7t", f"tensor parallelism: {TP_RANKS} ranks on the card (gloo) load their "
                         f"shards of the {layers}-layer directory, generate and serve"):
            paths["tp"], paths["dp_serve"] = phase_tp(smi, sym_dir, layers, model, cfg, g2)

        with Phase("7g", "serve the loaded model through serve_openai.build"):
            args = serve_openai.parse_args([
                "--model", sym_dir, "--quantize-int4", "--kv-int8", "--max-batch-size", "24",
                "--max-model-len", "1024", "--decode-chunk", "32", "--admission-bucket", "8",
                "--early-first-token", "--no-warmup", "--host", "127.0.0.1", "--port", "0"])
            engine, server = serve_openai.build(args, loaded=(cfg, model, WordTokenizer()))
            gate = WaveGate(engine, 8)
            bodies = chat_bodies(8, 64)
            server.start_background()
            waves = []
            try:
                if server._httpd is None:
                    raise RuntimeError("the server did not come up")
                port = server._httpd.server_address[1]
                reset_launches()
                import concurrent.futures

                with concurrent.futures.ThreadPoolExecutor(8) as pool:
                    for _ in range(2):
                        start = time.perf_counter()
                        results = [f.result(timeout=300) for f in
                                   [pool.submit(_post_chat, port, b) for b in bodies]]
                        waves.append((results, time.perf_counter() - start))
                paths["disk_serving"] = read_launches("disk_serving", (
                    "flash_attention", "ragged_decode_attention_int8", "int4_matmul"))
            finally:
                server.shutdown()
            reqs = gate.all
            if any(r.error for r in reqs) or len(reqs) != 16:
                raise AssertionError(f"serving errors: {[r.error for r in reqs if r.error]}")
            if [r["ids"] for r in waves[0][0]] != [r["ids"] for r in waves[1][0]]:
                raise AssertionError("the second wave gave other tokens")
            if any(not r["ids"] for r in waves[0][0]):
                raise AssertionError("a request came back empty")
            ttft = [r.ttft_s * 1e3 for r in reqs]
            stats.update(serve_wave_s=[w for _, w in waves], serve_ttft_ms=ttft)
            log(f"  two waves of 8 requests over HTTP, token-identical; wave seconds "
                f"{', '.join(f'{w:.2f}' for _, w in waves)}; TTFT mean {np.mean(ttft[:8]):.1f} / "
                f"{np.mean(ttft[8:]):.1f} ms")
            del engine, server

        del model
        torch.cuda.empty_cache()
        reset_launches()
        for style in ("desc_act", "asym"):
            with Phase("7h", f"the {style} export, {DISK_LOGIT_LAYERS} layers at the 14B widths"):
                path = f"{root}/{style}"
                rehearsal.synthesize(path, shape="14b", device=dev, seed=SEED + 1,
                                     num_layers=DISK_LOGIT_LAYERS, log=log, **{style: True})
                field = "perm4" if style == "desc_act" else "zeros4"

                def has_field(card, field=field):
                    missing = [(i, n) for i, n, d in _projections(card) if getattr(d, field) is None]
                    if missing:
                        raise AssertionError(f"{style}: no {field} on {missing[:3]}")

                stats[f"logits_{style}"] = _logits_against_cpu(
                    torch, path, cfg, dev, style, extra=has_field)
                shutil.rmtree(path, ignore_errors=True)
        launches_7h = read_launches("disk_logits (7h)", ("flash_attention", "int4_matmul",
                                                         "int4_matmul_a8"))
        paths["disk_logits"] = {k: launches_logits[k] + launches_7h[k] for k in launches_7h}
        log("  disk stats: " + json.dumps(stats))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return paths


# ---------------------------------------------------------------------------
# Phase 10: ChatTS's batch evaluation at full size
# ---------------------------------------------------------------------------

EVAL_SAMPLES = 48
EVAL_GREEDY_SAMPLES = 8


class RecordingEngine:
    """Builds the ``ServeEngine`` subclass that ``run_eval.main`` is handed
    while it runs: each engine made and each request submitted is kept, so
    the phase reads the rounds and the requests' times afterwards."""

    def __init__(self):
        from chatts_tpu_torch.serve import scheduler

        self.engines, self.requests = [], []
        outer = self

        class Recording(scheduler.ServeEngine):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                outer.engines.append(self)

            def submit(self, request):
                outer.requests.append(request)
                return super().submit(request)

        self.cls = Recording


def eval_cap(cfg, samples, max_tokens: int) -> tuple:
    """(cache capacity, prompt token counts): 1,024, phase 5's, or the next
    multiple of 512 that holds the longest prompt with ``max_tokens`` new
    tokens (the port's engine refuses a write past its capacity)."""
    import numpy as np

    from chatts_tpu_torch.eval.inference import CHAT_TEMPLATE
    from chatts_tpu_torch.processor.processor import ChatTSProcessor

    proc = ChatTSProcessor(WordTokenizer(), cfg)
    lens = [int(proc([CHAT_TEMPLATE.format(prompt=s["question"])],
                     [np.asarray(t) for t in s["timeseries"]]).seq_lens[0]) for s in samples]
    return max(1024, -(-(max(lens) + max_tokens) // 512) * 512), lens


def check_answers(reqs, max_tokens: int, what: str) -> None:
    """Every request finished without an error, at EOS (fewer tokens, none
    of them EOS) or at ``max_tokens``."""
    for r in reqs:
        if r.error or r.finished_s is None:
            raise AssertionError(f"{what}: a request failed: {r.error}")
        n = len(r.output_tokens)
        if not ((r.finish_reason == "length" and n == max_tokens)
                or (r.finish_reason == "stop" and n < max_tokens)):
            raise AssertionError(f"{what}: a request ended {r.finish_reason} with {n} tokens")
        if WordTokenizer.eos_token_id in r.output_tokens:
            raise AssertionError(f"{what}: EOS inside an answer")


def phase_eval(smi: str, model, cfg) -> dict:
    """Phase 10: ChatTS's batch evaluation, the user's path of
    ``scripts/run_eval.sh``, at full size on phase 4's weights. (a) 8
    samples greedy, 64 new tokens, through ``LLMClient("tpu-ts")`` twice in
    one admission wave each (``WaveGate``): the same answers. (b)
    ``chatts_tpu_torch/scripts/run_eval.py::main`` on 48 samples of
    ``build_dataset(48, seed=SEED, seq_len=None)`` at the reference eval
    envelope (max_tokens 512, temperature 0.2), scored with 8 workers in this
    process (threads: the process holds a CUDA context). Returns 10b's
    kernel launches."""
    import os
    import shutil
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    from chatts_tpu_torch.eval import inference, scorers
    from chatts_tpu_torch.eval.inference import CHAT_TEMPLATE
    from chatts_tpu_torch.eval.make_eval_dataset import build_dataset
    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.scripts import run_eval
    from chatts_tpu_torch.serve import scheduler
    from chatts_tpu_torch.utils.llm_client import LLMClient

    dev = torch.device("cuda", 0)
    max_tokens = 512  # run_eval's default, with temperature 0.2: eval/inference.py's envelope
    root = tempfile.mkdtemp(prefix="chatts_phase10_")
    # No judge endpoint: rule scores only, and nothing leaves the machine.
    saved_env = {k: os.environ.get(k) for k in ("CONFIG_PATH", "CHATTS_JUDGE_URL")}
    os.environ["CONFIG_PATH"] = f"{root}/no_judge.toml"
    os.environ.pop("CHATTS_JUDGE_URL", None)
    stats = dict(card=smi)
    try:
        samples = build_dataset(EVAL_SAMPLES, seed=SEED, seq_len=None)
        cap, lens = eval_cap(cfg, samples, max_tokens)
        series_lens = [len(s["timeseries"][0]) for s in samples]
        log(f"  {len(samples)} samples, series of {min(series_lens)} to {max(series_lens)} "
            f"points, prompts of {min(lens)} to {max(lens)} tokens; cache capacity {cap}"
            + ("" if cap == 1024 else " (1,024 does not hold the longest prompt and 512)"))

        with Phase("10a", f"greedy eval answers twice: {EVAL_GREEDY_SAMPLES} samples, 64 new "
                          f"tokens, LLMClient('tpu-ts'), one wave each"):
            tok = WordTokenizer()
            # Phase 5's serving configuration (bench.py's 14B engine), as 10b's.
            engine = scheduler.ServeEngine(model, cfg, ChatTSProcessor(tok, cfg), device=dev,
                                           max_batch_size=24, max_model_len=cap,
                                           cache_dtype=torch.int8, decode_chunk=32,
                                           block_early_emit=True,
                                           eos_token_ids=(tok.eos_token_id,))
            gate = WaveGate(engine, EVAL_GREEDY_SAMPLES)
            client = LLMClient(engine="tpu-ts", serve_engine=engine,
                               sampling_params={"max_tokens": 64, "temperature": 0.0})
            sub = samples[:EVAL_GREEDY_SAMPLES]
            prompts = [CHAT_TEMPLATE.format(prompt=s["question"]) for s in sub]
            series = [[np.asarray(t) for t in s["timeseries"]] for s in sub]
            try:
                runs = []
                for _ in range(2):
                    start = time.perf_counter()
                    runs.append((client.llm_batch_generate(prompts, series),
                                 time.perf_counter() - start))
            finally:
                client.kill()
            check_answers(gate.all, 64, "10a")
            if any(a is None for out, _ in runs for a in out) or runs[0][0] != runs[1][0]:
                raise AssertionError("the second greedy run gave other answers")
            stats["greedy_s"] = [s for _, s in runs]
            stats["greedy_tokens"] = [len(r.output_tokens) for r in gate.all[:len(sub)]]
            log(f"  identical answers twice in {runs[0][1]:.2f} / {runs[1][1]:.2f} s; tokens "
                f"a sample {stats['greedy_tokens']}")
            del engine, gate, client
            gc.collect()

        with Phase("10b", f"run_eval.main: {EVAL_SAMPLES} samples, max_tokens {max_tokens}, "
                          f"temperature 0.2, scored with 8 workers"):
            dataset = f"{root}/dataset.json"
            with open(dataset, "w") as f:
                json.dump(samples, f)
            recorder, timing, raw = RecordingEngine(), {}, []

            def timed_inference(dataset_, client, exp, **kw):
                generate = client.llm_batch_generate

                def keep(prompts, ts_list=None, **kw_):
                    out = generate(prompts, ts_list, **kw_)
                    raw.extend(out)
                    return out

                client.llm_batch_generate = keep
                start = time.perf_counter()
                out = run_inference_(dataset_, client, exp, **kw)
                timing["inference_s"] = time.perf_counter() - start
                return out

            def timed_scoring(*args, **kw):
                timing["fork_is_safe"] = scorers.fork_is_safe()
                start = time.perf_counter()
                out = evaluate_experiment_(*args, **kw)
                timing["scoring_s"] = time.perf_counter() - start
                return out

            run_inference_ = inference.run_inference
            evaluate_experiment_ = inference.evaluate_experiment
            argv = [dataset, "random-chatts-14b-int4", "eval", "--exp-root", f"{root}/exp",
                    "--max-batch-size", "24", "--max-model-len", str(cap), "--decode-chunk",
                    "32", "--kv-int8", "--early-first-token", "--device", "cuda"]
            reset_launches()
            with mock.patch.object(scheduler, "ServeEngine", recorder.cls), \
                    mock.patch.object(inference, "run_inference", timed_inference), \
                    mock.patch.object(inference, "evaluate_experiment", timed_scoring):
                summary = run_eval.main(argv, loaded=(cfg, model, WordTokenizer()))
            launches = read_launches("eval", ("flash_attention", "ragged_decode_attention_int8",
                                              "int4_matmul"))
            if launches["int4_matmul_a8"]:
                raise AssertionError("the eval loop launched the int8-activation matmul")
            (engine,) = recorder.engines
            if engine.cache_dtype != torch.int8 or engine.max_batch_size != 24:
                raise AssertionError("run_eval built another engine than phase 5's")
            reqs = recorder.requests
            if len(reqs) != EVAL_SAMPLES or len(raw) != EVAL_SAMPLES or None in raw:
                raise AssertionError(f"{len(raw)} answers for {EVAL_SAMPLES} samples")
            check_answers(reqs, max_tokens, "10b")
            if timing["fork_is_safe"]:
                raise AssertionError("scoring would fork a process that holds a CUDA context")
            out_dir = f"{root}/exp/eval"
            with open(f"{out_dir}/generated_answer.json") as f:
                answers = json.load(f)
            with open(f"{out_dir}/detailed_result.json") as f:
                detailed = json.load(f)
            with open(f"{out_dir}/result.json") as f:
                if json.load(f) != summary:
                    raise AssertionError("result.json is not the printed summary")
            if [a["idx"] for a in answers] != list(range(EVAL_SAMPLES)):
                raise AssertionError("generated_answer.json misses samples")
            if sorted(d["idx"] for d in detailed) != list(range(EVAL_SAMPLES)):
                raise AssertionError(f"{len(detailed)} scored samples of {EVAL_SAMPLES}: "
                                     "scoring dropped some")
            if summary["consumed_tokens"] <= 0:
                raise AssertionError("no tokens counted")

            out_tokens = [len(r.output_tokens) for r in reqs]
            ttft = np.asarray([r.ttft_s for r in reqs]) * 1e3
            decode = [r["round_s"] for r in engine.round_snapshot() if r["kind"] == "decode"]
            rounds = {k: v for k, v in engine.stats().items() if k.startswith("round")}
            wall = timing["inference_s"]
            stats.update(
                samples_per_min=EVAL_SAMPLES / wall * 60, output_tok_s=sum(out_tokens) / wall,
                inference_s=wall, scoring_s=timing["scoring_s"], scoring_pool="thread",
                ttft_p50_ms=float(np.percentile(ttft, 50)),
                ttft_p90_ms=float(np.percentile(ttft, 90)),
                output_tokens=sum(out_tokens), ended_at_eos=sum(r.finish_reason == "stop"
                                                                for r in reqs),
                prompt_tokens=[min(lens), max(lens)], cap=cap,
                decode_round_ms=[min(decode) * 1e3, float(np.median(decode)) * 1e3,
                                 max(decode) * 1e3], decode_rounds=len(decode), rounds=rounds,
                graph_captures=engine.stats()["graph_captures"],
                summary=summary)
            log(f"  {EVAL_SAMPLES} samples in {wall:.2f} s: {stats['samples_per_min']:.1f} "
                f"samples/min, {stats['output_tok_s']:.1f} output tokens/s ({sum(out_tokens)} "
                f"tokens, {stats['ended_at_eos']} answers ended at EOS); TTFT p50 "
                f"{stats['ttft_p50_ms']:.1f} ms, p90 {stats['ttft_p90_ms']:.1f} ms")
            log(f"  decode rounds on the host: {len(decode)}, {stats['decode_round_ms'][0]:.1f} "
                f"/ {stats['decode_round_ms'][1]:.1f} / {stats['decode_round_ms'][2]:.1f} ms "
                f"(min / median / max); rounds {json.dumps(rounds)}")
            log(f"  scoring {timing['scoring_s']:.2f} s on threads (CUDA context held); "
                f"overall categorical {summary['overall_categorical']}, numerical "
                f"{summary['overall_numerical']}; card {smi}")
            log("  eval stats: " + json.dumps(stats))
            del engine, recorder
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 11: the datagen scripts through the port's OpenAI server
# ---------------------------------------------------------------------------

# NUM_DATA of both scripts. Every LLM stage costs at least one wave of
# 1,024-token answers (about 17 s at 24 slots), and at 8 TSEvol alone sends
# 255 prompts (3 for each of 85 seed rows), so the phase runs at 4.
DATAGEN_NUM = 4
# Phase 11 runs on phase 4's first layers: its stages are set by the number
# of requests and their 1,024 tokens, the depth only scales each step.
DATAGEN_LAYERS = 4
DATAGEN_MAX_TOKENS = 1024  # OpenAIClient's default, which the scripts keep
# The scripts' --llm-timeout: a request may wait behind a whole wave of
# 1,024-token answers, so the client's 60 s default would send it again.
DATAGEN_TIMEOUT_S = 900
DATAGEN_HOLE_STAGES = ("uts_llm_qa", "mts_local_llm_qa", "mts_shape_llm_qa")
DATAGEN_TEMPLATE_FILES = ("uts_template_qa.jsonl", "mts_shape_template_qa.jsonl",
                          "mts_local_template_qa.jsonl", "seed_template_qa.jsonl",
                          "evol_labels/seed_template_qa.json")


def run_datagen_scripts(out: str, llm_client=None):
    """``generate_align_datasets.main`` then ``generate_sft_datasets.main``
    into ``out`` at ``DATAGEN_NUM``: (the stages' report, {stage: [(prompt,
    answer)]}). Without ``llm_client`` the scripts take CHATTS_LLM_URL."""
    from unittest import mock

    from chatts_tpu_torch.scripts import generate_align_datasets, generate_sft_datasets
    from chatts_tpu_torch.utils.llm_client import LLMClient

    calls, current = {}, [None]
    run, generate = generate_align_datasets.Stages.run, LLMClient.llm_batch_generate

    def staged(self, name, fn):
        current[0] = name
        calls[name] = []
        return run(self, name, fn)

    def recorded(self, prompts, ts_list=None, progress_callback=None):
        answers = generate(self, prompts, ts_list, progress_callback)
        calls[current[0]].extend(zip(prompts, answers))
        return answers

    argv = ["--output-dir", out, "--num-data", str(DATAGEN_NUM), "--seed", str(SEED),
            "--llm-timeout", str(DATAGEN_TIMEOUT_S)]
    with mock.patch.object(generate_align_datasets.Stages, "run", staged), \
            mock.patch.object(LLMClient, "llm_batch_generate", recorded):
        report = generate_align_datasets.main(argv, llm_client)
        report.update(generate_sft_datasets.main(argv, llm_client))
    return report, calls


def datagen_parse_failures(stage: str, calls) -> int:
    """Answers a JSON-parsing stage could not read: QA lists for the seed
    LLM QA and the reasoning sets, one QA object for TSEvol's mutations
    (its verdicts are words, not JSON). The hole-filling stages parse
    nothing."""
    from chatts_tpu_torch.utils.json_utils import parse_llm_json

    if stage in DATAGEN_HOLE_STAGES:
        return 0
    want = dict if stage == "tsevol" else list
    return sum(not isinstance(parse_llm_json(a or ""), want)
               for p, a in calls if "Your Judgement" not in p and "请检查" not in p)


def check_datagen_labels(out: str) -> None:
    """The hole-filling stages' rows and labels: no ``<|prompt`` hole left,
    labels with the JAX package's keys (tests/test_sft_chain.py:42-65)."""
    import os

    for name in DATAGEN_HOLE_STAGES:
        files = [f"{out}/{name}.jsonl", f"{out}/labels/{name}.json",
                 f"{out}/evol_labels/{name}.json"]
        for path in files:
            with open(path) as f:
                if "<|prompt" in f.read():
                    raise AssertionError(f"{os.path.relpath(path, out)}: a hole was left")
        with open(files[1]) as f:
            labels = json.load(f)
        with open(files[2]) as f:
            evol_labels = json.load(f)
        if not labels or not all({"attribute_pool", "fields"} <= set(e) for e in evol_labels):
            raise AssertionError(f"{name}: labels or evol labels lack their keys")
        for entry in labels:
            label = entry["label"]
            if name == "uts_llm_qa":
                ok = "ts_idx" in entry
            elif name == "mts_local_llm_qa":
                ok = ({"cols", "position", "situation"} <= set(label)
                      and all(set(c) == {"pair", "explain", "label"}
                              for c in label["correlations"]))
            else:
                ok = bool(label["clusters"]) and all(
                    set(c) == {"col_idx", "cols", "explain"}
                    and len(c["col_idx"]) == len(c["cols"]) for c in label["clusters"])
            if not ok:
                raise AssertionError(f"{name}: a label without the JAX schema: {sorted(label)}")


def phase_datagen(smi: str, model, cfg) -> dict:
    """Phase 11: the dataset scripts, the user's path of
    ``scripts/generate_align_datasets.sh`` and ``generate_sft_datasets.sh``,
    with every LLM stage served by the port's OpenAI server on phase 4's
    weights. First a CPU run of both scripts with a scripted LLM that gives
    every prompt a 1,024-word answer (the most a request can return): its
    longest prompt sizes the cache, and its template files are the
    reference for the card run's. Then ``examples/serve_openai.py``'s
    ``build`` at phase 5's engine configuration on 127.0.0.1,
    ``CHATTS_LLM_URL`` set, and both scripts' ``main`` at NUM_DATA
    ``DATAGEN_NUM``. Returns the card run's kernel launches."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from chatts_tpu_torch.examples import serve_openai
    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.serve.server import apply_qwen_chat_template
    from chatts_tpu_torch.utils.llm_client import LLMClient

    root = tempfile.mkdtemp(prefix="chatts_phase11_")
    saved_url = os.environ.get("CHATTS_LLM_URL")
    stats = dict(card=smi, num_data=DATAGEN_NUM)
    try:
        with Phase("11a", f"datagen scripts on the CPU, NUM_DATA {DATAGEN_NUM}, a scripted "
                          f"LLM answering {DATAGEN_MAX_TOKENS} words"):
            def longest(prompt):
                return " ".join(f"t{10 + (len(prompt) + i) % 390}"
                                for i in range(DATAGEN_MAX_TOKENS))

            _, cpu_calls = run_datagen_scripts(
                f"{root}/cpu", LLMClient(engine="openai", openai_client=longest))
            proc = ChatTSProcessor(WordTokenizer(), cfg)
            lens = [int(proc([apply_qwen_chat_template([{"role": "user", "content": p}])[0]],
                             []).seq_lens[0]) for c in cpu_calls.values() for p, _ in c]
            cap = max(1024, -(-(max(lens) + DATAGEN_MAX_TOKENS) // 512) * 512)
            stats.update(cpu_prompts={k: len(v) for k, v in cpu_calls.items() if v},
                         longest_prompt_tokens=max(lens), cap=cap)
            log(f"  {len(lens)} prompts of up to {max(lens)} tokens by stage "
                f"{json.dumps(stats['cpu_prompts'])}; cache capacity {cap}")

        with Phase(11, f"datagen scripts through serve_openai.build: NUM_DATA {DATAGEN_NUM}, "
                       f"{cfg.llm.num_hidden_layers} layers, 24 slots, cap {cap}, int8 KV, "
                       f"decode chunk 32, early emit"):
            args = serve_openai.parse_args([
                "--kv-int8", "--max-batch-size", "24", "--max-model-len", str(cap),
                "--decode-chunk", "32", "--admission-bucket", "8", "--early-first-token",
                "--no-warmup", "--host", "127.0.0.1", "--port", "0"])
            engine, server = serve_openai.build(args, loaded=(cfg, model, WordTokenizer()))
            reqs, submit = [], engine.submit

            def recorded_submit(req):
                reqs.append(req)
                return submit(req)

            engine.submit = recorded_submit
            server.start_background()
            try:
                if server._httpd is None:
                    raise RuntimeError("the server did not come up")
                os.environ["CHATTS_LLM_URL"] = (
                    f"http://127.0.0.1:{server._httpd.server_address[1]}/v1")
                reset_launches()
                start = time.perf_counter()
                report, calls = run_datagen_scripts(f"{root}/card")
                wall = time.perf_counter() - start
                launches = read_launches("datagen", ("flash_attention",
                                                     "ragged_decode_attention_int8",
                                                     "int4_matmul"))
            finally:
                server.shutdown()

            def files(d):
                return sorted(os.path.relpath(os.path.join(dp, f), d)
                              for dp, _, fs in os.walk(d) for f in fs)

            if files(f"{root}/card") != files(f"{root}/cpu") or set(report) != set(calls):
                raise AssertionError(f"the stages wrote {files(f'{root}/card')}, the CPU run "
                                     f"{files(f'{root}/cpu')}")
            for name in DATAGEN_TEMPLATE_FILES:
                with open(f"{root}/card/{name}", "rb") as a, open(f"{root}/cpu/{name}", "rb") as b:
                    if a.read() != b.read():
                        raise AssertionError(f"{name} differs from the CPU run's")
            check_datagen_labels(f"{root}/card")
            sent = sum(len(c) for c in calls.values())
            if len(reqs) != sent or any(a is None for c in calls.values() for _, a in c):
                raise AssertionError(f"the server saw {len(reqs)} requests for {sent} prompts")
            check_answers(reqs, DATAGEN_MAX_TOKENS, "11")
            if any(report[s]["rows"] < 1 for s in DATAGEN_HOLE_STAGES):
                raise AssertionError("a hole-filling stage wrote no rows")

            out_tokens = sum(len(r.output_tokens) for r in reqs)
            ttft = np.asarray([r.ttft_s for r in reqs]) * 1e3
            rounds = {k: v for k, v in engine.stats().items() if k.startswith("round")}
            stages = {name: dict(prompts=len(calls[name]), rows=report[name]["rows"],
                                 parse_failures=datagen_parse_failures(name, calls[name]),
                                 seconds=report[name]["seconds"]) for name in report}
            stats.update(stages=stages, seconds=wall, requests=len(reqs),
                         output_tokens=out_tokens, output_tok_s=out_tokens / wall,
                         ended_at_eos=sum(r.finish_reason == "stop" for r in reqs),
                         ttft_p50_ms=float(np.percentile(ttft, 50)),
                         ttft_p90_ms=float(np.percentile(ttft, 90)), rounds=rounds,
                         prompt_tokens=[min(r.prompt_tokens for r in reqs),
                                        max(r.prompt_tokens for r in reqs)])
            for name, st in stages.items():
                log(f"  {name}: {st['prompts']} prompts, {st['rows']} rows, "
                    f"{st['parse_failures']} parse failures, {st['seconds']:.2f} s")
            log(f"  {len(reqs)} requests (one a prompt) in {wall:.2f} s: "
                f"{stats['output_tok_s']:.1f} output tokens/s ({out_tokens} tokens, "
                f"{stats['ended_at_eos']} ended at EOS); TTFT p50 {stats['ttft_p50_ms']:.1f} "
                f"ms, p90 {stats['ttft_p90_ms']:.1f} ms; card {smi}")
            log(f"  rounds {json.dumps(rounds)}")
            log("  datagen stats: " + json.dumps(stats))
            del engine, server
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if saved_url is None:
            os.environ.pop("CHATTS_LLM_URL", None)
        else:
            os.environ["CHATTS_LLM_URL"] = saved_url
        shutil.rmtree(root, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 9: LoRA SFT and full-parameter training on the card
# ---------------------------------------------------------------------------

# 9a holds the card's bf16 LoRA loss and adapter gradients to the CPU's f32
# plain path on the same weights: the loss within 1% relative, each gradient
# tensor within 5% relative L2 error.  bf16 rounds the activations, the
# merged kernels and the cotangents entering the backward products to 8 bits
# of mantissa (2**-9 relative each); through two layers at 14B widths and the
# 152,064-word head the loss keeps about 3 digits and a gradient tensor's L2
# error stays a few bf16 roundings of its elements.  The measured numbers
# are printed beside these bounds.
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_RL2 = 5e-2
# 9b runs the same seed twice; both runs launch the same kernels in the same
# order on the same inputs (cuBLAS picks the same algorithms, no atomics on
# the LoRA path), so the losses are expected equal.  Allow 1e-6 relative.
TRAIN_REPEAT_RTOL = 1e-6
TRAIN_STEPS = 4


def sft_rows(count: int, series_len: int, n_series: int, n_words: int, n_answer: int,
             seed: int) -> list:
    """SFT rows {input, output, timeseries}: a prompt of filler words with
    ``n_series`` holes, random-walk series, an answer of ``n_answer`` words
    (one token each with ``WordTokenizer``, EOS added)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(count):
        holes = " ".join(f"series {j}: <ts><ts/>" for j in range(n_series))
        words = " ".join(f"w{int(i)}" for i in rng.integers(0, 10 ** 6, n_words))
        answer = " ".join(f"a{int(i)}" for i in rng.integers(0, 10 ** 6, n_answer))
        rows.append({"input": f"Please analyze {holes} and then answer. {words}",
                     "output": answer,
                     "timeseries": [rng.normal(0.0, 10.0, series_len).cumsum().tolist()
                                    for _ in range(n_series)]})
    return rows


def _nonzero_b(torch, adapters, seed: int) -> None:
    """Every adapter b drawn normal * 0.02 (on the CPU, so the same values
    land on both sides), so that every adapter gets a gradient."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in adapters["layers"]:
            for ab in layer.values():
                ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen) * 0.02)


def qwen3_norms(torch, model, seed: int) -> None:
    """Every layer's q_norm and k_norm drawn uniform in [0.5, 1.5] on the CPU
    from ``seed``, in place: the ones that init leaves would not show a norm
    weight skipped or applied to the wrong tensor."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in model.llm.layers:
            for norm in (layer.self_attn.q_norm, layer.self_attn.k_norm):
                norm.copy_(torch.rand(norm.shape, generator=gen) + 0.5)


def lora_against_cpu(torch, cfg, batch_np, what: str, norms_seed=None):
    """A bf16 model from ``init_params`` (SEED) on the card, its q/k norms
    drawn from ``norms_seed`` where given (``qwen3_norms``), and rank-8 LoRA
    adapters with every b nonzero: the loss and every adapter gradient
    (remat) held to the CPU's f32 plain path on the same weights
    (``TRAIN_LOSS_RTOL``, ``TRAIN_GRAD_RL2``).  Returns (model, adapters,
    LoRA config, the card's loss and gradients, the errors)."""
    from chatts_tpu_torch.models import chatts
    from chatts_tpu_torch.train import data, lora, sft_driver

    dev = torch.device("cuda", 0)
    model = chatts.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                               torch.bfloat16)
    if norms_seed is not None:
        qwen3_norms(torch, model, norms_seed)
    log(f"  {what}: {_model_gb(model):.2f} GB of bf16 weights; batch "
        f"{batch_np['input_ids'].shape}, {batch_np['attention_mask'].sum(1).tolist()} tokens, "
        f"{batch_np['loss_mask'].sum(1).tolist()} answer tokens")
    lcfg = lora.LoRAConfig()
    adapters = lora.init_lora(model, lcfg, torch.Generator().manual_seed(SEED))
    _nonzero_b(torch, adapters, SEED + 1)
    loss, _ = sft_driver.lora_loss_fn(adapters, model, lcfg, data.to_device(batch_np, dev),
                                      remat=True)
    torch.cuda.synchronize()
    card = dict(loss=float(loss),
                grads=[t.grad.float().cpu() for t in lora.lora_parameters(adapters)])

    # The CPU's f32 plain path on the same weights: the same draws on the
    # card's generator, cast to bf16 and placed on the CPU, then f32.
    start = time.perf_counter()
    cpu = chatts.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), "cpu",
                             torch.bfloat16)
    if norms_seed is not None:
        qwen3_norms(torch, cpu, norms_seed)
    cpu.float()
    cpu_adapters = {"layers": [{m: {k: t.detach().cpu().requires_grad_() for k, t in ab.items()}
                                for m, ab in layer.items()} for layer in adapters["layers"]]}
    ref, _ = sft_driver.lora_loss_fn(cpu_adapters, cpu, lcfg, data.to_device(batch_np, "cpu"),
                                     remat=False)
    cpu_s = time.perf_counter() - start
    del cpu
    loss_err = abs(float(loss) - float(ref)) / abs(float(ref))
    errs = {}
    for i, (layer, cpu_layer) in enumerate(zip(adapters["layers"], cpu_adapters["layers"])):
        for module, ab in layer.items():
            for k in ("a", "b"):
                got, want = ab[k].grad.float().cpu(), cpu_layer[module][k].grad
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{what}: non-finite gradient {i}.{module}.{k}")
                errs[f"{i}.{module}.{k}"] = float((got - want).norm() / want.norm())
    worst = max(errs, key=errs.get)
    log(f"  {what} LoRA (rank {lcfg.rank}, {lora.lora_param_count(adapters):,} adapter "
        f"parameters, remat) on the card against the CPU's f32 plain path ({cpu_s:.1f} s): loss "
        f"{float(loss):.6f} against {float(ref):.6f}, relative error {loss_err:.3g} (tolerance "
        f"{TRAIN_LOSS_RTOL}); adapter gradients' relative L2 error median "
        f"{sorted(errs.values())[len(errs) // 2]:.3g}, largest {errs[worst]:.3g} ({worst}; "
        f"tolerance {TRAIN_GRAD_RL2})")
    if loss_err > TRAIN_LOSS_RTOL:
        raise AssertionError(f"{what}: the loss differs by {loss_err:.3g} relative")
    if errs[worst] > TRAIN_GRAD_RL2:
        raise AssertionError(f"{what}: {worst}'s gradient differs by {errs[worst]:.3g} (rel L2)")
    return model, adapters, lcfg, card, dict(
        loss=float(loss), loss_rel_err=loss_err, grad_rel_l2_max=errs[worst],
        grad_rel_l2_median=sorted(errs.values())[len(errs) // 2])


def phase_train_2_layers(smi: str) -> dict:
    """9a: the 14B widths at 2 layers, bf16 weights from ``init_params``."""
    import tempfile

    import torch

    from chatts_tpu_torch.models import weights
    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.train import data, lora, sft_driver, train_step

    dev = torch.device("cuda", 0)
    cfg = chatts_14b_config(num_layers=2)
    batch_np = data.build_sft_batch(ChatTSProcessor(WordTokenizer(), cfg),
                                    sft_rows(2, 64, 1, 150, 60, SEED + 9))
    model, adapters, lcfg, card, out = lora_against_cpu(torch, cfg, batch_np, "9a")

    # The merged export, loaded back by the port's loader: bit-equal kernels.
    with tempfile.TemporaryDirectory(prefix="chatts_phase9_") as tmp:
        start = time.perf_counter()
        sft_driver.export_merged(model, adapters, cfg, lcfg, tmp)
        _, loaded = weights.load_checkpoint(tmp, dtype=torch.bfloat16, device=dev)
        merged = lora.merge_lora(model, adapters, lcfg)
        got = dict(loaded.named_parameters())
        differ = [n for n, p in merged.named_parameters() if not torch.equal(got[n], p)]
        changed = sum(not torch.equal(p, q) for p, q in zip(
            merged.parameters(), model.parameters()))
        log(f"  9a export_merged -> load_checkpoint ({time.perf_counter() - start:.1f} s): "
            f"{len(got)} tensors, {len(differ)} differ from merge_lora's; merge_lora changed "
            f"{changed} kernels and left the base as it was")
        if differ:
            raise AssertionError(f"9a: the loaded merge differs at {differ[:4]}")
        if changed != 2 * len(lcfg.target_modules):
            raise AssertionError(f"9a: merge_lora changed {changed} tensors")
        del loaded, merged

    # One full-parameter step: lr 1e-2 so that Adam's step of about lr moves
    # even a bf16 norm weight of 1.0 (half its ulp is 2**-9).
    before = [p.detach().clone() for p in model.parameters()]
    step, _ = train_step.make_train_step(model, train_step.TrainConfig(learning_rate=1e-2))
    metrics = step(data.to_device(batch_np, dev))
    torch.cuda.synchronize()
    moved = [not torch.equal(p, q) for p, q in zip(model.parameters(), before)]
    log(f"  9a full-parameter train_step (remat, AdamW): loss {float(metrics['loss']):.6f}, "
        f"gradient norm {float(metrics['grad_norm']):.4g}, {sum(moved)}/{len(moved)} tensors "
        f"changed; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not torch.isfinite(metrics["loss"]) or not all(moved):
        raise AssertionError("9a: the full-parameter step left a tensor unchanged or its "
                             "loss is not finite")
    out.update(full_step_loss=float(metrics["loss"]), tensors_changed=sum(moved))
    del model, before, step, adapters
    return out, card


class TrainSpy:
    """Wraps ``sft_driver.apply_update`` while active: after each step's
    backward, records which adapter tensors have a nonzero gradient and the
    host time when the step's update is done (synchronised)."""

    def __init__(self):
        from chatts_tpu_torch.train import sft_driver

        self.module, self.steps = sft_driver, []

    def __enter__(self):
        import torch

        inner = self.orig = self.module.apply_update

        def spy(optimizer, tc):
            params = [p for g in optimizer.param_groups for p in g["params"]]
            nonzero = [bool(p.grad.any()) for p in params]
            g_norm = inner(optimizer, tc)
            torch.cuda.synchronize()
            self.steps.append(dict(t=time.perf_counter(), nonzero=nonzero))
            return g_norm

        self.module.apply_update = spy
        return self

    def __exit__(self, *exc):
        self.module.apply_update = self.orig
        return False


class TrainLabels:
    """Marks, while active, the training step's parts for ``torch.profiler``
    with ``record_function``: each ``Dense`` call ("projection"), the LoRA
    fold inside it ("lora_merge"), the plain attention ("attention"), the
    head and the cross-entropy ("loss") and the optimizer ("optimizer").
    The model marks each layer's recompute ("recompute") itself."""

    def __init__(self):
        from chatts_tpu_torch.models import chatts, qwen
        from chatts_tpu_torch.ops import attention
        from chatts_tpu_torch.train import sft_driver, train_step

        self.targets = [(qwen.Dense, "forward", "projection"),
                        (qwen, "lora_kernel", "lora_merge"),
                        (attention, "mha_reference", "attention"),
                        (chatts.ChatTSModel, "compute_logits", "loss"),
                        (train_step, "cross_entropy", "loss"),
                        (sft_driver, "apply_update", "optimizer")]

    def __enter__(self):
        import functools

        import torch

        self.saved = []
        for owner, name, label in self.targets:
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))

            def marked(*args, _fn=fn, _label=label, **kwargs):
                with torch.profiler.record_function(_label):
                    return _fn(*args, **kwargs)

            setattr(owner, name, functools.wraps(fn)(marked))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)
        return False


TRAIN_LABELS = ("lora_merge", "attention", "projection", "loss", "optimizer")


def train_step_shares(prof) -> dict:
    """Device time of one profiled training step by part.  A kernel belongs
    to the ops that launched it; an op under "recompute" to the recompute;
    an op of the backward (under ``autograd::engine::evaluate_function``) to
    the label of the forward op that made its autograd node (matched by
    sequence number); any other op to its innermost label."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def chain(e):
        names = []
        while e is not None:
            names.append(e)
            e = e.cpu_parent
        return names

    def innermost(names):
        return next((e.name for e in names if e.name in TRAIN_LABELS), None)

    forward_label = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::engine"):
            names = chain(e)
            if not any(n.name == "recompute" for n in names):
                forward_label.setdefault(e.sequence_nr, innermost(names))
    shares, busy = {}, 0.0
    for e in events:
        us = sum(k.duration for k in e.kernels)
        if not us:
            continue
        busy += us
        names = chain(e)
        if any(n.name == "recompute" for n in names):
            part = "recompute"
        else:
            node = next((n for n in names if n.name.startswith("autograd::engine")), None)
            if node is not None:
                part = f"backward of {forward_label.get(node.sequence_nr) or 'other'}"
            else:
                part = innermost(names) or "other forward"
        shares[part] = shares.get(part, 0.0) + us
    if busy <= 0:
        raise AssertionError("the training step's profile saw no device time")
    return {"busy_ms": busy / 1e3, **{k: v / 1e3 for k, v in sorted(
        shares.items(), key=lambda kv: -kv[1])}}


def lora_step_bound(cfg, rows: int, seq: int, targets) -> dict:
    """The least time of one LoRA step with per-layer recompute on one H100,
    from the shapes (``rows`` x ``seq`` tokens, all computed): every
    projection and the head forward, every layer's projections again (the
    recompute), every input gradient, and the weight gradients of the
    adapted projections, as bf16 tensor-core operations; the plain
    attention's two products (QK and PV, 2 rows seq seq head_dim heads each
    a layer) forward, in the recompute and twice in the backward, as f32
    operations outside the tensor cores, as the port runs them (its einsums
    take f32 operands).  The weights' bytes (read four times) take less."""
    lcfg = cfg.llm
    hid, inter, d = lcfg.hidden_size, lcfg.intermediate_size, lcfg.head_dim
    h, kvh, layers = lcfg.num_attention_heads, lcfg.num_key_value_heads, lcfg.num_hidden_layers
    sizes = {"q_proj": hid * h * d, "k_proj": hid * kvh * d, "v_proj": hid * kvh * d,
             "o_proj": h * d * hid, "gate_proj": hid * inter, "up_proj": hid * inter,
             "down_proj": inter * hid}
    tokens = rows * seq
    layer, head = sum(sizes.values()), hid * lcfg.vocab_size
    forward = 2.0 * tokens * (layers * layer + head)
    bf16 = 2 * forward + 2.0 * tokens * layers * (layer + sum(sizes[m] for m in targets))
    f32 = 4 * layers * 2 * (2.0 * rows * h * seq * seq * d)
    return dict(bf16_tflop=bf16 / 1e12, bf16_ms=bf16 / PEAK_BF16_S * 1e3,
                f32_tflop=f32 / 1e12, f32_ms=f32 / PEAK_F32_S * 1e3,
                bound_ms=(bf16 / PEAK_BF16_S + f32 / PEAK_F32_S) * 1e3)


def phase_train_full_depth(smi: str) -> dict:
    """9b: ChatTS-14B at full width and depth, LoRA SFT through
    ``train_lora_sft``, twice from one seed; then one step profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chatts_tpu_torch.models import chatts
    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.train import data, lora, sft_driver, train_step

    dev = torch.device("cuda", 0)
    cfg = chatts_14b_config(num_layers=48)
    start = time.perf_counter()
    model = chatts.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                               torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  9b: ChatTS-14B shape, 48 layers, {_model_gb(model):.2f} GB of bf16 weights made "
        f"in {time.perf_counter() - start:.1f} s")
    proc = ChatTSProcessor(WordTokenizer(), cfg)
    rows = sft_rows(2, 256, 2, 820, 127, SEED + 11)
    batch_np = data.build_sft_batch(proc, rows)
    tokens = int(batch_np["attention_mask"].sum())
    padded = batch_np["input_ids"].size
    lcfg = lora.LoRAConfig(rank=8)
    tc = train_step.TrainConfig(learning_rate=1e-4, remat=True)
    runs = []
    for run in range(2):
        with TrainSpy() as spy:
            t0 = time.perf_counter()
            result = sft_driver.train_lora_sft(
                model, cfg, proc, rows, lora_cfg=lcfg, train_cfg=tc, batch_size=2,
                num_epochs=TRAIN_STEPS, max_steps=TRAIN_STEPS, seed=SEED, log_every=10 ** 9,
                device=dev)
        times = [t0] + [s["t"] for s in spy.steps]
        step_s = [b - a for a, b in zip(times, times[1:])]
        runs.append(dict(losses=result.losses, step_s=step_s, spy=spy.steps))
        log(f"  9b run {run + 1}: {TRAIN_STEPS} LoRA steps (rank {lcfg.rank}, "
            f"{lora.lora_param_count(result.lora_params):,} adapter parameters, remat, batch 2 "
            f"x {batch_np['input_ids'].shape[1]}, {tokens} real tokens); losses "
            f"{[round(x, 6) for x in result.losses]}; step seconds "
            f"{[round(x, 3) for x in step_s]}")
    first, second = runs
    if len(first["losses"]) != TRAIN_STEPS or not all(
            math.isfinite(x) for r in runs for x in r["losses"]):
        raise AssertionError(f"9b: losses {first['losses']}, {second['losses']}")
    repeat = max(abs(a - b) / abs(a) for a, b in zip(first["losses"], second["losses"]))
    # Adapter tensors alternate a, b: at step 1 every b has a gradient and
    # every a none (b = 0); at step 2 every a has one.
    s1, s2 = first["spy"][0]["nonzero"], first["spy"][1]["nonzero"]
    log(f"  9b: step 1: {sum(s1[1::2])}/{len(s1) // 2} b and {sum(s1[0::2])} a with a nonzero "
        f"gradient; step 2: {sum(s2[0::2])}/{len(s2) // 2} a; two runs' losses differ by "
        f"{repeat:.3g} relative (tolerance {TRAIN_REPEAT_RTOL})")
    if not all(s1[1::2]) or any(s1[0::2]) or not all(s2[0::2]):
        raise AssertionError("9b: an adapter got no gradient")
    if repeat > TRAIN_REPEAT_RTOL:
        raise AssertionError(f"9b: two runs from one seed differ by {repeat:.3g}")
    warm = [s for r in runs for s in r["step_s"][1:]]
    step_ms = 1e3 * sum(warm) / len(warm)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # One step under the profiler, with its parts marked.
    adapters = result.lora_params
    step, _ = sft_driver.make_lora_train_step(model, adapters, lcfg, tc)
    batch = data.to_device(batch_np, dev)
    step(batch)
    torch.cuda.synchronize()
    with TrainLabels(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    shares = train_step_shares(prof)
    busy = shares.pop("busy_ms")
    log(f"  9b one LoRA step under torch.profiler: {busy:.1f} ms of device time in "
        f"{profiled_s * 1e3:.1f} ms on the host's clock (profiled); by part:")
    for part, ms in shares.items():
        log(f"    {ms:10.2f} ms {ms / busy:6.1%}  {part}")
    bound = lora_step_bound(cfg, *batch_np["input_ids"].shape, lcfg.target_modules)
    log(f"  9b bound: {bound['bf16_tflop']:.1f} TFLOP in bf16 ({bound['bf16_ms']:.1f} ms at the "
        f"dense peak) and {bound['f32_tflop']:.2f} TFLOP of f32 attention "
        f"({bound['f32_ms']:.1f} ms): {bound['bound_ms']:.1f} ms a step, "
        f"{bound['bound_ms'] / step_ms:.1%} of the measured step")
    out = dict(bound=bound, step_ms=step_ms, step_ms_all=[round(1e3 * s, 3) for r in runs for s in r["step_s"]],
               tokens_per_s=tokens / step_ms * 1e3, padded_tokens_per_s=padded / step_ms * 1e3,
               peak_gb=peak_gb, losses=first["losses"], repeat_rel=repeat,
               profiled_busy_ms=busy, shares={k: v / busy for k, v in shares.items()})
    log(f"  9b: {step_ms:.1f} ms a step (steps 2 to {TRAIN_STEPS} of both runs), "
        f"{out['tokens_per_s']:.0f} real tokens/s ({out['padded_tokens_per_s']:.0f} with padding), "
        f"peak memory {peak_gb:.2f} GB; {smi}")
    del adapters, step, batch
    pp_ref = pipeline_reference(torch, model, cfg)
    del model
    return out, pp_ref


def pp_ids(cfg):
    """Phase 12's tokens: (2, 1,024) ids drawn from a seed."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 13)
    return torch.randint(10, cfg.llm.vocab_size - 10, (2, PP_TOKENS), generator=gen)


def pipeline_reference(torch, model, cfg) -> dict:
    """12(a)'s reference: the single-stage forward of phase 12's tokens
    (``attn_impl="xla"``, the pipeline's attention) on 9b's 48-layer model,
    its hidden state after the final norm and the logits of each row's last
    ``PP_TAIL`` positions, on the CPU."""
    dev = model.llm.norm.device
    ids = pp_ids(cfg).to(dev)
    positions = torch.arange(PP_TOKENS, device=dev)[None].repeat(ids.shape[0], 1)
    with torch.no_grad():
        hidden, _ = model.llm(model.llm.embed(ids), positions,
                              kv_valid=torch.ones_like(ids, dtype=torch.bool),
                              kv_positions=positions, attn_impl="xla")
        logits = model.llm.compute_logits(hidden[:, -PP_TAIL:])
    return dict(hidden=hidden[:, -PP_TAIL:].float().cpu(), logits=logits.cpu())


def phase_train(smi: str) -> dict:
    """Phase 9: training on the card, after every serving phase, with their
    models freed.  Returns each kernel's launches on the training path (B1
    to B5 all 0: training reaches the plain attention through
    attn_impl="xla" and takes float projections; the decoder glue's kernels
    run where autograd records none of their inputs, as their gate and
    ``refuse_gradients`` let them: the first layer's norm of frozen
    embeddings and forwards under no_grad)."""
    import torch

    with Phase(9, "training: 9a LoRA and full-parameter steps at 14B widths (2 layers) "
                  "against the CPU's f32 plain path; 9b LoRA SFT of the 48-layer ChatTS-14B "
                  "shape"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        result, refs = {}, {}
        result["9a"], refs["9a"] = phase_train_2_layers(smi)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        result["9b"], refs["pp"] = phase_train_full_depth(smi)
        refs["9b_loss"] = result["9b"]["losses"][0]
        launches = read_launches("training", ())
        if any(launches[name] for name in REPLACES):
            raise AssertionError(f"the training path launched a kernel: {launches}")
        log("  train: " + json.dumps(result))
        gc.collect()
        torch.cuda.empty_cache()
    return launches, refs


# ---------------------------------------------------------------------------
# Phases 9t and 12: training on a tensor-parallel mesh, and GPipe
# ---------------------------------------------------------------------------

# Two ranks on cuda:0 over gloo, as phase 7t runs them (NCCL refuses two
# ranks on one device); every time below is gloo's, through host memory.
MESH_RANKS = 2
MESH_TIMEOUT_S = 900
MESH_TRAIN_LAYERS = 48  # 9b's depth, for 9t(b) and 12(a)
TP_TRAIN_STEPS = 3
# 12(a): the 48-layer bf16 stack, 24 layers a stage, M = 2 microbatches of
# 1 x 1,024 tokens; the logits of each row's last PP_TAIL positions are held
# to the single-stage forward's with 7t's rule (3% of the largest).
PP_TOKENS = 1024
PP_MICRO = 2
PP_TAIL = 8
# 12(b): make_pp_train_step at the 14B widths, f32, full-parameter AdamW (16
# bytes a parameter with its gradient and two moments).  48 layers would be
# 14.8 B parameters, 236 GB; the embedding and the head alone are 1.56 B.
# 4 layers, 2 a stage: 1.10 B in the layers + 1.56 B = 2.66 B, 42.6 GB for
# the two stages together, beside the activations of 2 x 1,024 f32 tokens.
PP_TRAIN_LAYERS = 4
PP_TRAIN_STEPS = 3
PP_TRAIN_LR = 1e-4
# 12(b)'s first loss against the single-stage loss, both f32 on the card
# with the same products (TF32 off), the pipeline's on microbatches of one
# row: the sums run in another order only (tests/test_pipeline.py's 1e-4).
PP_LOSS_RTOL = 1e-4


def _tp_train_2_layers(torch, mesh, dev) -> dict:
    """9t(a) on one rank: 9a's model, adapters and rows on the rank's shard."""
    from chatts_tpu_torch.models import chatts
    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.train import data, lora, sft_driver

    start = time.perf_counter()
    cfg = chatts_14b_config(num_layers=2)
    model = chatts.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                               torch.bfloat16, mesh=mesh)
    batch_np = data.build_sft_batch(ChatTSProcessor(WordTokenizer(), cfg),
                                    sft_rows(2, 64, 1, 150, 60, SEED + 9))
    lcfg = lora.LoRAConfig()
    adapters = lora.init_lora(model, lcfg, torch.Generator().manual_seed(SEED))
    _nonzero_b(torch, adapters, SEED + 1)
    loss, _ = sft_driver.lora_loss_fn(adapters, model, lcfg, data.to_device(batch_np, dev),
                                      remat=True)
    out = dict(loss=float(loss), grads=[t.grad.float().cpu() for t in
                                        lora.lora_parameters(adapters)],
               heads=model.llm.layers[0].self_attn.num_heads,
               vocab_rows=model.llm.embed_tokens.shape[0], seconds=time.perf_counter() - start)
    del model, adapters
    return out


def _tp_train_full_depth(torch, mesh, dev, layers: int) -> dict:
    """9t(b) on one rank: 9b's run on the rank's shard of its ``layers``
    (48), ``TP_TRAIN_STEPS`` steps, the collectives timed."""
    from chatts_tpu_torch.models import chatts
    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.train import lora, sft_driver, train_step

    torch.cuda.reset_peak_memory_stats(dev)
    start = time.perf_counter()
    cfg = chatts_14b_config(num_layers=layers)
    model = chatts.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                               torch.bfloat16, mesh=mesh)
    torch.cuda.synchronize(dev)
    out = dict(init_s=time.perf_counter() - start, model_gb=_model_gb(model),
               init_peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    proc = ChatTSProcessor(WordTokenizer(), cfg)
    rows = sft_rows(2, 256, 2, 820, 127, SEED + 11)
    clock = DistClock()
    try:
        with TrainSpy() as spy:
            t0 = time.perf_counter()
            result = sft_driver.train_lora_sft(
                model, cfg, proc, rows, lora_cfg=lora.LoRAConfig(rank=8),
                train_cfg=train_step.TrainConfig(learning_rate=1e-4, remat=True), batch_size=2,
                num_epochs=TP_TRAIN_STEPS, max_steps=TP_TRAIN_STEPS, seed=SEED,
                log_every=10 ** 9, device=dev)
    finally:
        clock.remove()
    times = [t0] + [s["t"] for s in spy.steps]
    out.update(losses=result.losses, step_s=[b - a for a, b in zip(times, times[1:])],
               nonzero=[s["nonzero"] for s in spy.steps[:2]],
               collective_s=clock.seconds / TP_TRAIN_STEPS,
               collectives_a_step=clock.calls / TP_TRAIN_STEPS,
               collective_mb_a_step=clock.bytes / TP_TRAIN_STEPS / 1e6,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del model, result
    return out


def _pp_forward(torch, pp, dev, layers: int) -> dict:
    """12(a) on one stage: its half of 9b's ``layers`` (48; drawn as 9b drew
    them, the encoder's draws first), the pipeline forward of phase 12's
    tokens."""
    from chatts_tpu_torch.models.ts_encoder import TSEncoder
    from chatts_tpu_torch.parallel import pipeline

    cfg = chatts_14b_config(num_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    TSEncoder(cfg.ts, device=dev).reset_parameters(gen)  # chatts.init_params draws it first
    start = time.perf_counter()
    stage = pipeline.init_stage(cfg.llm, gen, pp, dev, torch.bfloat16)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - start
    ids = pp_ids(cfg).to(dev)
    b, t = ids.shape
    mb = b // PP_MICRO
    positions = torch.arange(t, device=dev)[None].repeat(b, 1)
    embeds = stage.embed(ids).reshape(PP_MICRO, mb, t, -1) if pp.is_first else None
    clock = DistClock()
    try:
        torch.cuda.synchronize(dev)
        start = time.perf_counter()
        hidden = pipeline.pipeline_forward(
            stage, cfg.llm, embeds, positions.reshape(PP_MICRO, mb, t),
            torch.ones((PP_MICRO, mb, t), dtype=torch.bool, device=dev), mesh=pp)
        torch.cuda.synchronize(dev)
        forward_s = time.perf_counter() - start
    finally:
        clock.remove()
    hidden = hidden.reshape(b, t, -1)[:, -PP_TAIL:]
    out = dict(init_s=init_s, forward_s=forward_s, p2p_s=clock.seconds, p2p_mb=clock.bytes / 1e6,
               layers=(stage.layer_start, len(stage.layers)), stage_gb=_model_gb(stage),
               hidden=hidden.float().cpu(),
               logits=stage.compute_logits(hidden).cpu() if pp.is_last else None)
    del stage, hidden, embeds
    return out


def pp_train_batch(torch, dev) -> dict:
    """12(b)'s batch: phase 12's tokens, every position a target."""
    ids = pp_ids(chatts_14b_config(num_layers=1)).to(dev)
    positions = torch.arange(PP_TOKENS, device=dev)[None].repeat(ids.shape[0], 1)
    return {"input_ids": ids, "positions": positions, "attention_mask": torch.ones_like(ids),
            "targets": torch.roll(ids, -1, dims=1),
            "loss_mask": torch.ones(ids.shape, dtype=torch.float32, device=dev)}


def _pp_train(torch, pp, dev) -> dict:
    """12(b) on one stage: ``make_pp_train_step`` at the 14B widths, f32,
    ``PP_TRAIN_LAYERS`` layers, ``PP_TRAIN_STEPS`` steps on one batch."""
    from chatts_tpu_torch.parallel import pipeline

    cfg = chatts_14b_config(num_layers=PP_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    stage = pipeline.init_stage(cfg.llm, torch.Generator(device=dev).manual_seed(SEED + 14),
                                pp, dev, torch.float32)
    step, optimizer = pipeline.make_pp_train_step(
        cfg.llm, pp, pipeline.PipelineTrainConfig(learning_rate=PP_TRAIN_LR,
                                                  microbatches=PP_MICRO))
    state = optimizer.init(stage)
    batch = pp_train_batch(torch, dev)
    losses, step_s, sent = [], [], []
    clock = DistClock()
    try:
        for _ in range(PP_TRAIN_STEPS):
            torch.cuda.synchronize(dev)
            start = time.perf_counter()
            stage, state, metrics = step(stage, state, batch)
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - start)
            sent.append(metrics["sent_bytes"])
    finally:
        clock.remove()
    out = dict(losses=losses, step_s=step_s, sent_mb=[x / 1e6 for x in sent],
               p2p_s=clock.seconds / PP_TRAIN_STEPS, p2p_calls=clock.calls / PP_TRAIN_STEPS,
               params=sum(p.numel() for p in pipeline.pipeline_parameters(stage)),
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del stage, state, step
    return out


def _mesh_train_rank(rank: int, layers: int):
    """One rank of phases 9t and 12: tp = 2 LoRA SFT (9t), then the GPipe
    forward and train step at pp = 2 (12), the models freed in between;
    ``layers`` is 9b's depth."""
    import torch

    from chatts_tpu_torch.parallel import pipeline
    from chatts_tpu_torch.parallel.mesh import create_mesh

    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp = create_mesh(tp=MESH_RANKS)
    pp = pipeline.create_pp_mesh(MESH_RANKS)
    reset_launches()
    out = {"rank": rank}
    for key, part in (("9t_a", lambda: _tp_train_2_layers(torch, tp, dev)),
                      ("9t_b", lambda: _tp_train_full_depth(torch, tp, dev, layers)),
                      ("12a", lambda: _pp_forward(torch, pp, dev, layers)),
                      ("12b", lambda: _pp_train(torch, pp, dev))):
        start = time.perf_counter()
        out[key] = part()
        out[key]["part_s"] = time.perf_counter() - start
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = {name: fn.launches for name, fn in kernel_wrappers().items()}
    return out


def pp_train_reference(torch, dev) -> float:
    """12(b)'s single-stage loss: the same f32 4-layer model whole on the
    card, the same batch, one forward."""
    from chatts_tpu_torch.models import qwen
    from chatts_tpu_torch.train.loss import cross_entropy

    cfg = chatts_14b_config(num_layers=PP_TRAIN_LAYERS)
    model = qwen.init_params(cfg.llm, torch.Generator(device=dev).manual_seed(SEED + 14), dev,
                             torch.float32)
    batch = pp_train_batch(torch, dev)
    with torch.no_grad():
        hidden, _ = model(model.embed(batch["input_ids"]), batch["positions"],
                          kv_valid=batch["attention_mask"].bool(),
                          kv_positions=batch["positions"], attn_impl="xla")
        loss, _ = cross_entropy(model.compute_logits(hidden), batch["targets"],
                                batch["loss_mask"])
    loss = float(loss)
    del model, hidden
    return loss


def phase_mesh_training(smi: str, refs: dict) -> dict:
    """Phases 9t and 12 in one world of ``MESH_RANKS`` ranks on cuda:0 over
    gloo (after phase 9, every model freed): 9t holds tp = 2 LoRA SFT to
    9a's and 9b's single-device runs, 12 the GPipe forward to 9b's model's
    single-stage forward and its train step to the single-stage loss.
    Returns the launches of both paths (none: training runs no kernel)."""
    import torch

    from chatts_tpu_torch.parallel.distributed import run_world

    layers = MESH_TRAIN_LAYERS
    dev = torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()
    pp_loss = pp_train_reference(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  {MESH_RANKS} ranks on one card ({torch.cuda.get_device_name(0)}) over gloo, which "
        f"carries each collective and each send through host memory: these times are not "
        f"NCCL times; card: {smi}")
    with Phase("9t", "training at tp = 2: (a) 9a's LoRA loss and gradients, (b) 9b's LoRA SFT "
                     "of the 48-layer ChatTS-14B shape, each rank its shard"):
        start = time.perf_counter()
        ranks = run_world(_mesh_train_rank, MESH_RANKS, (layers,), backend="gloo",
                          timeout_s=MESH_TIMEOUT_S)
        log(f"  the world of {MESH_RANKS} ranks ran in {time.perf_counter() - start:.1f} s "
            f"(9t and 12)")
        a = [r["9t_a"] for r in ranks]
        want_loss, want_grads = refs["9a"]["loss"], refs["9a"]["grads"]
        loss_err = max(abs(x["loss"] - want_loss) / abs(want_loss) for x in a)
        errs = [float((g - w).norm() / w.norm()) for x in a for g, w in zip(x["grads"], want_grads)]
        shapes = all(g.shape == w.shape for x in a for g, w in zip(x["grads"], want_grads))
        log(f"  9t(a) 2 layers, tp {MESH_RANKS} ({a[0]['heads']} heads, {a[0]['vocab_rows']} "
            f"vocabulary rows a rank): loss {a[0]['loss']:.6f} against 9a's {want_loss:.6f} on one "
            f"card, relative error {loss_err:.3g} (tolerance {TRAIN_LOSS_RTOL}); {len(want_grads)} "
            f"adapter gradients, whole-shaped {shapes}, relative L2 error largest {max(errs):.3g} "
            f"(tolerance {TRAIN_GRAD_RL2}); {a[0]['part_s']:.1f} s")
        if not shapes or loss_err > TRAIN_LOSS_RTOL or max(errs) > TRAIN_GRAD_RL2:
            raise AssertionError("9t(a): the tp LoRA loss or gradients differ from one card's")
        b = [r["9t_b"] for r in ranks]
        if b[0]["losses"] != b[1]["losses"] or len(b[0]["losses"]) != TP_TRAIN_STEPS or not all(
                math.isfinite(x) for x in b[0]["losses"]):
            raise AssertionError(f"9t(b): losses {[x['losses'] for x in b]}")
        first_err = abs(b[0]["losses"][0] - refs["9b_loss"]) / abs(refs["9b_loss"])
        s1, s2 = b[0]["nonzero"]
        steps = [round(x, 3) for x in b[0]["step_s"]]
        share = b[0]["collective_s"] / (sum(b[0]["step_s"]) / TP_TRAIN_STEPS)
        log(f"  9t(b) {layers} layers, tp {MESH_RANKS}: shard {b[0]['model_gb']:.2f} GB a rank, drawn "
            f"and cut in {b[0]['init_s']:.1f} s (init peak {b[0]['init_peak_gb']:.2f} GB); losses "
            f"{[round(x, 6) for x in b[0]['losses']]}, equal on both ranks; step 1 against 9b's "
            f"{refs['9b_loss']:.6f}: relative error {first_err:.3g} (tolerance {TRAIN_LOSS_RTOL}); "
            f"step 1: {sum(s1[1::2])}/{len(s1) // 2} b with a gradient, step 2: "
            f"{sum(s2[0::2])}/{len(s2) // 2} a; step seconds {steps}; collectives "
            f"{b[0]['collective_s']:.2f} s a step ({share:.1%}, {b[0]['collectives_a_step']:.0f} "
            f"calls, {b[0]['collective_mb_a_step']:.0f} MB, each timed between device syncs); "
            f"peak {[round(x['peak_gb'], 2) for x in b]} GB; card {smi}")
        if first_err > TRAIN_LOSS_RTOL:
            raise AssertionError(f"9t(b): step 1's loss differs from 9b's by {first_err:.3g}")
        if not all(s1[1::2]) or any(s1[0::2]) or not all(s2[0::2]):
            raise AssertionError("9t(b): an adapter got no gradient")
        log("  9t stats: " + json.dumps(dict(
            card=smi, ranks=MESH_RANKS, backend="gloo", a_loss=a[0]["loss"], a_loss_rel=loss_err,
            a_grad_rel_l2_max=max(errs), b_losses=b[0]["losses"], b_first_rel=first_err,
            b_step_s=b[0]["step_s"], b_collective_s=b[0]["collective_s"],
            b_collective_share=share, b_collectives_a_step=b[0]["collectives_a_step"],
            b_collective_mb_a_step=b[0]["collective_mb_a_step"], b_init_s=b[0]["init_s"],
            b_model_gb=[x["model_gb"] for x in b], b_peak_gb=[x["peak_gb"] for x in b])))
    with Phase(12, f"GPipe at pp = {MESH_RANKS}: (a) pipeline_forward of the {layers}-layer stack "
                   f"against one stage, (b) make_pp_train_step, f32, {PP_TRAIN_LAYERS} layers"):
        fa = [r["12a"] for r in ranks]
        want = refs["pp"]
        if not torch.equal(fa[0]["hidden"], fa[1]["hidden"]):
            raise AssertionError("12(a): the stages' hidden states differ")
        got = fa[-1]["logits"]
        err = float((got - want["logits"]).abs().max())
        tol = TP_LOGIT_RTOL_OF_MAX * float(want["logits"].abs().max())
        herr = float((fa[0]["hidden"] - want["hidden"]).abs().max())
        log(f"  12(a) stages {[x['layers'] for x in fa]} (first layer, count), "
            f"{[round(x['stage_gb'], 2) for x in fa]} GB, drawn in "
            f"{[round(x['init_s'], 1) for x in fa]} s; the logits of each row's last {PP_TAIL} "
            f"positions against the single-stage forward on 9b's weights: max |diff| {err:.4g} "
            f"(tolerance {tol:.4g} = {TP_LOGIT_RTOL_OF_MAX} x max |logit| "
            f"{float(want['logits'].abs().max()):.4g}); hidden max |diff| {herr:.4g}; forward "
            f"{fa[0]['forward_s']:.3f} s, P2P {fa[0]['p2p_s']:.3f} s and {fa[0]['p2p_mb']:.1f} MB "
            f"on stage 0; the part {fa[0]['part_s']:.1f} s")
        if got is None or got.shape != want["logits"].shape or err > tol:
            raise AssertionError(f"12(a): pipeline logits differ by {err:.4g} > {tol:.4g}")
        fb = [r["12b"] for r in ranks]
        losses = fb[0]["losses"]
        rel = abs(losses[0] - pp_loss) / abs(pp_loss)
        log(f"  12(b) {PP_TRAIN_LAYERS} layers f32, {[x['params'] for x in fb]} parameters a "
            f"stage, AdamW (optax's defaults) lr {PP_TRAIN_LR}: losses "
            f"{[round(x, 6) for x in losses]}; step 1 against the single-stage {pp_loss:.6f}: "
            f"relative {rel:.3g} (tolerance {PP_LOSS_RTOL}); step seconds "
            f"{[round(x, 3) for x in fb[0]['step_s']]}; P2P a step {fb[0]['p2p_s']:.3f} s, "
            f"{fb[0]['sent_mb'][0]:.1f} MB sent by stage 0 and {fb[1]['sent_mb'][0]:.1f} MB by "
            f"stage 1; peak {[round(x['peak_gb'], 2) for x in fb]} GB; the part "
            f"{fb[0]['part_s']:.1f} s; card {smi}")
        if [x["losses"] for x in fb] != [losses] * MESH_RANKS or rel > PP_LOSS_RTOL:
            raise AssertionError(f"12(b): losses {[x['losses'] for x in fb]} against {pp_loss}")
        if not all(b < a for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"12(b): the loss did not fall: {losses}")
        log("  12 stats: " + json.dumps(dict(
            card=smi, ranks=MESH_RANKS, backend="gloo", a_logit_err=err, a_logit_tol=tol,
            a_hidden_err=herr, a_forward_s=fa[0]["forward_s"], a_p2p_s=[x["p2p_s"] for x in fa],
            a_init_s=[x["init_s"] for x in fa], b_losses=losses, b_single_loss=pp_loss,
            b_first_rel=rel, b_step_s=fb[0]["step_s"], b_p2p_s=[x["p2p_s"] for x in fb],
            b_sent_mb=[x["sent_mb"][0] for x in fb], b_params=[x["params"] for x in fb],
            b_peak_gb=[x["peak_gb"] for x in fb])))
    launches = {name: sum(r["launches"][name] for r in ranks) for name in REPLACES}
    if any(launches.values()):
        raise AssertionError(f"the mesh training paths launched a kernel: {launches}")
    log(f"  kernel launches on the tp training and pipeline paths, both ranks: {launches}")
    return {"tp_training_and_pipeline": launches}


# ---------------------------------------------------------------------------
# Per-layer checks; phases 13 and 13q (the reference's headline serving
# configuration, the Qwen3 decoder) and 8f (the bf16 cache at cap 6,144)
# ---------------------------------------------------------------------------

# One decoder layer on the card against the same layer on the CPU in f32, on
# the card's own input to it.  Its attention block (q/k/v, the norms, RoPE,
# the attention, o) and its MLP each run on the card from a bf16 input with
# bf16 intermediates (each rounding 2**-9 of the value, about ten on the way
# to an output element) and f32 sums; on the CPU their inputs differ from
# the card's by those roundings before them.  Each is held to
# BLOCK_RTOL_OF_MAX of its largest output.  The layer adds both to the
# residual stream, which the card rounds to bf16 after each addition at the
# stream's own magnitude: the layer's output is held to BLOCK_RTOL_OF_MAX of
# the largest it adds plus RESIDUAL_RTOL of the element (two roundings, half
# an ulp each: 2**-8 of the value at most, each).  A norm weight, bias or
# head group applied wrongly, or a key tile dropped, moves a block's output
# by a large share of its largest.
BLOCK_RTOL_OF_MAX = 3e-2
RESIDUAL_RTOL = 2.0 ** -7


def per_layer_against_cpu(torch, card, batch, what: str) -> dict:
    """Every decoder layer of ``card`` (a model on the card) held to the same
    layer on the CPU in f32 on the card's own input to it: forward hooks
    keep each layer's input and output, and its attention block's and
    MLP's outputs, in one uncached prefill of ``batch`` on the card; then a
    plain f32 copy of each layer (``cpu_plain_model``) runs on the CPU, one
    at a time, with the same hooks.  Phase 3's 2-layer check holds logits,
    which compound every layer's rounding through the residual stream and
    the head; this one sees each block alone.  Rule: ``BLOCK_RTOL_OF_MAX``."""
    import copy

    from chatts_tpu_torch.models import qwen

    def hook_outputs(layer, into: dict, whole: bool = True) -> list:
        def keep(key):
            def post(module, args, out):
                into[key] = (out[0] if isinstance(out, tuple) else out).float().cpu()
            return post

        return [layer.self_attn.register_forward_hook(keep("attention")),
                layer.mlp.register_forward_hook(keep("mlp"))] + (
                    [layer.register_forward_hook(keep("layer"))] if whole else [])

    dev = card.llm.embed_tokens.device
    seen, shared, hooks = [{} for _ in card.llm.layers], {}, []

    def keep_stream(i, layer):
        """The model runs a layer as ``forward_residual`` (x, the previous
        layer's MLP output), the adds left to the norms after them: the
        layer's input is x + branch and its output the stream plus its MLP
        output, each the bf16 add the eager layer makes."""
        inner = layer.forward_residual

        def forward_residual(x, branch, *args, **kw):
            if not shared:
                shared.update(positions=args[0].cpu(), kv_valid=args[4].cpu(),
                              kv_positions=args[5].cpu())
            seen[i]["input"] = (x if branch is None else x + branch).float().cpu()
            out, mlp_out = inner(x, branch, *args, **kw)
            seen[i]["layer"] = (out + mlp_out).float().cpu()
            return out, mlp_out

        layer.forward_residual = forward_residual
        return lambda: delattr(layer, "forward_residual")

    undo = [keep_stream(i, layer) for i, layer in enumerate(card.llm.layers)]
    for i, layer in enumerate(card.llm.layers):
        hooks += hook_outputs(layer, seen[i], whole=False)
    try:
        tail_logits(card, batch, dev, 1)
    finally:
        for hook in hooks:
            hook.remove()
        for restore in undo:
            restore()
    lcfg = card.llm.cfg
    positions = shared["positions"]
    rope = qwen.rope_cos_sin(positions, lcfg.head_dim, lcfg.rope_theta)
    start, shares, stream = time.perf_counter(), {"attention": [], "mlp": [], "layer": []}, []
    for i, layer in enumerate(card.llm.layers):
        cpu_layer, want = cpu_plain_model(copy.deepcopy(layer)), {}
        hooks = hook_outputs(cpu_layer, want)
        with torch.inference_mode():
            cpu_layer(seen[i]["input"], positions, rope, None, None, shared["kv_valid"],
                      shared["kv_positions"], None)
        for hook in hooks:
            hook.remove()
        del cpu_layer
        for key, ref in want.items():
            got = seen[i][key]
            if not torch.isfinite(got).all():
                raise AssertionError(f"{what}: layer {i}'s {key} gave non-finite values on the "
                                     "card")
            err = (got - ref).abs()
            if key == "layer":
                largest = float((ref - seen[i]["input"]).abs().max())
                tol = BLOCK_RTOL_OF_MAX * largest + RESIDUAL_RTOL * ref.abs()
                stream.append(float(ref.abs().max()) / largest)
            else:
                largest = float(ref.abs().max())
                tol = BLOCK_RTOL_OF_MAX * largest
            shares[key].append(float(err.max()) / largest)
            if bool((err > tol).any()):
                raise AssertionError(
                    f"{what}: layer {i}'s {key}: {int((err > tol).sum())} elements out of "
                    f"tolerance; max |diff| {float(err.max()):.4g} = {shares[key][-1]:.3g} of "
                    f"its largest output{' addition' if key == 'layer' else ''} {largest:.4g}")
    summary = {}
    for key, vals in shares.items():
        worst = max(range(len(vals)), key=vals.__getitem__)
        summary[key] = dict(median=sorted(vals)[len(vals) // 2], max=vals[worst], layer=worst)
    log(f"  {what}, per layer: {len(stream)} layers on the card against the CPU's f32 layer on "
        f"the card's input ({batch.seq_lens.tolist()} tokens, {time.perf_counter() - start:.1f} "
        f"s): max |diff| over the largest output, median and largest (layer): "
        + "; ".join(f"{key} {v['median']:.3g}, {v['max']:.3g} ({v['layer']})"
                    for key, v in summary.items())
        + f" (the layer's over the largest it adds; its output up to {max(stream):.3g} times "
        f"that); tolerance {BLOCK_RTOL_OF_MAX} of the largest, + {RESIDUAL_RTOL:.4g} of the "
        f"element for the layer")
    return dict(layers=len(stream), stream_over_added_max=max(stream), **summary)


def two_layers_against_cpu(torch, model, cfg, batch, what: str, n: int = 32) -> dict:
    """Phase 3's check on ``model``'s first two layers (a view sharing its
    tensors): their logits on the card against a plain f32 copy of them on
    the CPU, at each row's last n positions."""
    import copy

    dev = model.llm.embed_tokens.device
    _, view = first_layers(model, cfg, 2)
    got = tail_logits(view, batch, dev, n).cpu()
    cpu = cpu_plain_model(copy.deepcopy(view))
    ref = tail_logits(cpu, batch, torch.device("cpu"), n)
    del cpu, view
    return check_logits(torch, got, ref, what)


# bench.py's headline serving engine (bench.py:476-507): 32 slots, cap
# 1,024, the bf16 cache, admission bucket 8, decode chunk 32, no fusion,
# early first tokens; its requests: prompts of about 500 tokens with two
# series of 256 and 512 points (bench.py:19-20), greedy.
HEADLINE_ENGINE = dict(max_batch_size=32, max_model_len=1024, admission_bucket=8,
                       decode_chunk=32, fuse=False, block_early_emit=True)
# The first 8 requests are admitted on an idle engine; after their first
# decode round the next 24 arrive and take three block rounds of 8 in a
# row.  With 1 + 3 x 32 tokens each, every slot is live for two whole
# rounds (64 tokens at c32) before the first 8 finish; then a burst of 8
# arrives while the other 24 decode, and at the end one request alone.
HEADLINE_TOKENS = 97
HEADLINE_BURST_TOKENS = 65
HEADLINE_SINGLE_TOKENS = 17
HEADLINE_REQUESTS = 41
# The graph against eager rounds: 8 requests on an idle engine and 8 by one
# block round, 33 tokens each.
HEADLINE_CHECK_WAVES = [(0, 8, 33, None), (8, 16, 33, (0, "first_token"))]


def headline_specs(count: int, seed: int) -> list:
    """``count`` (prompt, series) of bench.py's shape: 500 prompt tokens (one
    length class: under 512) with two random-walk series of 256 and 512
    points."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        words = " ".join(f"w{int(x)}" for x in rng.integers(0, 10 ** 6, 430))
        out.append((f"here are two metrics <ts><ts/> and <ts><ts/> then {words} analyze their "
                    f"local changes", [rng.normal(0, 50, 256).cumsum(),
                                       rng.normal(0, 5, 512).cumsum()]))
    return out


class WaveFeed:
    """Queues waves of greedy requests from the engine's own loop: it wraps
    ``engine._complete_round``, so that after a round, the next wave is
    queued (its requests made there) as soon as every request of the wave
    it waits for has its first token or has finished, before the loop's
    next admission.  Each run then admits the same waves in the same rounds.
    ``waves``: (first spec, end, max_tokens, after) each, ``after`` None for
    the first wave, else (index of an earlier wave, "first_token" or
    "finished")."""

    def __init__(self, engine, specs, waves):
        self.engine, self.specs, self.waves, self.queued = engine, specs, waves, []
        self.inner = engine._complete_round
        engine._complete_round = self._complete

    def _queue(self, k: int) -> None:
        from chatts_tpu_torch.serve.scheduler import Request, SamplingParams

        lo, hi, n, _ = self.waves[k]
        reqs = [Request(*self.specs[i], SamplingParams(max_tokens=n, temperature=0.0))
                for i in range(lo, hi)]
        self.queued.append(reqs)
        self.engine.waiting.requeue(reqs)
        self.engine._wake.set()

    def _complete(self, handle):
        out = self.inner(handle)
        k = len(self.queued)
        if k < len(self.waves):
            wave, event = self.waves[k][3]
            field = "first_token_s" if event == "first_token" else "finished_s"
            if all(getattr(r, field) is not None for r in self.queued[wave]):
                self._queue(k)
        return out

    def run(self, timeout_s: float = 600.0) -> list:
        """Queue the first wave and wait until every wave is queued and every
        request has finished; raises on a request's error.  Returns the
        waves' requests."""
        self._queue(0)
        deadline = time.time() + timeout_s
        try:
            while (len(self.queued) < len(self.waves)
                   or any(r.finished_s is None for w in self.queued for r in w)):
                errors = [r.error for w in self.queued for r in w if r.error]
                if errors:
                    raise AssertionError(f"engine errors: {errors[:2]}")
                if time.time() > deadline:
                    raise TimeoutError(f"waves not served in {timeout_s} s")
                time.sleep(0.002)
        finally:
            del self.engine._complete_round
        # The loop logs a round after its admission: wait for the last entry.
        count = -1
        while count != len(self.engine.round_snapshot()) and time.time() < deadline:
            count = len(self.engine.round_snapshot())
            time.sleep(0.05)
        for wave, (lo, hi, n, _) in zip(self.queued, self.waves):
            for r in wave:
                if r.error or len(r.output_tokens) != n or r.finish_reason != "length":
                    raise AssertionError(f"a request ended {r.finish_reason} with "
                                         f"{len(r.output_tokens)} of {n} tokens ({r.error})")
        return self.queued


def decode_step_ms(torch, decode_graph) -> float:
    """A serving decode step's device time: CUDA events around the replays of
    one round of its raw graph (no ledger count), the emitted column reset
    first as ``round`` resets it, after one such round; per step."""
    graph = getattr(decode_graph.graph, "graph", decode_graph.graph)  # a GraphLedger's
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.inference_mode():  # the engine made its state there
        for _ in range(2):
            decode_graph.column.zero_()
            start.record()
            for _ in range(decode_graph.chunk_size):
                graph.replay()
            end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / decode_graph.chunk_size


def serve_headline(torch, smi: str, model, cfg, cache_dtype, path: str, runs: int,
                   what: str) -> dict:
    """Phase 13's serving: ``HEADLINE_ENGINE`` with ``cache_dtype`` and its
    traffic ``runs`` times on one engine (the rounds from the decode step's
    graph), each run's tokens equal to the first's; then, with ``runs`` > 1,
    ``HEADLINE_CHECK_WAVES``' schedule on the same engine against a fresh
    engine whose decode rounds run eagerly (``eager_rounds``): the same
    tokens.  Logs TPOT and tok/s of the rounds with every slot live, the
    burst's and the single request's TTFT, the replayed step's device time,
    the captures and the peak memory, beside the card; returns the launches
    of the graph runs as ``path`` and the numbers."""
    import numpy as np

    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.serve.scheduler import ServeEngine

    dev = torch.device("cuda", 0)
    slots, chunk = HEADLINE_ENGINE["max_batch_size"], HEADLINE_ENGINE["decode_chunk"]
    specs = headline_specs(HEADLINE_REQUESTS, SEED + 13)
    proc = ChatTSProcessor(WordTokenizer(), cfg)
    waves = [(0, 8, HEADLINE_TOKENS, None), (8, 32, HEADLINE_TOKENS, (0, "first_token")),
             (32, 40, HEADLINE_BURST_TOKENS, (0, "finished"))]
    bf16 = cache_dtype == torch.bfloat16
    required = ("flash_attention", "ragged_decode_attention" if bf16 else
                "ragged_decode_attention_int8", "int4_matmul") + GLUE
    torch.cuda.reset_peak_memory_stats(dev)
    engine = ServeEngine(model, cfg, proc, device=dev, cache_dtype=cache_dtype, **HEADLINE_ENGINE)
    tokens, summary = [], []
    reset_launches()
    with engine:
        for _ in range(runs):
            log_before = len(engine.round_snapshot())
            start = time.perf_counter()
            first, rest, burst = WaveFeed(engine, specs, waves).run()
            (single,), = WaveFeed(engine, specs, [(40, 41, HEADLINE_SINGLE_TOKENS, None)]).run()
            wall = time.perf_counter() - start
            rounds = engine.round_snapshot()[log_before:]
            kinds = [r["kind"] for r in rounds]
            full = [r for r in rounds if r["kind"] == "decode" and r["live"] == slots
                    and r["emitted"] == slots * chunk]
            burst_live = [r["live"] for r in rounds if r["kind"] == "block_pre"][-1:]
            if (kinds.count("mono") != 2 or kinds.count("block_pre") != 4 or len(full) < 2
                    or burst_live != [slots - 8]):
                raise AssertionError(f"{what}: rounds {kinds}, {len(full)} with every slot live, "
                                     f"the burst admitted next to {burst_live} live slots")
            ttft_burst = sorted(r.ttft_s * 1e3 for r in burst)
            summary.append(dict(
                tpot_ms=1e3 * float(np.mean([r["round_s"] for r in full])) / chunk,
                decode_tok_s_c32=float(np.mean([slots * chunk / r["round_s"] for r in full])),
                burst_ttft_ms_p50=ttft_burst[len(ttft_burst) // 2],
                burst_ttft_ms_max=ttft_burst[-1], single_ttft_ms=single.ttft_s * 1e3,
                wave_ttft_ms_mean=float(np.mean([r.ttft_s * 1e3 for r in first + rest])),
                wall_s=wall, rounds=kinds, full_rounds=len(full),
                live_when_burst_admitted=burst_live[0]))
            tokens.append([r.output_tokens for r in first + rest + burst + [single]])
            prompts = (min(r.prompt_tokens for r in first + rest + burst),
                       max(r.prompt_tokens for r in first + rest + burst))
        launches = read_launches(path, required)
        if launches["ragged_decode_attention_int8" if bf16 else "ragged_decode_attention"]:
            raise AssertionError(f"{what}: the {'bf16' if bf16 else 'int8'} cache launched the "
                                 f"other decode attention: {launches}")
        if any(t != tokens[0] for t in tokens[1:]):
            raise AssertionError(f"{what}: a second run gave other tokens")
        check = None
        if runs > 1:
            check = WaveFeed(engine, specs, HEADLINE_CHECK_WAVES)
            check = [r.output_tokens for w in check.run() for r in w]
    stats = engine.stats()
    step_ms = decode_step_ms(torch, engine._decode_graph)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    captures = stats["graph_captures"]
    if check is not None:
        with eager_rounds("decode"):
            eager = ServeEngine(model, cfg, proc, device=dev, cache_dtype=cache_dtype,
                                **HEADLINE_ENGINE)
            with eager:
                got = WaveFeed(eager, specs, HEADLINE_CHECK_WAVES)
                got = [r.output_tokens for w in got.run() for r in w]
        if got != check:
            raise AssertionError(f"{what}: the decode graph served other tokens than eager "
                                 "rounds")
        del eager
    for i, s in enumerate(summary):
        log(f"  {what} run {i + 1}: TPOT {s['tpot_ms']:.3f} ms and {s['decode_tok_s_c32']:.1f} "
            f"tok/s over {s['full_rounds']} rounds with all {slots} slots live; burst of 8 "
            f"TTFT p50 {s['burst_ttft_ms_p50']:.1f} ms (max {s['burst_ttft_ms_max']:.1f}; "
            f"{s['live_when_burst_admitted']} slots decoding); single TTFT "
            f"{s['single_ttft_ms']:.1f} ms; the first 32 TTFT mean "
            f"{s['wave_ttft_ms_mean']:.1f} ms; rounds {' '.join(s['rounds'])} in "
            f"{s['wall_s']:.2f} s")
    log(f"  {what}: prompt tokens {prompts[0]} to {prompts[1]}; a decode step replayed from "
        f"its graph {step_ms:.3f} ms of device time (a round's {chunk} replays, all {slots} "
        f"slots); captures "
        f"{json.dumps(captures)}; peak memory "
        f"{peak_gb:.2f} GB; {runs} runs token-identical"
        + ("; the decode graph served the eager rounds' tokens" if check is not None else "")
        + f"; card {smi}")
    del engine
    torch.cuda.empty_cache()
    return dict(launches=launches, runs=summary, step_ms=step_ms, captures=captures,
                peak_memory_gb=peak_gb, card=smi, tokens=tokens[0])


# The per-layer check's prompt: one row of about 110 tokens with bench.py's
# two series (the CPU runs every layer of it in f32).
LAYER_CHECK_SPECS = [(50, [256, 512])]
# The 2-layer logit check's batch (phase 3's lengths, shorter).
TWO_LAYER_SPECS = [(250, [256]), (200, [512, 256]), (150, [300]), (100, [800])]


def phase_headline(smi: str) -> dict:
    """Phase 13: bench.py's headline serving configuration at full width
    and depth (28 layers) on random int4 weights from ``init_quantized_params``
    (``serve_headline``); then the 2-layer logit check and the per-layer
    check against the CPU.  Returns the launches of the graph runs."""
    import torch

    from chatts_tpu_torch.models.quantize import init_quantized_params

    dev = torch.device("cuda", 0)
    with Phase(13, "the reference's headline serving configuration: bench.py's 8B shape, 28 "
                   "layers, int4, bf16 KV cache, ServeEngine at 32 slots"):
        cfg = chatts_8b_config(num_layers=28)
        start = time.perf_counter()
        model = init_quantized_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 13),
                                      dev)
        torch.cuda.synchronize(dev)
        log(f"  random int4 weights on the card: {_model_gb(model):.2f} GB in "
            f"{time.perf_counter() - start:.1f} s")
        out = serve_headline(torch, smi, model, cfg, torch.bfloat16, "headline_bf16", 2, "13")
        out["two_layers"] = two_layers_against_cpu(
            torch, model, cfg, make_batch(cfg, TWO_LAYER_SPECS, SEED + 13), "13, 2 layers")
        out["per_layer"] = per_layer_against_cpu(
            torch, model, make_batch(cfg, LAYER_CHECK_SPECS, SEED + 13), "13")
        log("  headline stats: " + json.dumps(
            {k: v for k, v in out.items() if k not in ("launches", "tokens")}))
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out["launches"]


QWEN3_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                     "down_proj")


def _projection(llm, i: int, name: str):
    """Layer i's unfused projection ``name``."""
    layer = llm.layers[i]
    return getattr(layer.mlp if name in ("gate_proj", "up_proj", "down_proj")
                   else layer.self_attn, name)


def float_twin(torch, model) -> None:
    """``model``'s int4 projections and head made float in place: each holds
    its dequantized weights in bf16, the layout ``save_checkpoint`` writes."""
    from chatts_tpu_torch.models.qwen import Dense
    from chatts_tpu_torch.ops import int4_matmul as i4

    with torch.no_grad():
        for module in list(model.modules()):
            for name, child in list(module.named_children()):
                if isinstance(child, Dense) and child.kernel_q4 is not None:
                    setattr(module, name, Dense(
                        i4.dequantize(child.kernel_q4, child.scales4, torch.bfloat16),
                        bias=child.bias))
        llm = model.llm
        llm.lm_head = torch.nn.Parameter(llm.lm_head_q.kernel, requires_grad=False)
        llm.lm_head_q = None


def phase_qwen3(smi: str) -> dict:
    """Phase 13q: the Qwen3 decoder at Qwen3-8B's published widths and depth
    (``qwen3_8b_config``): random int4 weights from ``init_quantized_params``
    (unfused) with q/k norms drawn in [0.5, 1.5], made float, written by
    ``save_checkpoint`` and read back by ``load_checkpoint(quantize_bits=4)``
    (the architecture, every norm, the embeddings, layers 0 and 35 and the
    head bit-equal to ``pack_int4`` of what was written); the loaded model
    served as phase 13 serves, with the bf16 cache (twice and against eager
    rounds) and once with the int8 cache; the 2-layer and per-layer checks
    against the CPU; and a LoRA step at 2 layers of the same widths against
    the CPU (as 9a).  Returns the launches of the serving runs."""
    import os
    import tempfile

    import torch

    from chatts_tpu_torch.models import weights
    from chatts_tpu_torch.models.quantize import init_quantized_params
    from chatts_tpu_torch.ops import int4_matmul as i4
    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.train import data

    dev = torch.device("cuda", 0)
    out = dict(card=smi)
    with Phase("13q", "the Qwen3 decoder at Qwen3-8B's widths, 36 layers, int4: written by "
                      "save_checkpoint, loaded by load_checkpoint, served from the bf16 and int8 "
                      "KV caches; a 2-layer LoRA step against the CPU"):
        cfg = qwen3_8b_config(num_layers=36)
        last = cfg.llm.num_hidden_layers - 1
        model = init_quantized_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 14),
                                      dev, fused=False)
        qwen3_norms(torch, model, SEED + 14)
        float_twin(torch, model)
        llm = model.llm
        # What the loader must make of layers 0 and 35 and of the head, which
        # it quantizes HEAD_COLUMNS output columns at a time.
        want = {(i, name): i4.pack_int4(_projection(llm, i, name).kernel)
                for i in (0, last) for name in QWEN3_PROJECTIONS}
        want["head"] = i4.pack_int4(llm.lm_head)
        norms = [(layer.self_attn.q_norm.clone(), layer.self_attn.k_norm.clone())
                 for layer in llm.layers]
        embed = llm.embed_tokens.clone()
        with tempfile.TemporaryDirectory(prefix="chatts_phase13q_") as tmp:
            start = time.perf_counter()
            weights.save_checkpoint(tmp, cfg, model)
            save_s = time.perf_counter() - start
            size_gb = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp)) / 1e9
            with open(os.path.join(tmp, "config.json")) as f:
                arch = json.load(f)["architectures"]
            del model, llm
            gc.collect()
            torch.cuda.empty_cache()
            start = time.perf_counter()
            loaded_cfg, model = weights.load_checkpoint(tmp, quantize_bits=4, device=dev)
            torch.cuda.synchronize(dev)
            load_s = time.perf_counter() - start
        llm = model.llm
        differ = []
        for key, (packed, scales) in want.items():
            dense = llm.lm_head_q if key == "head" else _projection(llm, *key)
            if not (torch.equal(packed, dense.kernel_q4) and torch.equal(scales, dense.scales4)):
                differ.append(str(key))
        differ += [f"norms {i}" for i, (q, k) in enumerate(norms)
                   if not (torch.equal(q, llm.layers[i].self_attn.q_norm)
                           and torch.equal(k, llm.layers[i].self_attn.k_norm))]
        if not torch.equal(embed, llm.embed_tokens):
            differ.append("embed_tokens")
        del want, norms, embed
        log(f"  save_checkpoint: {size_gb:.2f} GB (f32) in {save_s:.1f} s, architectures {arch}; "
            f"load_checkpoint(quantize_bits=4): {_model_gb(model):.2f} GB in {load_s:.1f} s; "
            f"config {'equal' if loaded_cfg.llm == cfg.llm else 'NOT equal'}; "
            f"{len(differ)} of layers 0 and {last}'s projections, the head, every norm and the "
            f"embeddings differ from what was written")
        if arch != ["Qwen3TSForCausalLM"] or loaded_cfg.llm != cfg.llm or differ:
            raise AssertionError(f"13q: the Qwen3 directory did not round-trip: {arch}, "
                                 f"{loaded_cfg.llm}, {differ[:4]}")
        if llm.layers[0].self_attn.q_proj.bias is not None or llm.lm_head_q is None:
            raise AssertionError("13q: the loaded model has an attention bias or no int4 head")
        out.update(save_s=save_s, load_s=load_s, directory_gb=size_gb)
        out["bf16"] = serve_headline(torch, smi, model, loaded_cfg, torch.bfloat16, "qwen3", 2,
                                     "13q bf16")
        launches = out["bf16"]["launches"]
        out["int8"] = serve_headline(torch, smi, model, loaded_cfg, torch.int8, "qwen3_int8", 1,
                                     "13q int8")
        launches = {k: v + out["int8"]["launches"][k] for k, v in launches.items()}
        agree = sum(a == b for a, b in zip(out["bf16"]["tokens"], out["int8"]["tokens"]))
        log(f"  13q: requests with the same tokens from the bf16 and the int8 cache: "
            f"{agree}/{len(out['bf16']['tokens'])} (not gated)")
        out["two_layers"] = two_layers_against_cpu(
            torch, model, loaded_cfg, make_batch(loaded_cfg, TWO_LAYER_SPECS, SEED + 14),
            "13q, 2 layers")
        out["per_layer"] = per_layer_against_cpu(
            torch, model, make_batch(loaded_cfg, LAYER_CHECK_SPECS, SEED + 14), "13q")
        del model, llm
        gc.collect()
        torch.cuda.empty_cache()
        cut = qwen3_8b_config(num_layers=2)
        batch_np = data.build_sft_batch(ChatTSProcessor(WordTokenizer(), cut),
                                        sft_rows(2, 64, 1, 150, 60, SEED + 15))
        lora_model, _, _, _, out["lora"] = lora_against_cpu(torch, cut, batch_np, "13q",
                                                            norms_seed=SEED + 15)
        del lora_model
        log("  qwen3 stats: " + json.dumps(
            {k: ({kk: vv for kk, vv in v.items() if kk not in ("launches", "tokens")}
                 if isinstance(v, dict) else v) for k, v in out.items()}))
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def long_specs(count: int, seed: int) -> list:
    """Phase 8b's second wave as (prompt, series): about 2,400 to 2,900
    prompt tokens, four random-walk series of 512 points and a long text."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        holes = " ".join(f"metric {j} <ts><ts/>" for j in range(4))
        words = " ".join(f"word{k}" for k in range(2270 + 150 * i))
        out.append((f"here are four metrics {holes} then {words} compare their local changes",
                    [rng.normal(0, 10, 512).cumsum() for _ in range(4)]))
    return out


def phase_serving_6144_bf16(smi: str, model, cfg) -> dict:
    """Phase 8f, on phase 4's weights after phase 8's engines are freed: 8b's
    schedule with the bf16 cache.  ``ServeEngine`` at 24 slots, cap 6,144,
    bf16 KV (29 GB beside the 9.41 GB of weights), decode chunk 32, early
    emit: 8 requests of bench.py's shape, then, once they decode, 4 of 2,400
    to 2,900 tokens that no block takes, admitted by two scan-sliced rounds
    (npt 64, kv_limit 2,048 then 4,096) whose steps replay the mixed graphs
    (B2 on the decode side, the bf16 prefix copied for B1), each round's
    device span beside its host seconds (which hold the capture); then the
    same schedule with eager mixed rounds: the same tokens.  Returns the
    launches of both runs."""
    import numpy as np
    import torch

    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.serve import scheduler
    from chatts_tpu_torch.serve.scheduler import ServeEngine

    dev = torch.device("cuda", 0)
    with Phase("8f", "scan-sliced admission at full size from the bf16 cache: ServeEngine, "
                     "24 slots, cap 6,144, bf16 KV; mixed rounds from their graphs, then eager"):
        torch.cuda.reset_peak_memory_stats(dev)
        engine = ServeEngine(model, cfg, ChatTSProcessor(WordTokenizer(), cfg), device=dev,
                             max_batch_size=24, max_model_len=6144, cache_dtype=torch.bfloat16,
                             decode_chunk=32, fuse=False, block_early_emit=True,
                             admission_bucket=8)
        specs = headline_specs(8, SEED + 16) + long_specs(4, SEED + 8)
        waves = [(0, 8, 64, None), (8, 12, 64, (0, "first_token"))]
        clock = RoundClock(scheduler._MixedStepGraph, EagerMixedRounds)
        runs = {}
        reset_launches()
        try:
            with engine:
                for form in ("graph", "eager"):
                    log_before, n_spans = len(engine.round_snapshot()), len(clock.events)
                    graphs = dict(engine._mixed_graphs)
                    if form == "eager":
                        engine._mixed_graphs.clear()  # made again as eager stand-ins
                    with eager_rounds("mixed") if form == "eager" else contextlib.nullcontext():
                        start = time.perf_counter()
                        short, long = WaveFeed(engine, specs, waves).run()
                        wall = time.perf_counter() - start
                    if form == "eager":
                        engine._mixed_graphs.clear()
                        engine._mixed_graphs.update(graphs)
                    runs.setdefault(form, []).append((
                        short, long, engine.round_snapshot()[log_before:], n_spans,
                        len(clock.events), wall))
            launches = read_launches("serving at cap 6,144 from the bf16 cache (8f)", (
                "flash_attention", "ragged_decode_attention", "int4_matmul") + GLUE)
        finally:
            clock.remove()
        spans_ms = clock.read_ms()
        stats = engine.stats()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        captures = [c for c in stats["graph_captures"]
                    if c["kind"] == "mixed" and c["pool_bytes"] is not None]
        if sorted(c["key"] for c in captures) != [[4, 64, 2048], [4, 64, 4096]]:
            raise AssertionError(f"8f: mixed graphs captured: {captures}")
        if launches["ragged_decode_attention_int8"] or launches["int4_matmul_a8"]:
            raise AssertionError(f"8f: the bf16 cache's path launched {launches}")
        lens = sorted(r.prompt_tokens for r in runs["graph"][0][1])
        if lens[0] < 2400 or lens[-1] > 3000:
            raise AssertionError(f"8f: wave 2 prompt tokens {lens} outside 2,400..3,000")
        ids, summary = [], {}
        for form, form_runs in runs.items():
            for i, (short, long, rounds, first, last, wall) in enumerate(form_runs):
                ids.append([r.output_tokens for r in short + long])
                mixed = [r["round_s"] for r in rounds if r["kind"] == "mixed"]
                if len(mixed) != 2:
                    raise AssertionError(f"8f {form}: {len(mixed)} mixed rounds, not 2")
                run = dict(wave2_ttft_ms=[r.ttft_s * 1e3 for r in long], mixed_host_s=mixed,
                           mixed_device_ms=spans_ms[first:last], wall_s=wall,
                           **wave1_rate(short))
                summary.setdefault(form, []).append(run)
                log(f"  8f {form} run {i + 1}: wave 2 TTFT mean "
                    f"{np.mean(run['wave2_ttft_ms']):.1f} ms; wave 1 decode "
                    f"{run['wave1_tok_s']:.1f} tokens/s while it is admitted; mixed rounds, host "
                    f"(device span) " + ", ".join(f"{t:.3f} s ({ms:.1f} ms)" for t, ms in
                                                  zip(mixed, run["mixed_device_ms"]))
                    + f"; wall {wall:.2f} s")
        if any(other != ids[0] for other in ids[1:]):
            raise AssertionError("8f: the mixed rounds from their graphs and eager mixed rounds "
                                 "on the bf16 cache served other tokens")
        log(f"  8f: wave 2 prompt tokens {lens}; mixed graphs (a, npt, kv_limit) "
            f"{[c['key'] for c in captures]} captured in "
            f"{[round(c['seconds'], 3) for c in captures]} s (in the graph run's rounds), pool "
            f"bytes {[c['pool_bytes'] for c in captures]}; the graph run's tokens equal to the "
            f"eager run's; peak memory {peak_gb:.2f} GB; card {smi}")
        log("  serving_6144_bf16 stats: " + json.dumps(dict(
            runs=summary, captures=captures, graph_rounds=stats["graph_rounds"],
            peak_memory_gb=peak_gb, card=smi)))
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return launches


REPLACES = {
    "flash_attention": "chatts_tpu/ops/flash_attention.py:129",
    "ragged_decode_attention": "chatts_tpu/ops/ragged_decode_attention.py:123",
    "ragged_decode_attention_int8": "chatts_tpu/ops/ragged_decode_attention.py:376",
    "int4_matmul": "chatts_tpu/ops/int4_matmul.py:291",
    "int4_matmul_a8": "chatts_tpu/ops/int4_matmul.py:176",
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script runs only "
              "on a CUDA card", file=sys.stderr)
        return 1
    import chatts_tpu_torch  # noqa: F401  (fails outside a checkout of the repository)

    global GRAPH_LEDGER, GLUE_WATCH
    GRAPH_LEDGER = GraphLedger()
    GLUE_WATCH = GlueWatch()
    smi = phase_environment()
    phase_build()
    kernels = phase_kernels()
    phase_model()
    phase_model_a8()
    phase_serving_model()
    paths = {"mixed_model": phase_mixed_model()}
    paths["batch"], model, cfg, bf16_run = phase_slice(smi)
    paths["serving"] = phase_serving(smi, model, cfg)
    paths["batch_a8"] = phase_slice_a8(smi, model, cfg, bf16_run)
    paths["serving_a8"] = phase_serving(smi, model, cfg, act_int8=True)
    # The engines of phases 5 and 6b hold the model in reference cycles
    # (WaveGate): collect them before phase 8 makes its own, and phase 8's
    # before phase 7 loads another model.  Phase 8 needs phase 4's weights.
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(phase_chunked(smi, model, cfg, bf16_run))
    gc.collect()
    torch.cuda.empty_cache()
    paths["serving_6144_bf16"] = phase_serving_6144_bf16(smi, model, cfg)
    paths["eval"] = phase_eval(smi, model, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 11's answers are noise at random weights: it runs on the first
    # DATAGEN_LAYERS layers of phase 4's model.
    datagen_cfg, datagen_model = first_layers(model, cfg, DATAGEN_LAYERS)
    paths["datagen"] = phase_datagen(smi, datagen_model, datagen_cfg)
    del model, datagen_model
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(phase_disk(smi, bf16_run, paths["batch"]))
    paths["training"], refs = phase_train(smi)
    paths.update(phase_mesh_training(smi, refs))
    paths["headline_bf16"] = phase_headline(smi)
    paths["qwen3"] = phase_qwen3(smi)
    # Each path counted from 0: "launches" is a kernel's sum over the paths,
    # and "launches_by_path" says which path launched what.  A wrapper counts
    # a kernel inside a CUDA graph once, when the graph is captured; the
    # graphs' replays are counted per graph ("graph_replays": by the path's
    # label, [the kernel's launches in one replay, replays] a graph).
    by_path = {name: {path: counts[name] for path, counts in paths.items()}
               for name in REPLACES}
    replays = {name: {label: [[kernels[name], n] for kernels, n in graphs if name in kernels]
                      for label, graphs in GRAPH_LEDGER.by_path.items()}
               for name in REPLACES}
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"chatts_tpu_torch/csrc/{name}.cu",
         "replaces": REPLACES[name], "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name],
         "launches_counted": "each call of the wrapper: every eager call, and once for each "
                             "CUDA graph the kernel is captured into; graph_replays counts "
                             "the replays per graph",
         "graph_replays": {label: g for label, g in replays[name].items() if g},
         **{key: kernels[name].get(key) for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "library_note", "more_shapes")}}
        for name in REPLACES
    ]}))
    # The decoder glue's kernels, counted the same way; they replace no TPU
    # kernel.  Phase 2's rows: the kernel, its eager composition, the bound
    # and, for the norm, F.rms_norm; then the decode step fused and eager.
    log(json.dumps({"glue": [
        {"name": name, "route": "cuda", "source": "chatts_tpu_torch/csrc/fused_glue.cu",
         "launches": sum(counts.get(name, 0) for counts in paths.values()),
         "launches_by_path": {path: counts.get(name, 0) for path, counts in paths.items()},
         "graph_replays": {label: g for label, g in (
             (label, [[k[name], n] for k, n in graphs if name in k])
             for label, graphs in GRAPH_LEDGER.by_path.items()) if g},
         **kernels[name]}
        for name in GLUE], "decode_step": kernels["decode_step"]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
