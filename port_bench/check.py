"""The check that decides ``correct``: a sample of what the window served,
held to the plain reference.

Once the window has closed and the program's state is freed, a sample of the
finished requests, drawn from the seed and holding the one with the most
served tokens and one admitted by each prefill route that the run took
(monolithic, block, scan-sliced), is run through the reference of the
configuration's family (``families/<family>.py``, ``logits``, built on
``reference/``): each prompt with its served tokens, the logits at every
position that produced one.  The sample, the prompts' encoding and the
comparison are shared; only the forward pass is the family's.  The
number compared is the widest gap by which a served token's logit lies below
the reference's best at its position (greedy tokens only; every mix here is
greedy).  The configuration's ``check.logit_gap_limit`` bounds it; the
readings it was set from are in PERF.md.

Beside it, exact counts: every request the run answers for finished, with
the tokens it asked for, and the reference's processor gives the prompt the
length the engine admitted.

``control=True`` also reads the control: the family's reference computed
with float8 activations (``logits(..., lowered=True)``), the gap of the token
it puts first at each of the same positions.  The benchmark's runs never
read it; the control script and its test do.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from port_bench.reference import model as ref_model
from port_bench.reference import processor as ref_processor


def sample(records: list, k: int, seed: int) -> list:
    """The finished requests to compare: the one with the most served
    tokens, one drawn from the seed for each admission route (``route``:
    mono, block, mixed) that took some request and none chosen yet, and
    others drawn from the seed up to k."""
    done = [r for r in records if r.ok and r.req.output_tokens]
    if not done:
        return []
    rng = np.random.default_rng([int(seed), 4])
    chosen = [max(done, key=lambda r: (len(r.req.output_tokens), -r.spec.index))]
    for route in sorted({str(getattr(r, "route", None)) for r in done}):
        if len(chosen) < k and all(str(getattr(r, "route", None)) != route for r in chosen):
            of = [r for r in done if str(getattr(r, "route", None)) == route]
            chosen.append(of[int(rng.integers(len(of)))])
    rest = [r for r in done if all(r is not c for c in chosen)]
    pick = rng.choice(len(rest), size=min(k - len(chosen), len(rest)), replace=False) \
        if rest else []
    chosen += [rest[i] for i in pick]
    return sorted(chosen, key=lambda r: r.spec.index)


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """max(ref) - ref[token] at each position."""
    return ref.max(dim=-1).values - ref.gather(1, tokens[:, None])[:, 0]


def check(family, cfg: dict, w: Dict[str, torch.Tensor], records: list, seed: int,
          control: bool = False) -> dict:
    """The numbers compared, each with its limit, and ``correct``; ``family``
    is the configuration's family module, whose ``logits`` is the reference."""
    spec = cfg["check"]
    chosen = sample(records, int(spec["sample_requests"]), seed)
    seqs: List[ref_model.Sequence_] = []
    served: List[torch.Tensor] = []
    mismatched = 0
    for r in chosen:
        ids, values, starts = ref_processor.encode(
            r.spec.prompt, r.spec.series, cfg["ts"]["patch_size"], cfg["ts_token_start_index"])
        if len(ids) != r.req.prompt_tokens:
            mismatched += 1
        out = list(r.req.output_tokens)
        p = len(ids)
        seqs.append(ref_model.Sequence_(ids + out[:-1], values, starts,
                                        range(p - 1, p - 1 + len(out))))
        served.append(torch.tensor(out, dtype=torch.int64, device=w["embed"].device))
    gap = lowered_gap = 0.0
    detail = []
    if seqs:
        ref = family.logits(cfg, w, seqs)
        per = [gaps(lg, tok) for lg, tok in zip(ref, served)]
        gap = max(float(g.max()) for g in per)
        for r, g, lg, tok in zip(chosen, per, ref, served):
            top2 = lg.topk(2, dim=-1).values
            differ = (lg.argmax(dim=-1) != tok).nonzero()
            detail.append(dict(
                index=r.spec.index, route=getattr(r, "route", None),
                prompt=r.req.prompt_tokens, served=int(tok.numel()),
                widest=float(g.max()), at=int(g.argmax()),
                first_other=int(differ[0]) if differ.numel() else None,
                others=int(differ.numel()),
                margin_median=float((top2[:, 0] - top2[:, 1]).median()),
                logit_std=float(lg.std(dim=-1).mean()),
                worst=[(int(i), int(tok[i]), int(lg[i].argmax()), round(float(g[i]), 4))
                       for i in g.topk(min(5, g.numel())).indices if g[i] > 0]))
        if control:
            low = family.logits(cfg, w, seqs, lowered=True)
            lowered_gap = max(float(gaps(lg, lo.argmax(dim=-1)).max())
                              for lg, lo in zip(ref, low))
    short = sum(1 for r in records if not r.ok or r.tokens != r.spec.max_tokens)
    numbers = {
        "logit_gap": (gap, float(spec["logit_gap_limit"])),
        "requests_short": (float(short), 0.0),
        "prompt_mismatch": (float(mismatched), 0.0),
        "sampled": (float(len(chosen)), float(spec["sample_requests"])),
    }
    correct = (bool(chosen) and gap <= numbers["logit_gap"][1] and short == 0
               and mismatched == 0 and len(chosen) == int(spec["sample_requests"]))
    out = dict(correct=correct, numbers=numbers, tokens=int(sum(len(s) for s in served)),
               detail=detail)
    if control:
        out["control_gap"] = lowered_gap
    return out
