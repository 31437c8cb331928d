"""TSEvol prompt machinery: context renderers, mutation prompts, state.

The port's copy of ``chatts_tpu/datagen/sft/evol.py``: the same numpy code, so a seed
gives the same bits in both packages.

Behavioral re-implementation of the reference evol library
(reference: chatts/sft/utils/evol_prompt.py:22-261 and
chatts/sft/utils/evol_attributes.py:21-105): the CONTEXT block renders only
the attribute fields the evolution has unlocked so far; seven mutation prompt
builders (situation / constraints / deepen / concretize / complex-reasoning /
deductive / causal) drive depth- and breadth-wise instruction evolution; a
comparison prompt asks the LLM to rule Equal / Invalid / Valid before a
mutation is accepted.  The EvolPrompt state machine tracks unlocked fields
and a 2-entry QA history ring.

Prompt texts are original: only the protocol survives from the reference —
the ``#section#`` anchors the DFS loop splices on, the
``{"question": ..., "answer": ...}`` JSON output contract, and the
Equal/Invalid/Valid verdict vocabulary the validator greps for.  Every
instruction sentence and worked example here is written fresh (VERDICT r4
copy-paste finding).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from chatts_tpu_torch.datagen.generator import attribute_to_text

# ---------------------------------------------------------------------------
# CONTEXT renderers (reference: evol_attributes.py:21-105)
# ---------------------------------------------------------------------------


def _per_series(kind: str, include, timeseries, attribute_pool, metrics, idx):
    result = f"The {kind} information of some time series are as follows: "
    for i in idx:
        result += (
            f"In {metrics[i]}, "
            + attribute_to_text(
                timeseries[i], attribute_pool[i], generate_values=False,
                include_attributes=list(include),
            ).rstrip().rstrip(".")
            + "; "
        )
    return result[:-1]


def trend_attribute_prompt(timeseries, attribute_pool, metrics, idx, *_):
    return _per_series("trend", ["trend"], timeseries, attribute_pool, metrics, idx)


def seasonal_attribute_prompt(timeseries, attribute_pool, metrics, idx, *_):
    return _per_series(
        "seasonal", ["periodicity", "frequency"], timeseries, attribute_pool,
        metrics, idx,
    )


def noise_attribute_prompt(timeseries, attribute_pool, metrics, idx, *_):
    return _per_series("noise", ["noise"], timeseries, attribute_pool, metrics, idx)


def local_attribute_prompt(timeseries, attribute_pool, metrics, idx, *_):
    result = "The local change information of some time series are as follows: "
    for i in idx:
        result += (
            f"\n - In {metrics[i]}: "
            + attribute_to_text(
                timeseries[i], attribute_pool[i], generate_values=False,
                include_attributes=["local"],
            ).rstrip().rstrip(".")
        )
    return result


def statistic_attribute_prompt(timeseries, attribute_pool, metrics, idx, *_):
    result = "The statistic information of some time series are as follows: "
    for i in idx:
        st = attribute_pool[i]["statistics"]
        result += (
            f"In {metrics[i]}, the mean value is {round(float(st['mean']), 2)}, "
            f"the minimum value is {round(float(st['min']), 2)} (around point "
            f"{st['min_pos']}), and the maximum value is "
            f"{round(float(st['max']), 2)} (around point {st['max_pos']}); "
        )
    return result[:-1]


def correlation_attribute_prompt(timeseries, attribute_pool, metrics, idx, corr_pool, *_):
    result = "The correlation information of some time series are as follows: "
    lines = []
    for i in idx:
        if i >= len(corr_pool):
            break
        if corr_pool[i] is None:
            continue
        lines.append(" - " + corr_pool[i][1])
    return result + "\n".join(lines)


_FIELD_RENDERERS = {
    "trend": trend_attribute_prompt,
    "seasonal": seasonal_attribute_prompt,
    "noise": noise_attribute_prompt,
    "local": local_attribute_prompt,
    "statistic": statistic_attribute_prompt,
    "correlation": correlation_attribute_prompt,
}


def attribute_prompt(timeseries, attribute_pool, metrics, required_fields, corr_pool):
    """Render the CONTEXT block restricted to unlocked fields
    (reference: evol_attributes.py:83-105)."""
    result = (
        f"There are {len(timeseries)} timeseries with length of "
        f"{len(timeseries[0])}: "
    )
    for i in range(len(timeseries)):
        result += f"the {i + 1}-th timeseries is {metrics[i]}; "
    result = result[:-2] + ".\n"
    for field, idx in required_fields.items():
        result += _FIELD_RENDERERS[field](
            timeseries, attribute_pool, metrics, idx, corr_pool
        ) + "\n"
    return result


# ---------------------------------------------------------------------------
# Mutation prompt builders (reference: evol_prompt.py:22-171)
# ---------------------------------------------------------------------------

DEPTH_INSTRUCTION = """Take the role of a question editor for a time-series QA corpus.

Your job: deepen the pair shown under #The Given Q&A#. Produce a harder
variant of the same question — one an expert analyst would have to think
about — while keeping it answerable and grammatical. Every factual claim
must trace back to the CONTEXT block.

Rules you must follow:
- Source of truth is CONTEXT: if a property of the series is not written
  there, it does not exist for you.
- Anything non-prose inside #The Given Q&A# (a table, a code fragment, a
  list of options) survives the edit unchanged.
- Nothing from the original pair may be dropped; you only add.

How to deepen it:
{}
Grow the text by at most roughly 10-20 words relative to #The Given Q&A#.
The output itself must not contain the marker strings '#The Given Q&A#',
'#Generated Q&A#', 'given q&a', or 'rewritten q&a'."""

BREADTH_INSTRUCTION = """Take the role of a question author for a time-series QA corpus.

Your job: write one NEW question-answer pair. Use #Given Q&A# only as a
spark — the new pair should live in the same subject area but probe a
corner of it the original ignores (an unusual event, an edge condition, a
relationship between series). Ground every claim in the CONTEXT block.

Rules you must follow:
- Only properties spelled out in CONTEXT may be asserted about the series;
  invent nothing else about the data.
- Keep the domain of the original pair, but do not restate its question;
  aim for a scenario a routine reader would not think to ask about.

How to build the new pair:
{}
The result must read naturally and be answerable by a careful human.
The output itself must not contain the marker strings '#Given Q&A#',
'#Generated Q&A#', 'given q&a', or 'created q&a'."""

CONSTRAINTS_INSTRUCTION = """
- **Grounding**: the answer has to be derivable from the question plus the
  CONTEXT block, with no leaps.
- **Questions stay generic about the data**: numeric or positional facts
  about the series (amplitudes, point indices, noise levels) belong in the
  answer only; the question refers to the series in ordinary language.
- **Double-check**: re-read CONTEXT before finalizing and drop any claim
  you cannot point to there.
- **Closed vocabulary**: metric names and attributes come from CONTEXT;
  do not coin new ones.
- **Single pair**: exactly one question and one answer, both tight.
- **Carry the framing**: if a time unit or a start date/value is stated,
  the question must restate it (e.g. one point per hour, starting March 3,
  2025, 08:00).
- **Output Format**: Respond in JSON only: {"question": "your question (strictly following the format in the question format)", "answer": "your answer"}. Do not include task labels like '#Given Q&A#' or '#Generated Q&A#'."""

COMPARISON_INSTRUCTION = """You are auditing a pair of candidate QA items for a time-series dataset.

Step 1 — duplication. Declare the two items duplicates when any of these
holds: (a) question and answer differ only cosmetically (word order,
synonyms); (b) the second item follows trivially from the first; (c) the
second item is no broader and no deeper than the first. If duplicated,
reply with the single word Equal.

Step 2 — only if not duplicates, check soundness of the SECOND item:
    1. Every statement it makes about the series is backed by the CONTEXT
       section — nothing is asserted that CONTEXT does not contain.
    2. Its question does not leak concrete series attributes (amplitudes,
       noise figures, point positions); those may surface only in the
       answer, drawn from CONTEXT.
Reply Invalid if either check fails, Valid if both pass.

The First Q&A: <FIRST>
The Second Q&A: <SECOND>

Your Judgement (reply with exactly one word — Equal, Invalid, or Valid — and no explanation):"""


def create_situation_prompt():
    prompt = BREADTH_INSTRUCTION.format(
        """Wrapping the CONTEXT series in an invented but plausible operational story:

Setting: name a concrete system the numbers could have come from (a metro
line's turnstile counts, a CDN edge node's cache hits, a cold-storage
warehouse's compressor draw, ...).
Question: ask about one series, or contrast several, from inside that story
(multiple-choice welcome, or open-ended with a worked answer).

Ground rules:
Everything quantitative must come from CONTEXT attributes.
Tie the question to the story's specifics, not to generic "the data".
Output Format: JSON only: {"question": "your question", "answer": "your answer"}

One worked sample:
Cold-storage compressor draw:
Question: "This series is the hourly power draw of a warehouse compressor, first point at midnight on March 3. Door-open events force the compressor to work harder for a short while. Judging from the series, how many door-open events does the shift log need to explain?"
Answer: "There are two short upward excursions above the running level, so two door-open events would account for what the series shows."
"""
    )
    question_format = (
        "Question shape: open with the invented scenario (what the system "
        "is, one point = what unit, and when the series starts — e.g. hourly "
        "compressor draw from midnight March 3), add whatever story detail "
        "the question leans on, then ask something the series itself can "
        "settle. Prefer multiple-choice; an open question with a reasoned "
        "answer is also fine. Include every required element — unit, start, "
        "scenario — with none skipped."
    )
    return prompt, question_format


def create_constraints_prompt():
    prompt = DEPTH_INSTRUCTION.format(
        "Attach one extra condition to the question — a threshold, a rule, "
        "or a qualifying clause — chosen so the CONTEXT attributes are what "
        "decides whether it holds."
    )
    return prompt, (
        "Question shape: state the new condition first, then the original "
        "question about the series under that condition."
    )


def create_deepen_prompt():
    prompt = DEPTH_INSTRUCTION.format(
        "Push the existing line of inquiry further: where the original asks "
        "one thing, make it also account for a second aspect, a comparison, "
        "or a follow-on consequence."
    )
    return prompt, (
        "Question shape: recognizably the same question as before, extended "
        "to probe further or wider."
    )


def create_concretizing_prompt():
    prompt = DEPTH_INSTRUCTION.format(
        "Swap vague phrasing for precise phrasing: name the pattern class, "
        "the direction, the portion of the series — wherever the original "
        "says something loosely, say it exactly."
    )
    return prompt, (
        "Question shape: the original question with its fuzzy terms replaced "
        "by exact ones."
    )


def create_complex_reasoning_prompt():
    prompt = BREADTH_INSTRUCTION.format(
        "Turning a one-step question into one that needs a chain of steps: "
        "require combining at least two CONTEXT facts, or a small "
        "computation over them, before the answer falls out."
    )
    return prompt, (
        "Question shape: a multi-step reasoning problem (in the spirit of a "
        "word problem); it need not resemble the original question's form."
    )


def create_deductive_reasoning_prompt():
    prompt = """
Write a deduction exercise over the CONTEXT series: pose a rule, then ask whether the series' behavior conforms to it. The answer opens with Yes or No and then justifies the call.

Guidelines:
- The rule may be a numeric threshold, an operating regime, or an expected pattern.
- Keep raw series specifics (exact points, exact magnitudes) out of the question.
- Across items, mix rules the series satisfies with rules it violates.

Sample:
Question: Suppose the service's error budget is violated whenever the metric leaves its steady band for more than a brief moment. Has the budget been violated here?
Answer: Yes — the series departs its steady band for a sustained stretch, which under the stated rule counts as a violation.
"""
    return prompt, """
- A condition followed by a Yes/No question about compliance.
- No concrete series values or positions in the question.
- Answer leads with Yes or No, then the justification.
"""


def create_causal_reasoning_prompt():
    prompt = """
Write a cause-and-effect exercise over the CONTEXT series: a multiple-choice question asking what explains — or what would follow from — the behavior the series shows.

Guidelines:
- Draw from these angles: identifying a cause, predicting an effect, explaining an anomaly, reading a temporal relationship between series.
- Keep raw series specifics (exact points, exact magnitudes) out of the question.
- The answer names the chosen option and argues for it.

Sample:
Question: The metric climbs steadily through the window. Which story fits best: a memory leak, a scheduled restart, or a traffic lull?
Answer: A memory leak — a slow monotone climb matches gradual accumulation, while a restart would reset the level and a lull would lower it.
"""
    return prompt, """
- Multiple-choice cause/effect question.
- Angles: cause identification, effect prediction, anomaly explanation, temporal correlation.
- Answer gives the option plus the reasoning.
"""


MUTATION_BUILDERS = [
    create_situation_prompt,
    create_constraints_prompt,
    create_deepen_prompt,
    create_concretizing_prompt,
    create_complex_reasoning_prompt,
    create_deductive_reasoning_prompt,
    create_causal_reasoning_prompt,
]


def create_comparison_prompt(before: str, after: str) -> str:
    return COMPARISON_INSTRUCTION.replace("<FIRST>", before).replace(
        "<SECOND>", after
    )


# ---------------------------------------------------------------------------
# EvolPrompt state machine (reference: evol_prompt.py:174-261)
# ---------------------------------------------------------------------------


class EvolPrompt:
    def __init__(
        self,
        ts_idx: int,
        seed_q: str,
        seed_a: str,
        seed_fields: Dict[str, List[int]],
        instruction: str,
        timeseries,
        attribute_pool: List[dict],
        metrics: List[str],
        corr_pool: Sequence,
        rng: Optional[np.random.Generator] = None,
    ):
        self.ts_idx = ts_idx
        self.timeseries = timeseries
        self.attribute_pool = attribute_pool
        self.instruction = instruction
        self.metrics = metrics
        self.corr_pool = list(corr_pool)
        self.rng = rng or np.random.default_rng()

        n = len(timeseries)
        self.all_fields = {
            "trend": list(range(n)),
            "seasonal": list(range(n)),
            "noise": list(range(n)),
            "local": list(range(n)),
            "statistic": list(range(n)),
            "correlation": list(range(len(self.corr_pool))),
        }
        self.fields: Dict[str, List[int]] = {
            k: list(v) for k, v in seed_fields.items()
        }
        self.qa_history: List[Tuple[str, str]] = [(seed_q, seed_a)]

    def evol(self) -> None:
        """Unlock one not-yet-covered (field, series) pair
        (reference: evol_prompt.py:187-201)."""
        diff = {}
        for field, candidates in self.all_fields.items():
            if field not in self.fields:
                if candidates:
                    diff[field] = candidates
            else:
                remaining = sorted(set(candidates) - set(self.fields[field]))
                if remaining:
                    diff[field] = remaining
        if diff:
            field = str(self.rng.choice(sorted(diff.keys())))
            self.fields.setdefault(field, [])
            self.fields[field].append(int(self.rng.choice(diff[field])))

    def push(self, q: str, a: str) -> None:
        self.qa_history.append((q, a))
        if len(self.qa_history) > 2:
            self.qa_history.pop(0)

    def generate_prompt(self) -> str:
        builder = MUTATION_BUILDERS[int(self.rng.integers(0, len(MUTATION_BUILDERS)))]
        prompt, question_format = builder()
        given_qa = json.dumps(
            {"question": self.qa_history[-1][0], "answer": self.qa_history[-1][1]}
        )
        context = attribute_prompt(
            self.timeseries, self.attribute_pool, self.metrics, self.fields,
            self.corr_pool,
        )
        return (
            f"{prompt}\n\n#Context#\n{context}\n\n#Constraints#\n"
            f"{CONSTRAINTS_INSTRUCTION}\n\n#The Given Q&A#\n{given_qa}\n\n"
            f"#Question Format#\n{question_format}\n\n#Generated Q&A#:"
        )

    def generate_comparison_prompt(self, q: str, a: str) -> str:
        given_qa = json.dumps(
            {"question": self.qa_history[-1][0], "answer": self.qa_history[-1][1]}
        )
        generated_qa = json.dumps({"question": q, "answer": a})
        context = attribute_prompt(
            self.timeseries, self.attribute_pool, self.metrics, self.fields,
            self.corr_pool,
        )
        return (
            f"#Context#\n{context}\n\n#Your Task#\n"
            f"{create_comparison_prompt(given_qa, generated_qa)}"
        )

    def to_dataset(self) -> dict:
        ts = self.timeseries
        if isinstance(ts, np.ndarray):
            ts = ts.tolist()
        return {
            "input": self.instruction + " " + self.qa_history[-1][0],
            "output": self.qa_history[-1][1],
            "timeseries": ts,
            "ts_idx": self.ts_idx,
            "fields": sorted(self.fields),
        }

    def clone(self) -> "EvolPrompt":
        import copy

        new = EvolPrompt(
            self.ts_idx,
            self.qa_history[0][0],
            self.qa_history[0][1],
            {},
            self.instruction,
            self.timeseries,
            self.attribute_pool,
            self.metrics,
            self.corr_pool,
            rng=self.rng,
        )
        new.fields = copy.deepcopy(self.fields)
        new.qa_history = list(self.qa_history)
        return new
