"""Generate the six alignment datasets with the port.

The counterpart of ``scripts/generate_align_datasets.sh``: the same stages in
the same order, on the same environment variables:

    DATA_OUTPUT_DIR=data NUM_DATA=100 SEED=0 \\
        python -m chatts_tpu_torch.scripts.generate_align_datasets

The template stages (uts_template_qa, mts_shape_template_qa,
mts_local_template_qa) need no LLM. The LLM stages (uts_llm_qa,
mts_local_llm_qa, mts_shape_llm_qa) send their prompts to the
OpenAI-compatible endpoint at ``CHATTS_LLM_URL`` (for example
``python -m chatts_tpu_torch.examples.serve_openai``), all of them to the
same client. Without it each stage answers from the dryrun engine with the
canned answer the shell script's stage gets, so the files equal the shell
script's. (The shell script runs uts_llm_qa through its module's main, which
always builds a dryrun client: there ``CHATTS_LLM_URL`` does not reach that
stage.)
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional, Sequence

from chatts_tpu_torch.utils.llm_client import LLMClient

HOLE_ANSWER = "This is a test answer."


def add_common_args(parser: argparse.ArgumentParser, num_data: int) -> None:
    parser.add_argument("--output-dir", default=os.environ.get("DATA_OUTPUT_DIR", "data"))
    parser.add_argument("--num-data", type=int,
                        default=int(os.environ.get("NUM_DATA", str(num_data))))
    parser.add_argument("--seed", type=int, default=int(os.environ.get("SEED", "0")))
    parser.add_argument("--llm-url", default=os.environ.get("CHATTS_LLM_URL"),
                        help="OpenAI-compatible endpoint for the LLM stages "
                             "(default: CHATTS_LLM_URL; dryrun when unset)")
    parser.add_argument("--llm-timeout", type=float, default=60.0,
                        help="seconds a request to the endpoint may take before the "
                             "client sends it again; raise it above the server's queue "
                             "wait plus one answer")


def stage_clients(llm_client: Optional[LLMClient], url: Optional[str],
                  timeout_s: float = 60.0) -> Callable[[str], LLMClient]:
    """``client(dryrun_output)`` for an LLM stage: the caller's client, else
    one OpenAI client at ``url`` shared by every stage, else a dryrun client
    answering ``dryrun_output``."""
    if llm_client is None and url:
        from chatts_tpu_torch.eval.openai_client import OpenAIClient

        llm_client = LLMClient(engine="openai", openai_client=OpenAIClient(
            base_url=url, timeout_s=timeout_s))
    if llm_client is not None:
        return lambda dryrun_output: llm_client
    return lambda dryrun_output: LLMClient(engine="dryrun", dryrun_sleep_s=0.0,
                                           dryrun_output=dryrun_output)


class Stages:
    """Times each stage and records the rows it wrote, printing one line a
    stage as the shell scripts do."""

    def __init__(self):
        self.report: Dict[str, dict] = {}

    def run(self, name: str, fn: Callable[[], int]) -> int:
        t0 = time.perf_counter()
        rows = fn()
        self.report[name] = {"rows": rows, "seconds": time.perf_counter() - t0}
        print(f"{name}: {rows} rows")
        return rows


def main(argv: Optional[Sequence[str]] = None,
         llm_client: Optional[LLMClient] = None) -> Dict[str, dict]:
    """Write the six datasets; returns ``{stage: {"rows", "seconds"}}``.
    ``llm_client`` replaces the endpoint for every LLM stage."""
    from chatts_tpu_torch.datagen.align import (mts_local_template_qa,
                                                mts_shape_template_qa, uts_llm_qa,
                                                uts_template_qa)
    from chatts_tpu_torch.datagen.align.mts_llm_qa import (MTSLocalLLMQAGenerator,
                                                           MTSShapeLLMQAGenerator,
                                                           write_outputs)

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(parser, num_data=100)
    args = parser.parse_args(argv)
    out, num, seed = args.output_dir, args.num_data, args.seed
    client = stage_clients(llm_client, args.llm_url, args.llm_timeout)
    stages = Stages()

    for name, module in (("uts_template_qa", uts_template_qa),
                         ("mts_shape_template_qa", mts_shape_template_qa),
                         ("mts_local_template_qa", mts_local_template_qa)):
        stages.run(name, lambda m=module, n=name: m.main(f"{out}/{n}.jsonl", num, seed))
    stages.run("uts_llm_qa", lambda: uts_llm_qa.main(
        f"{out}/uts_llm_qa.jsonl", f"{out}/labels/uts_llm_qa.json",
        f"{out}/evol_labels/uts_llm_qa.json", num, seed,
        llm_client=client(HOLE_ANSWER)))
    for name, gen_cls in (("mts_local_llm_qa", MTSLocalLLMQAGenerator),
                          ("mts_shape_llm_qa", MTSShapeLLMQAGenerator)):
        def stage(name=name, gen_cls=gen_cls):
            rows, evol_labels, labels = gen_cls(seed=seed).generate_dataset(
                num, client(HOLE_ANSWER))
            return write_outputs(rows, evol_labels, labels, f"{out}/{name}.jsonl",
                                 f"{out}/evol_labels/{name}.json",
                                 f"{out}/labels/{name}.json")
        stages.run(name, stage)
    print(f"alignment datasets written to {out}/")
    return stages.report


if __name__ == "__main__":
    main()
