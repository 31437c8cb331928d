"""Generate the SFT dataset family with the port.

The counterpart of ``scripts/generate_sft_datasets.sh``: seed LLM QA, seed
template QA, TSEvol over the seed files present, IFT over the alignment label
files present, and the three reasoning sets (uts, mts, uts in Chinese), in
that order, on the same environment variables:

    DATA_OUTPUT_DIR=data NUM_DATA=50 SEED=0 \\
        python -m chatts_tpu_torch.scripts.generate_sft_datasets

Run ``generate_align_datasets`` into the same directory first: TSEvol and IFT
read its files. The LLM stages send their prompts to ``CHATTS_LLM_URL``, all
to one client; without it each answers from the dryrun engine with the canned
answer the shell script's stage gets. (The shell script runs the seed LLM QA
through its module's main, which always builds a dryrun client.)
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

from chatts_tpu_torch.scripts.generate_align_datasets import (Stages, add_common_args,
                                                              stage_clients)
from chatts_tpu_torch.utils.llm_client import LLMClient

LLM_QA_ANSWER = ('[{"question": "This is a test question.", '
                 '"answer": "This is a test answer."}]')
JSON_ANSWER = json.dumps([{"question": "Test?", "answer": "Test."}])


def main(argv: Optional[Sequence[str]] = None,
         llm_client: Optional[LLMClient] = None) -> Dict[str, dict]:
    """Write the SFT datasets; returns ``{stage: {"rows", "seconds"}}``.
    ``llm_client`` replaces the endpoint for every LLM stage."""
    from chatts_tpu_torch.datagen import seed_template_qa
    from chatts_tpu_torch.datagen.sft import generate_llm_qa
    from chatts_tpu_torch.datagen.sft.generate_ift_dataset import generate_dataset as ift
    from chatts_tpu_torch.datagen.sft.reason import (MTSReasonGenerator,
                                                     UTSReasonGenerator, write_dataset)
    from chatts_tpu_torch.datagen.sft.tsevol import evol_instruct

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(parser, num_data=50)
    args = parser.parse_args(argv)
    out, num, seed = args.output_dir, args.num_data, args.seed
    client = stage_clients(llm_client, args.llm_url, args.llm_timeout)
    stages = Stages()

    stages.run("llm_qa", lambda: generate_llm_qa.main(
        f"{out}/llm_qa.jsonl", f"{out}/evol_labels/llm_qa.json", num, seed,
        llm_client=client(LLM_QA_ANSWER)))
    stages.run("seed_template_qa", lambda: seed_template_qa.main(
        f"{out}/seed_template_qa.jsonl", f"{out}/evol_labels/seed_template_qa.json",
        num, seed))

    seeds = []
    for name in ("llm_qa", "uts_llm_qa", "mts_local_llm_qa", "mts_shape_llm_qa"):
        ds, lb = f"{out}/{name}.jsonl", f"{out}/evol_labels/{name}.json"
        if os.path.exists(ds) and os.path.exists(lb):
            seeds.append((ds, lb))
    if seeds:
        stages.run("tsevol", lambda: len(evol_instruct(
            seeds, f"{out}/evol.jsonl", num, client(JSON_ANSWER), seed)))

    label_files = []
    for name, kind in (("uts_llm_qa", "uts"), ("mts_local_llm_qa", "local"),
                       ("mts_shape_llm_qa", "shape")):
        p = f"{out}/labels/{name}.json"
        if os.path.exists(p):
            label_files.append((p, kind))
    if label_files:
        stages.run("ift", lambda: ift(label_files, num, f"{out}/ift.jsonl", seed))

    for name, gen, cnt in (
            ("uts_reason", lambda: UTSReasonGenerator(seed=seed), max(num // 5, 2)),
            ("mts_reason", lambda: MTSReasonGenerator(seed=seed), max(num // 5, 2)),
            ("uts_reason_cn", lambda: UTSReasonGenerator(seed=seed, chinese=True),
             max(num // 10, 1))):
        def stage(name=name, gen=gen, cnt=cnt):
            rows, labels = gen().generate_dataset(cnt, client(JSON_ANSWER))
            return write_dataset(rows, labels, f"{out}/{name}.jsonl",
                                 f"{out}/evol_labels/{name}.json")
        stages.run(name, stage)
    print(f"sft datasets written to {out}/")
    return stages.report


if __name__ == "__main__":
    main()
