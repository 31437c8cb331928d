"""The PyTorch port imports without JAX, without the JAX package, without
the safetensors, transformers, optax, orbax, yaml and matplotlib packages and
without CUDA, and chip_smoke.py refuses to run where there is no card or no
checkout."""
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import chatts_tpu_torch
names = ["chatts_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(chatts_tpu_torch.__path__, "chatts_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({
    "modules": names,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "jax_package": sorted(m for m in sys.modules
                          if m == "chatts_tpu" or m.startswith("chatts_tpu.")),
    "loader_packages": sorted(m for m in sys.modules
                              if m.split(".")[0] in ("safetensors", "transformers")),
    "training_packages": sorted(m for m in sys.modules
                                if m.split(".")[0] in ("optax", "orbax")),
    "optional_packages": sorted(m for m in sys.modules
                                if m.split(".")[0] in ("yaml", "matplotlib")),
}))
"""


def _run(args, cwd, timeout=120):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout)


def test_torch_port_imports_without_jax():
    proc = _run(["-c", _IMPORT_ALL], REPO)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["jax"] == []
    assert report["jax_package"] == []
    # The loader reads safetensors itself; transformers loads only for a
    # checkpoint's tokenizer.
    assert report["loader_packages"] == []
    # Training runs on torch.optim and torch.save, its adapters on the port's
    # own safetensors reader.
    assert report["training_packages"] == []
    # The eval harness and datagen load yaml and matplotlib only inside the
    # functions that need them (the card's machine has neither).
    assert report["optional_packages"] == []
    # Every kernel module and its build/loader imported on a host without CUDA.
    for name in ("chatts_tpu_torch.kernels.build", "chatts_tpu_torch.ops.flash_attention",
                 "chatts_tpu_torch.ops.ragged_decode_attention",
                 "chatts_tpu_torch.ops.int4_matmul", "chatts_tpu_torch.runtime.engine",
                 "chatts_tpu_torch.models.convert", "chatts_tpu_torch.core.config",
                 "chatts_tpu_torch.core.encoding", "chatts_tpu_torch.processor.processor",
                 "chatts_tpu_torch.utils.native", "chatts_tpu_torch.utils.profiling",
                 "chatts_tpu_torch.serve.scheduler", "chatts_tpu_torch.serve.server",
                 "chatts_tpu_torch.utils.safetensors_io", "chatts_tpu_torch.models.gptq",
                 "chatts_tpu_torch.models.weights", "chatts_tpu_torch.utils.json_utils",
                 "chatts_tpu_torch.utils.llm_client", "chatts_tpu_torch.serve.stream_qa",
                 "chatts_tpu_torch.examples.quickstart", "chatts_tpu_torch.examples.serve_openai",
                 "chatts_tpu_torch.scripts.rehearse_real_checkpoint",
                 "chatts_tpu_torch.train.loss", "chatts_tpu_torch.train.data",
                 "chatts_tpu_torch.train.lora", "chatts_tpu_torch.train.train_step",
                 "chatts_tpu_torch.train.peft_io", "chatts_tpu_torch.train.sft_driver",
                 "chatts_tpu_torch.datagen.config", "chatts_tpu_torch.datagen.trends",
                 "chatts_tpu_torch.datagen.changes", "chatts_tpu_torch.datagen.generator",
                 "chatts_tpu_torch.datagen.align.mts_local_template_qa",
                 "chatts_tpu_torch.eval.scorers", "chatts_tpu_torch.eval.inference",
                 "chatts_tpu_torch.eval.make_eval_dataset",
                 "chatts_tpu_torch.eval.openai_client", "chatts_tpu_torch.eval.ragas_judge",
                 "chatts_tpu_torch.eval.judge_config", "chatts_tpu_torch.eval.ts_tools",
                 "chatts_tpu_torch.eval.train_rocket_tsc", "chatts_tpu_torch.eval.react_agent",
                 "chatts_tpu_torch.eval.baselines", "chatts_tpu_torch.scripts.run_eval",
                 "chatts_tpu_torch.datagen.metric_catalog", "chatts_tpu_torch.datagen.metric_set",
                 "chatts_tpu_torch.datagen.seed_template_qa",
                 "chatts_tpu_torch.datagen.align.uts_template_qa",
                 "chatts_tpu_torch.datagen.align.mts_shape_template_qa",
                 "chatts_tpu_torch.datagen.align.uts_llm_qa",
                 "chatts_tpu_torch.datagen.align.mts_llm_qa", "chatts_tpu_torch.datagen.sft",
                 "chatts_tpu_torch.datagen.sft.evol", "chatts_tpu_torch.datagen.sft.tsevol",
                 "chatts_tpu_torch.datagen.sft.rewrite",
                 "chatts_tpu_torch.datagen.sft.generate_llm_qa",
                 "chatts_tpu_torch.datagen.sft.generate_ift_dataset",
                 "chatts_tpu_torch.datagen.sft.reason",
                 "chatts_tpu_torch.scripts.generate_align_datasets",
                 "chatts_tpu_torch.scripts.generate_sft_datasets",
                 "chatts_tpu_torch.examples.demo_ts_generator"):
        assert name in report["modules"]


def test_torch_chip_smoke_fails_without_a_card():
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_torch_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
