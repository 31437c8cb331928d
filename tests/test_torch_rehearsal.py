"""The published-checkpoint user path on the port at tiny scale:
``chatts_tpu_torch/scripts/rehearse_real_checkpoint.py`` synthesizes an
AutoGPTQ-v1 directory (sharded safetensors with an index, packed
projections, fp16 tensors, the remote-code ``ts.*`` naming) and drives
diagnose -> load (bits 4) -> greedy tokens twice, equal -- the flow
``chip_smoke.py`` phase 7 runs at the 14B widths on the card.

The JAX package's loader reads the port's directories too, and its model
must equal the port's to the bit (the int4 bytes, scales, zeros and
permutations among them): that checks the writer."""
import jax
import numpy as np
import pytest
import torch

from chatts_tpu.models import weights as jweights
from chatts_tpu_torch.models import weights
from chatts_tpu_torch.models.convert import from_jax_params
from chatts_tpu_torch.scripts import rehearse_real_checkpoint as rehearsal
from chatts_tpu_torch.utils import safetensors_io as io

STYLES = {"sym": {}, "desc_act": {"desc_act": True}, "asym": {"asym": True},
          "asym_desc_act": {"asym": True, "desc_act": True}}


@pytest.mark.parametrize("style", list(STYLES))
def test_torch_rehearsal_tiny(tmp_path, style, monkeypatch):
    # Small shards, so the tiny directory has several and an index.
    monkeypatch.setattr(rehearsal, "SHARD_BYTES", 200_000)
    info = rehearsal.synthesize(str(tmp_path), shape="tiny", device="cpu", seed=3,
                                **STYLES[style])
    assert info["shards"] > 1 and (tmp_path / io.INDEX_NAME).exists()
    assert info["config"]["quantization_config"]["sym"] == ("asym" not in style)
    tokens = rehearsal.rehearse(str(tmp_path), device="cpu", log=lambda _: None)
    assert len(tokens[0]) == 4

    report = weights.diagnose(str(tmp_path))
    assert report.ok and report.unused == () and report.gptq_projections == 2 * 7
    cfg, model = weights.load_checkpoint(str(tmp_path), device="cpu", quantize_bits=4)
    q = model.llm.layers[1].self_attn.q_proj
    assert q.kernel_q4 is not None
    assert (q.perm4 is not None) == ("desc_act" in style)
    assert (q.zeros4 is not None) == ("asym" in style)

    # The JAX loader reads the port's directory to the same model.
    _, jparams = jweights.load_checkpoint(str(tmp_path), quantize_bits=4)
    want = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    got = dict(model.named_parameters()) | dict(model.named_buffers())
    ref = dict(want.named_parameters()) | dict(want.named_buffers())
    assert set(got) == set(ref)
    for name, t in ref.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name


def test_torch_rehearsal_seeds_and_layers(tmp_path):
    """The same seed writes the same bytes; ``num_layers`` cuts the depth."""
    a = rehearsal.synthesize(str(tmp_path / "a"), shape="tiny", device="cpu", num_layers=1)
    rehearsal.synthesize(str(tmp_path / "b"), shape="tiny", device="cpu", num_layers=1)
    assert a["config"]["num_hidden_layers"] == 1
    shard = "model-00001.safetensors"
    with io.SafetensorsFile(str(tmp_path / "a" / shard)) as fa, \
            io.SafetensorsFile(str(tmp_path / "b" / shard)) as fb:
        assert set(fa.keys()) == set(fb.keys())
        for name in fa.keys():
            assert torch.equal(fa.get(name), fb.get(name)), name


def test_torch_rehearsal_command_line(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    assert rehearsal.main(["--tiny", "--device", "cpu", "--asym", "--dir", str(ckpt)]) == 0
    assert "REHEARSAL OK" in capsys.readouterr().out
    assert not ckpt.exists()  # removed unless --keep
