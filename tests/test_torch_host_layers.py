"""The port's own copies of the host layers against the JAX package's, on the
same inputs made from a numpy seed: configuration, the time-series
encodings, the processor (with and without the native packer) and the
request metrics.  Everything here is host code in numpy and Python, so the
two must agree exactly."""
import dataclasses

import numpy as np
import pytest

from chatts_tpu.core import config as jconfig
from chatts_tpu.core import encoding as jencoding
from chatts_tpu.processor import processor as jprocessor
from chatts_tpu.utils import profiling as jprofiling
from chatts_tpu_torch.core import config as tconfig
from chatts_tpu_torch.core import encoding as tencoding
from chatts_tpu_torch.processor import processor as tprocessor
from chatts_tpu_torch.utils import native as tnative
from chatts_tpu_torch.utils import profiling as tprofiling
from tests.helpers import FakeTokenizer, random_series

HF_CONFIG = {
    "architectures": ["Qwen2TSForCausalLM"], "vocab_size": 152064, "hidden_size": 5120,
    "intermediate_size": 13824, "num_hidden_layers": 48, "num_attention_heads": 40,
    "num_key_value_heads": 8, "rms_norm_eps": 1e-5, "rope_theta": 1e6,
    "ts_token_start_index": 151665,
    "ts": {"patch_size": 16, "num_layers": 5, "hidden_size": 5120, "max_length": 2048},
}

# Each case builds one configuration with the given module's own classes.
CONFIG_CASES = {
    "tiny": lambda m: m.tiny_config(),
    "tiny_qwen3_position_idx": lambda m: m.tiny_config(
        qwen3=True, hidden_size=96, num_attention_heads=6, use_position_idx=True),
    "tiny_position_embedding": lambda m: m.tiny_config(
        use_position_embedding=True, patch_size=8, max_sequence_length=128),
    "from_hf_dict": lambda m: m.ChatTSConfig.from_hf_dict(HF_CONFIG),
    "qwen3_from_hf_dict": lambda m: m.QwenConfig.from_hf_dict(
        dict(HF_CONFIG, architectures=["Qwen3ForCausalLM"], head_dim=128)),
    "ts_from_dict": lambda m: m.TSEncoderConfig.from_dict(
        {"patch_size": 8, "num_layers": 3, "hidden_size": 64, "max_sequence_length": 1000,
         "use_position_embedding": True, "embedding_dim": 4}),
    "generation": lambda m: m.GenerationConfig(max_new_tokens=7, top_k=5,
                                               eos_token_ids=(1, 2)),
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_torch_config_matches_jax(case):
    want = CONFIG_CASES[case](jconfig)
    got = CONFIG_CASES[case](tconfig)
    assert type(got).__module__ == "chatts_tpu_torch.core.config"
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("num_kv_groups", "padding_idx", "mlp_input_size", "max_patches",
                 "ts_end_token_index"):
        if hasattr(want, prop):
            assert getattr(got, prop) == getattr(want, prop)


@pytest.mark.parametrize("method", ["sp", "minmax_scale", "no"])
def test_torch_encoding_matches_jax(method):
    rng = np.random.default_rng(3)
    cases = [random_series(rng, 100), rng.normal(0.0, 0.5, 17), np.full(5, 2.5),
             random_series(rng, 1, scale=100.0)]
    for ts in cases:
        want = jencoding.timeseries_encoding(ts, method)
        got = tencoding.timeseries_encoding(ts, method)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    for n in (1, 15, 16, 17, 4096):
        assert tencoding.num_patches(n, 16) == jencoding.num_patches(n, 16)
    with pytest.raises(NotImplementedError):
        tencoding.timeseries_encoding(cases[0], "nope")


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("spec", [
    dict(series=[[30], [5, 64], [1]], kw={}),
    dict(series=[[], [200, 3]], kw=dict(pad_to_bucket=False)),
    dict(series=[[64], [17]], kw=dict(pad_tokens_to=256)),
], ids=["buckets", "no_bucket", "pinned_width"])
def test_torch_processor_matches_jax(use_native, spec):
    """Every array and list of ``ProcessedBatch`` is equal."""
    rng = np.random.default_rng(len(spec["series"]))
    texts, series = [], []
    for i, lengths in enumerate(spec["series"]):
        holes = " ".join("<ts><ts/>" for _ in lengths)
        texts.append(f"row {i} look at {holes} and say " + "w " * int(rng.integers(1, 30)))
        series.extend(random_series(rng, n) for n in lengths)
    kw = dict(vocab_size=512, hidden_size=64, patch_size=4, max_sequence_length=256)
    want = jprocessor.ChatTSProcessor(FakeTokenizer(), jconfig.tiny_config(**kw))(
        texts, series, use_native=use_native, **spec["kw"])
    got = tprocessor.ChatTSProcessor(FakeTokenizer(), tconfig.tiny_config(**kw))(
        texts, series, use_native=use_native, **spec["kw"])
    assert type(got).__module__ == "chatts_tpu_torch.processor.processor"
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name


def test_torch_native_packer_matches_numpy():
    """The port's C++ scatter-map builder gives the numpy path's map (where
    g++ is present; without it the processor takes the numpy path)."""
    if tnative.get_lib() is None:
        pytest.skip("no g++: the processor takes its numpy path")
    proc = tprocessor.ChatTSProcessor(FakeTokenizer(), tconfig.tiny_config(patch_size=4))
    rng = np.random.default_rng(9)
    texts = ["a <ts><ts/> b <ts><ts/>", "c <ts><ts/>"]
    series = [random_series(rng, n) for n in (9, 40, 3)]
    native, plain = (proc(texts, series, use_native=u) for u in (True, False))
    np.testing.assert_array_equal(native.scatter_seq, plain.scatter_seq)
    np.testing.assert_array_equal(native.scatter_tok, plain.scatter_tok)


@pytest.mark.parametrize("n_records", [0, 1, 7], ids=["empty", "one", "seven"])
def test_torch_metrics_match_jax(n_records):
    rng = np.random.default_rng(n_records)
    want, got = jprofiling.MetricsAggregator(max_records=5), tprofiling.MetricsAggregator(
        max_records=5)
    for _ in range(n_records):
        rec = dict(ttft_s=float(rng.uniform(0.01, 2)), tpot_s=float(rng.uniform(0.01, 0.1)),
                   prompt_tokens=int(rng.integers(1, 900)),
                   output_tokens=int(rng.integers(1, 64)), total_s=float(rng.uniform(1, 9)))
        want.record(**rec)
        got.record(**rec)
    assert got.summary() == want.summary()
