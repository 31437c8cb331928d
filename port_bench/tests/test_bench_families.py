"""Decoder families (``families/<family>.py``), on the CPU.

The Qwen family holds what the harness knew of the Qwen decoder before
families existed: its draws, its reference, its FLOPs and its launch bounds
are pinned here to values recorded from the benchmark as it was then, so
that the two benchmarked cells read the same numbers.  A family that only
the fixture has (``tests/fixture/port_bench/families/tied.py``) runs a cell
added by files and entries alone."""
import hashlib
import json
import os
import shutil
import time
import types

import numpy as np
import pytest
import torch

from port_bench import check, flops, harness, readers, trace
from port_bench.cells import Bench
from port_bench.reference import model as ref_model
from port_bench.reference import processor as ref_processor

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixture")
ROOT = os.path.dirname(os.path.dirname(HERE))
SEED = 2**31 + 11
QWEN = Bench(ROOT).family("qwen")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def config(bench_root, name):
    with open(os.path.join(bench_root, "port_bench", "configs", name + ".json")) as f:
        return json.load(f)


# -- the Qwen family reads what the benchmark read before families --------------

# SHA-256 of each tensor's bytes, the fixture's tiny configuration at SEED on
# the CPU, recorded from the benchmark before families existed
# (``weights.make``).
PARENT_DIGESTS = {
    "qkv.q4": "56af2c6b0bdf16b41ed8885b352f6192cfdeb0d531540cf0b698ec8675eb5b82",
    "qkv.s4": "f33b856c2084d56ef88f309e3a83627cdc70eeca6c75559a9bccb1a86ed1fec2",
    "o.q4": "b8c3e10d5999ace59e11681429af21b6cb2bd7e277775d05b86e5fdea1a1da9e",
    "o.s4": "04b88709b1647bbc3ff352dfc3b10d0f10d39d91889a460b01fdb81d69894637",
    "gate_up.q4": "1aced7798dbe5d8b05649fcfcfa355ac0134a48448669b4b5cd56d9c88b91fba",
    "gate_up.s4": "a9bbfe914cb88b0c71a8a47bd6739bbcc60f1b413ecadd4f938258dfe2cc74fa",
    "down.q4": "801bbe1edf005acc3c534628a659684515a25da815185320ba2e191fcd0d93e7",
    "down.s4": "99ae17c8e4cf47cb123a7ccba5e738c01d7c3a508cd89ca540eb20e23265da1c",
    "q_norm": "3e8ea726727156e59bcf5623b1bd3f460b251fae9cf4a346fd02619bebfc182f",
    "k_norm": "0dab46b466f73f7a976f3753dbbe69a660518d60014818c4498577784bb91afe",
    "ln1": "b41534c6c943ce1e7d00caeb63a2d826dd095db0437c5b7c7672a2427dfced62",
    "ln2": "a36065abe7e847c14a28e839fa001ede6282bc87309c162085affbe35fa9b753",
    "norm": "195b7372425a76475382c1f4278ec3f88e2daee0e4e4a5305002e487ff9fe726",
    "embed": "68e12f7574adc98211e373f9f1db362b86958112a55d4d5292a2de36f5e4bb5c",
    "head.q4": "c75444be3149fe68c7a419a084a6a442c2aa977bf0ba8c0817c73d62ee0f758d",
    "head.s4": "f88d7ebef9913cbbaa57b717abb69885904f05d165b0a37d86eccd92118f7106",
    "ts.0.kernel": "7a46b475afb2933ebf9ed98b89397517b78022237e3ddf543314f15b58cacccc",
    "ts.0.bias": "82575905c0d88fe25fb41e04144369a563ae170c7bf3c4c4250187f2bac7b137",
    "ts.1.kernel": "7fb61c20ef26b156f18ee377832f9e75618a94f3bca8aa36bee668c4924bccfa",
    "ts.1.bias": "84d49e1c510908d12315aa738b9866e3d017de2a6825d7ef719be19b77f2f170",
}

# The reference's logits of one two-series sequence at its last 4 positions,
# recorded as PARENT_DIGESTS were (``reference/model.py::logits``): every
# 64th column, each row's sum and argmax; the float8 control beside them.
PARENT_LOGITS = {
    False: dict(
        cols=[[1.8781298398971558, -0.613568127155304, -0.25411292910575867, -0.5366435647010803,
               -0.28758788108825684, 0.8095170855522156, 0.11002013087272644,
               0.024575140327215195],
              [0.5138049125671387, 0.09060721099376678, 0.47165924310684204, -1.3252121210098267,
               -0.0745575800538063, 0.6893137097358704, -0.6890900135040283, 0.0788714736700058],
              [-0.74567711353302, 0.8993926644325256, -0.22105257213115692, -0.48990991711616516,
               0.0066039953380823135, 0.9657718539237976, -0.45105740427970886,
               0.8975356221199036],
              [-1.0750012397766113, -0.24702613055706024, -0.06319605559110641,
               1.2368507385253906, 0.503260612487793, -2.0546603202819824, -0.25821882486343384,
               -0.2918725311756134]],
        sums=[2.2835781574249268, 6.044519424438477, 6.019468784332275, -17.28240203857422],
        argmax=[227, 115, 277, 367]),
    True: dict(
        cols=[[1.759623408317566, -0.5932459235191345, -0.22958418726921082, -0.5754645466804504,
               -0.3055209815502167, 0.7694625854492188, 0.05954449251294136, 0.02288365550339222],
              [0.483122318983078, 0.024008143693208694, 0.46286383271217346, -1.3296221494674683,
               -0.05533239617943764, 0.7168688774108887, -0.7083523869514465,
               0.11810846626758575],
              [-0.7778199315071106, 0.8425796627998352, -0.20714104175567627, -0.4099618196487427,
               0.004972704686224461, 0.9694669246673584, -0.48682770133018494,
               0.9000434875488281],
              [-1.0387600660324097, -0.276572048664093, -0.09430680423974991, 1.256247639656067,
               0.48279306292533875, -2.123396158218384, -0.2743167579174042,
               -0.23571009933948517]],
        sums=[1.1282305717468262, 5.895073890686035, 6.178535461425781, -16.220495223999023],
        argmax=[227, 282, 19, 367]),
}

# (time, FLOPs) of each delivery of three requests, recorded as above
# (``flops.request_flops``): a prompt of 10 tokens delivered 1 and 2 tokens,
# one of 777 delivered 3, 32 and 1, one of 2,048 delivered 1.
REQUESTS = ((10, [(1.0, 1), (2.0, 2)]), (777, [(0.5, 3), (0.75, 32), (1.5, 1)]),
            (2048, [(3.0, 1)]))
PARENT_FLOPS = {
    "chatts-14b-int4": [[(1.0, 265852354560.0), (2.0, 55985111040.0)],
                        [(0.5, 20887714529280.0), (0.75, 920424284160.0), (1.5, 28779479040.0)],
                        [(3.0, 56180736000000.0)]],
    "qwen3-8b-ts-int4": [[(1.0, 140192448512.0), (2.0, 30285955072.0)],
                         [(0.5, 11004434055168.0), (0.75, 499372785664.0),
                          (1.5, 15615131648.0)],
                         [(3.0, 29688662589440.0)]],
    "tiny": [[(1.0, 6085632.0), (2.0, 1465344.0)],
             [(0.5, 770967552.0), (0.75, 49135616.0), (1.5, 1552384.0)],
             [(3.0, 3356622848.0)]],
}

# The traced run's summary of the launches in ``_launch_scenario``, recorded
# as above through the tracer that knew the Qwen kernels itself.
PARENT_SUMMARY = {
    "window_s": 0.01, "busy_s": 0.00039075,
    "by_kernel": {"void int4_mma_kernel<2>": 0.00025049999999999996,
                  "int4_splitk_reduce_kernel<float>": 1.225e-05,
                  "flash_mma_kernel<2>": 7.999999999999999e-05,
                  "other_kernel": 3.2999999999999996e-05,
                  "Memcpy HtoD": 4.9999999999999996e-06,
                  "void int4_mma_kernel<4>": 9.999999999999999e-06},
    "gaps": [["admit", 0.008235], ["host", 0.0010999999999999998],
             ["host", 0.00011999999999999999], ["host", 8.774999999999999e-05],
             ["fetch", 4.95e-05], ["admit", 1.7e-05]],
    "int4_device_s": 0.00027275, "int4_bound_s": 0.013368659766299987, "int4_calls": 498,
    "flash_device_s": 7.999999999999999e-05, "flash_bound_s": 0.0025257742769750845,
    "flash_calls": 289, "flash_unknown": 1, "graph_replays": {"decode": 96, "mixed": 8},
}


def _tiny_weights():
    return QWEN.make(config(FIXTURE, "tiny"), SEED, "cpu")


def test_qwen_draws_are_the_parents():
    w = _tiny_weights()
    got = {k: hashlib.sha256(v.contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()
           for k, v in w.items()}
    assert list(got) == list(PARENT_DIGESTS)
    assert got == PARENT_DIGESTS


@pytest.mark.parametrize("lowered", [False, True])
def test_qwen_reference_logits_are_the_parents(lowered):
    # f32 on the CPU at 2 threads repeats to the bit; 1e-6 is far under the
    # cells' limits of 0.14 and 0.15.
    cfg = config(FIXTURE, "tiny")
    prompt = "Compare the load <ts><ts/> with the latency <ts><ts/> and say which rose."
    series = [np.sin(np.arange(40) / 5.0) * 3.0 + 1.0, np.cos(np.arange(70) / 9.0) * 50.0 - 7.0]
    ids, values, starts = ref_processor.encode(prompt, series, cfg["ts"]["patch_size"],
                                               cfg["ts_token_start_index"])
    assert len(ids) == 30
    seq = ref_model.Sequence_(ids, values, starts, range(len(ids) - 4, len(ids)))
    lg = QWEN.logits(cfg, _tiny_weights(), [seq], lowered=lowered)[0]
    want = PARENT_LOGITS[lowered]
    assert lg.argmax(dim=1).tolist() == want["argmax"]
    torch.testing.assert_close(lg[:, ::64], torch.tensor(want["cols"]), atol=1e-6, rtol=0)
    torch.testing.assert_close(lg.sum(dim=1), torch.tensor(want["sums"]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["chatts-14b-int4", "qwen3-8b-ts-int4", "tiny"])
def test_qwen_request_flops_are_the_parents(name):
    cfg = config(FIXTURE if name == "tiny" else ROOT, name)
    assert [QWEN.request_flops(cfg, p, puts) for p, puts in REQUESTS] == PARENT_FLOPS[name]


# -- the tracer, driven on the CPU ----------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


class _FakeProfiler:
    """Stands in for ``torch.profiler``: a trace of a few device events in a
    10 ms window whose host start maps to 1,000 us on the trace's clock."""

    def export_chrome_trace(self, path):
        events = [
            {"name": trace.SYNC, "ts": 1000.0, "ph": "X", "cat": "user_annotation", "dur": 1},
            {"name": "void int4_mma_kernel<2>", "cat": "kernel", "ts": 1100.0, "dur": 250.5},
            {"name": "int4_splitk_reduce_kernel<float>", "cat": "kernel", "ts": 1400.0,
             "dur": 12.25},
            {"name": "flash_mma_kernel<2>", "cat": "kernel", "ts": 1500.0, "dur": 80.0},
            {"name": "other_kernel", "cat": "kernel", "ts": 1700.0, "dur": 33.0},
            {"name": "Memcpy HtoD", "cat": "gpu_memcpy", "ts": 1750.0, "dur": 5.0},
            {"name": "void int4_mma_kernel<4>", "cat": "kernel", "ts": 9990.0, "dur": 40.0}]
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)


class _FakeEngine:
    """What ``Tracer.attach`` wraps, with a scan-sliced admission pending."""

    decode_chunk = 4

    def __init__(self, lengths, npt, o):
        self._pending_mixed = {"reqs": [types.SimpleNamespace(prompt_tokens=n) for n in lengths],
                               "npt": npt, "o": o, "mode": "mixed"}
        self._op_round = self._admit = self._complete_round = lambda *a: None
        self._dispatch_mixed = lambda: "dispatched"


def _launch_scenario(monkeypatch, family, cfg, launch):
    """Graphs captured and replayed, eager launches and two scan-sliced
    rounds through ``family``'s wrappers, then the trace read.  ``launch``
    makes the launches of one captured step or of eager calls."""
    from chatts_tpu_torch.serve import scheduler

    capturing = {"now": False}

    class Graph:
        def __init__(self, chunk_size, shapes):
            self.chunk_size = chunk_size
            capturing["now"] = True
            try:
                launch(shapes)
            finally:
                capturing["now"] = False

        def round(self):
            return "rounded"

    monkeypatch.setattr(scheduler, "_DecodeStepGraph", Graph)
    monkeypatch.setattr(scheduler, "_MixedStepGraph", Graph)
    monkeypatch.setattr(trace, "_capturing", lambda: capturing["now"])
    tracer = trace.Tracer(cfg, family)
    tracer.install()
    try:
        decode = scheduler._DecodeStepGraph(32, "decode")
        mixed = scheduler._MixedStepGraph(8, "mixed")
        decode.round()  # before the sub-window: not counted
        tracer.recording = True
        for _ in range(3):
            assert decode.round() == "rounded"
        mixed.round()
        launch("eager")
        for lengths, npt, o in (([2700, 1500, 900, 33], 512, 1024), ([600, 610], 128, 0)):
            engine = _FakeEngine(lengths, npt, o)
            tracer.attach(engine)
            assert engine._dispatch_mixed() == "dispatched"
        tracer.recording = False
        tracer._prof, tracer._sync, tracer.window = _FakeProfiler(), 0.001, (0.0, 0.01)
        tracer.phases = [(0.0012, 0.0014, "fetch"), (0.0016, 0.005, "admit")]
        return tracer.read()
    finally:
        tracer.uninstall()


def test_qwen_launch_bounds_and_replays_are_the_parents(monkeypatch):
    from chatts_tpu_torch.models import qwen

    # The port's entry points stubbed before the wrappers go in: a
    # launch's shapes are all the wrappers read.
    monkeypatch.setattr(qwen, "int4_matmul", lambda x, packed, scales, *a, **k: None)
    monkeypatch.setattr(qwen, "attention", lambda q, k, v, **kw: None)
    steps = {"decode": [(32, 4096, 6144), (32, 4096, 4096), (32, 4096, 24576),
                        (32, 12288, 4096), (32, 4096, 151936)],
             "mixed": [(200, 4096, 6144), (200, 12288, 4096)],
             "eager": [(4096, 4096, 6144), (1000, 12288, 4096)]}

    def launch(which):
        for r, i, o in steps[which]:
            qwen.int4_matmul(_meta(r, i), _meta(i // 2, o, dtype=torch.int8), None)
        if which != "eager":  # captured: counted by the mixed step's bound alone
            qwen.attention(_meta(1, 9, 4, 8), _meta(1, 9, 2, 8), _meta(1, 9, 2, 8),
                           impl="auto", kv_valid=torch.ones(1, 9, dtype=torch.bool))
            return
        valid = torch.zeros(3, 1024, dtype=torch.bool)
        for row, n in enumerate((1024, 700, 5)):
            valid[row, :n] = True
        qwen.attention(_meta(3, 1024, 32, 128), _meta(3, 1024, 8, 128),
                       _meta(3, 1024, 8, 128), impl="auto", kv_valid=valid)
        # a query span of another length than its keys: bound unknown
        qwen.attention(_meta(2, 1, 32, 128), _meta(2, 700, 8, 128), _meta(2, 700, 8, 128),
                       impl="auto", kv_valid=valid[:2, :700])

    cfg = {"num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
           "num_hidden_layers": 36}
    got = _launch_scenario(monkeypatch, QWEN, cfg, launch)
    assert json.loads(json.dumps({k: got[k] for k in PARENT_SUMMARY})) == PARENT_SUMMARY
    assert set(got) - set(PARENT_SUMMARY) == {"int4_unknown"} and got["int4_unknown"] == 0
    assert flops.int4_bound_s(32, 5120, 27648) == 2.307454089552239e-05


def test_a_new_kernel_key_is_counted_at_its_capture(monkeypatch):
    """A family's own kernel, launched inside a captured graph, counts at
    its capture's bound on each replay, and its roofline is read from the
    summary's flat keys."""
    port = types.SimpleNamespace(mla_decode=lambda n: None)

    def spies(tracer):
        inner = port.mla_decode

        def spy(n):
            tracer.launch("mla_decode", lambda m: 1e-6 * m, n)
            return inner(n)
        return [(port, "mla_decode", spy)]

    family = types.SimpleNamespace(KERNELS={"mla_decode": ("int4_mma_kernel",)}, spies=spies,
                                   mixed_launches=lambda cfg, engine: [])

    def launch(which):
        for n in {"decode": (2, 3), "mixed": (5,), "eager": (7,)}[which]:
            port.mla_decode(n)

    got = _launch_scenario(monkeypatch, family, {}, launch)
    # 3 decode replays of 32 steps of (2 + 3), 8 mixed steps of 5, one eager 7
    assert got["mla_decode_calls"] == 3 * 32 * 2 + 8 + 1
    assert got["mla_decode_bound_s"] == pytest.approx(1e-6 * (3 * 32 * 5 + 8 * 5 + 7))
    assert got["mla_decode_unknown"] == 0 and "int4_calls" not in got
    run = harness.RunRecord({}, {}, [], (0.0, 1.0), [], got, family)
    assert readers.roofline_pct(run, "mla_decode") == pytest.approx(
        100.0 * got["mla_decode_bound_s"] / got["mla_decode_device_s"])
    assert readers.roofline_pct(run, "flash") is None


# -- finding a family ---------------------------------------------------------------

def test_an_unknown_family_names_the_missing_file():
    path = os.path.join(FIXTURE, "port_bench", "families", "nonesuch.py")
    with pytest.raises(FileNotFoundError, match=path):
        Bench(FIXTURE).family("nonesuch")


@pytest.mark.parametrize("root", [ROOT, FIXTURE])
def test_every_configuration_names_a_family_that_exists(root):
    bench = Bench(root)
    for c in bench.spec["configs"]:
        with open(os.path.join(root, c["file"])) as f:
            cfg = json.load(f)
        family = bench.family(cfg["family"])
        for name in ("make", "port_model", "logits", "request_flops", "KERNELS", "spies",
                     "mixed_launches"):
            assert hasattr(family, name), (c["name"], name)


# -- a family added by files and entries alone ----------------------------------------

ADDED = ("port_bench/families/tied.py", "port_bench/configs/tiny_tied.json")
TIED_CELL = "tiny_tied.tiny_chat"


def _without_tied(spec: dict) -> dict:
    out = json.loads(json.dumps(spec))
    out["configs"] = [c for c in out["configs"] if c["name"] != "tiny_tied"]
    out["workloads"] = [w for w in out["workloads"] if w["config"] != "tiny_tied"]
    for m in out["end_to_end"] + out["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [n for n in m["workloads"] if n != TIED_CELL]
    return out


def _files(root) -> dict:
    out = {}
    for d, dirs, names in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_a_family_is_added_by_files_and_entries_alone(tmp_path, monkeypatch):
    """The fixture with its tied family's files and entries taken out is the
    tree before; putting them back adds two files and appends entries, and
    changes nothing that was there.  The cell then runs through the tied
    family and is correct, and its served tokens held to the Qwen family's
    reference fail: the reference is the configuration's family's."""
    with open(os.path.join(FIXTURE, "BENCHMARK.json")) as f:
        spec = json.load(f)
    old = _without_tied(spec)
    ignore = shutil.ignore_patterns("__pycache__")
    before, after = tmp_path / "before", tmp_path / "after"
    shutil.copytree(FIXTURE, before, ignore=ignore)
    for rel in ADDED:
        (before / rel).unlink()
    (before / "BENCHMARK.json").write_text(json.dumps(old, indent=1))
    shutil.copytree(before, after, ignore=ignore)
    for rel in ADDED:
        shutil.copy(os.path.join(FIXTURE, rel), after / rel)
    (after / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))

    was, now = _files(before), _files(after)
    assert set(now) - set(was) == set(ADDED)
    assert all(now[rel] == was[rel] for rel in was if rel != "BENCHMARK.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        grown = spec[key][:len(old[key])]
        for a, b in zip(old[key], grown):
            listed = a.get("workloads")
            assert {k: v for k, v in b.items() if k != "workloads"} == \
                {k: v for k, v in a.items() if k != "workloads"}
            assert listed is None or b["workloads"][:len(listed)] == listed
    with pytest.raises(KeyError):
        Bench(str(before)).cell(TIED_CELL)

    bench = Bench(str(after))
    qwen = bench.family("qwen")
    judged = {}
    inner = check.check

    def both(family, cfg, w, records, seed, control=False):
        judged["qwen"] = inner(qwen, cfg, w, records, seed)
        judged["tied"] = inner(family, cfg, w, records, seed, control=control)
        return judged["tied"]

    monkeypatch.setattr(check, "check", both)
    res = harness.run(bench, TIED_CELL, SEED, 2.0, False, time.perf_counter(), device="cpu")
    assert res["verdict"]["correct"], res["verdict"]["numbers"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["run_record"].family is bench.family("tied")
    gap, limit = judged["qwen"]["numbers"]["logit_gap"]
    assert not judged["qwen"]["correct"] and gap > 10 * limit
    assert bench.reader("rounds_read").read(res["run_record"]) > 0
