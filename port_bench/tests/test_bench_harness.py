"""The harness on the CPU at a tiny size: an extra cell loaded from a
fixture directory (its own BENCHMARK.json, configuration, mixes and a
per-layer metric of its own), the run against the port's ``ServeEngine``
and the plain reference, the check failing under planted faults and under
the control, and the imports."""
import os
import subprocess
import sys
import time

import pytest
import torch

from port_bench import harness
from port_bench import run as run_cli
from port_bench.cells import Bench

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixture")
ROOT = os.path.dirname(os.path.dirname(HERE))
SEED = 2**31 + 11  # more than 32 signed bits hold


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_run(cell, control=False, seconds=2.0):
    return harness.run(Bench(FIXTURE), cell, SEED, seconds, False, time.perf_counter(),
                       device="cpu", control=control)


def test_extra_cell_loads_from_files_alone():
    bench = Bench(FIXTURE)
    cell = bench.cell("tiny.tiny_chat")
    assert cell.config["hidden_size"] == 128 and cell.traffic["clients"] == 6
    assert [m.name for m in cell.end_to_end] == ["output_tok_s", "setup_s"]
    assert [m.name for m in cell.per_layer] == ["rounds_read"]
    assert [m.name for m in bench.cell("tiny.tiny_open").per_layer] == []
    with pytest.raises(KeyError):
        bench.cell("tiny.none")


@pytest.mark.parametrize("cell", ["tiny.tiny_chat", "tiny.tiny_open"])
def test_tiny_run_is_correct(cell):
    res = tiny_run(cell)
    line = run_cli.result_line(res, False, Bench(FIXTURE), {"platform": "cpu"})
    assert line["correct"], line
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "check"
    want = {"tiny.tiny_chat": "output_tok_s", "tiny.tiny_open": "ttft_p90_ms"}[cell]
    assert set(line["metrics"]) == {want, "setup_s"}
    assert res["verdict"]["numbers"]["prompt_mismatch"][0] == 0
    if cell == "tiny.tiny_chat":
        assert Bench(FIXTURE).reader("rounds_read").read(res["run_record"]) > 0


def _wrap(monkeypatch, module, name, make):
    monkeypatch.setattr(module, name, make(getattr(module, name)))


def test_altered_token_fails(monkeypatch):
    from chatts_tpu_torch.serve import scheduler

    def make(inner):
        def sample(mesh, logits, *args):
            return (inner(mesh, logits, *args) + 1) % logits.shape[-1]
        return sample

    _wrap(monkeypatch, scheduler, "_sample", make)
    assert not tiny_run("tiny.tiny_chat")["verdict"]["correct"]


def test_state_left_unchanged_fails(monkeypatch):
    from chatts_tpu_torch.serve import scheduler

    def make(inner):
        def advance(logits, tokens, cur_lens, *args, **kw):
            emitted, _, _, budget, live = inner(logits, tokens, cur_lens, *args, **kw)
            return emitted, tokens, cur_lens, budget, live
        return advance

    _wrap(monkeypatch, scheduler, "_advance", make)
    assert not tiny_run("tiny.tiny_chat")["verdict"]["correct"]


def test_mixed_keys_cover_every_scan_sliced_round(monkeypatch):
    # With a small block budget every wave takes the scan-sliced route; the
    # keys set-up enumerates hold every round the engine then runs (eagerly
    # here), and the check samples a request of each route.
    from chatts_tpu_torch.serve import scheduler

    seen, listed = set(), []

    def make_init(inner):
        def init(self, *args, **kw):
            inner(self, *args, **kw)
            self.block_token_budget = 64
        return init

    def make_round(inner):
        def mixed_round(model, chunk, npt, kv_limit, *args):
            seen.add((args[-1].embeds.shape[0], npt, kv_limit))
            return inner(model, chunk, npt, kv_limit, *args)
        return mixed_round

    def make_keys(inner):
        def keys(engine, lengths):
            listed.extend(inner(engine, lengths))
            return listed
        return keys

    monkeypatch.setattr(scheduler.ServeEngine, "__init__",
                        make_init(scheduler.ServeEngine.__init__))
    _wrap(monkeypatch, scheduler, "_mixed_round", make_round)
    _wrap(monkeypatch, harness, "mixed_keys", make_keys)
    res = tiny_run("tiny.tiny_chat")
    assert res["verdict"]["correct"], res["verdict"]["numbers"]
    assert seen and seen <= set(listed), (seen, listed)
    assert "mixed" in res["info"]["routes"]
    assert "mixed" in {d["route"] for d in res["verdict"]["detail"]}


def test_sample_takes_each_route():
    from port_bench import check

    class Req:
        def __init__(self, n):
            self.output_tokens, self.error = [0] * n, None

    class Rec:
        def __init__(self, i, route, n):
            self.spec = type("S", (), {"index": i})()
            self.req, self.route, self.ok = Req(n), route, True

    recs = [Rec(i, "block", 5) for i in range(40)] + [Rec(40, "mixed", 3), Rec(41, "mono", 2),
                                                       Rec(42, "block", 9)]
    for seed in range(20):
        got = check.sample(recs, 4, seed)
        assert len(got) == 4 and len({id(r) for r in got}) == 4
        assert {r.route for r in got} == {"block", "mixed", "mono"}
        assert 42 in [r.spec.index for r in got]
    assert [r.spec.index for r in check.sample(recs, 4, 3)] == \
        [r.spec.index for r in check.sample(recs, 4, 3)]


def test_control_reads_beside_the_program():
    # At this size float8 and bfloat16 are not told apart; the card's test
    # below holds the control at the cells' widths.
    v = tiny_run("tiny.tiny_chat", control=True)["verdict"]
    assert v["correct"] and v["control_gap"] >= 0.0


def test_no_jax_and_reference_alone():
    code = (
        "import sys, time, torch; torch.set_num_threads(2)\n"
        "import port_bench.reference.model, port_bench.reference.processor\n"
        "from port_bench.cells import Bench\n"
        f"Bench({ROOT!r}).family('qwen')\n"
        "assert not [m for m in sys.modules if m.split('.')[0].startswith('chatts_tpu')]\n"
        "from port_bench import harness, run\n"
        f"harness.run(Bench({FIXTURE!r}), 'tiny.tiny_open', 5, 1.0, False, time.perf_counter(),"
        " device='cpu')\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cli_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_cli.main(["--workload", "chatts-14b-int4.chat", "--seed", "1",
                         "--seconds", "1"]) != 0


def test_benchmark_json_names_existing_files():
    bench = Bench(ROOT)
    for w in bench.spec["workloads"]:
        cell = bench.cell(w["name"])
        assert cell.chips == 1 and cell.per_layer
        for m in cell.per_layer:
            assert callable(bench.reader(m.name).read)
        assert {m.name for m in cell.end_to_end} >= {"setup_s"}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["chatts-14b-int4.chat", "qwen3-8b-ts-int4.mts_long"])
def test_control_fails_on_the_card(cell):
    """The cell as it is benchmarked, with a 10 s window: the program passes
    its limit, and the control, the reference computed in float8 in its
    place at the same positions, fails it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = harness.run(Bench(ROOT), cell, SEED, 10.0, False, time.perf_counter(), device="cuda",
                      control=True)
    v = res["verdict"]
    assert v["correct"], v["numbers"]
    assert v["control_gap"] > v["numbers"]["logit_gap"][1], v["control_gap"]
