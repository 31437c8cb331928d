"""prefill_mfu.tpot: see BENCHMARK.json for its unit, layer and the metric it moves."""
from port_bench import readers


def read(run):
    return readers.mfu_pct(run, readers.ADMISSION_KINDS)
