"""fetch_apply_pct.tpot: see BENCHMARK.json for its unit, layer and the metric it moves."""
from port_bench import spans


def read(run):
    return spans.share_pct(run, "apply_s")
