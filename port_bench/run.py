"""The benchmark's command:

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  Prints one JSON line on standard output,
last: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``check``: each number the check
compared beside its limit, which also close standard error.  Exits non-zero
and prints no result without a card, or where a module of JAX or of the JAX
package was loaded.
"""
import time

T0 = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "chatts_tpu")
# A run has 360 s to end (1,200 s the first in a checkout, which compiles):
# one that hangs ends itself, with no result, before the driver's limit.
WATCHDOG_S = 350.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def start_watchdog(seconds: float) -> None:
    def expire():
        print(f"port_bench: the run did not end within {seconds:.0f} s", file=sys.stderr,
              flush=True)
        os._exit(5)

    timer = threading.Timer(seconds - (time.perf_counter() - T0), expire)
    timer.daemon = True
    timer.start()


def result_line(res: dict, trace: bool, bench, device: dict) -> dict:
    """The JSON line of a run's result."""
    cell = res["cell"]
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            v = res["values"].get(m.name)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    else:
        for m in cell.per_layer:
            v = bench.reader(m.name).read(res["run_record"])
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    out = {"correct": res["verdict"]["correct"] and res["failed"] == 0,
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    summary = res["run_record"].trace
    if trace and summary is not None:
        top = sorted(summary["by_kernel"].items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                            "idle_gaps": [[label, s] for label, s in summary["gaps"][:10]]}
    out["check"] = {k: {"value": v, "limit": lim}
                    for k, (v, lim) in res["verdict"]["numbers"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    first = not os.path.exists(os.path.join("chatts_tpu_torch", "_build", "libint4_matmul.so"))
    start_watchdog(1150.0 if first else WATCHDOG_S)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("port_bench: no CUDA device; this benchmark runs on the card only",
              file=sys.stderr)
        return 2

    from port_bench import harness
    from port_bench.cells import Bench

    bench = Bench(os.getcwd())
    if bench.cell(args.workload).chips > torch.cuda.device_count():
        print(f"port_bench: {args.workload} needs {bench.cell(args.workload).chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    res = harness.run(bench, args.workload, args.seed, args.seconds, bool(args.trace), T0)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": int(res["peak"])}
    summary = res["run_record"].trace
    if args.trace:
        if summary is None:
            print("port_bench: the traced sub-window never ran "
                  f"{res['info']['trace_error'] or ''}", file=sys.stderr)
            return 4
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
    line = result_line(res, bool(args.trace), bench, device)
    found = forbidden_modules()
    if found:
        print(f"port_bench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    info = res["info"]
    harness.log(f"power limit {power_limit()}; window {info['window']}; rounds read "
                f"{info['rounds']}; graph captures {info['captures']}, in the window "
                f"{info['captures_in_window']}; values "
                f"{ {k: v for k, v in res['values'].items()} }")
    if summary is not None:
        harness.log("trace " + json.dumps({k: v for k, v in summary.items()
                                           if k not in ("by_kernel", "gaps")}))
    for d in res["verdict"]["detail"]:
        harness.log(f"compared {d}")
    for k, (v, lim) in res["verdict"]["numbers"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
