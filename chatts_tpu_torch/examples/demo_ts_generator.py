"""Demo: the synthetic time-series generator (attributes -> series -> text).

The port's counterpart of ``examples/demo_ts_generator.py`` (itself after the
reference's demo/demo_ts_generator.ipynb): sample a random attribute pool,
realize a series from it, and render the ground-truth caption.  Also shows
controlled generation from a named metric's attribute prior and the
value-preserved sp encoding of the result.

Run: python -m chatts_tpu_torch.examples.demo_ts_generator [--seq-len 256]
[--seed 0] [--plot]
"""
import argparse
from pprint import pprint
from typing import Optional, Sequence


PLOT_PATH = "demo_ts_generator.png"


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--seq-len", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--plot", action="store_true",
                        help=f"save both series as {PLOT_PATH} in the working directory")
    args = parser.parse_args(argv)

    from chatts_tpu_torch.core.encoding import timeseries_encoding
    from chatts_tpu_torch.datagen.generator import (
        TimeSeriesGenerator,
        attribute_to_caption,
        attribute_to_text,
    )
    from chatts_tpu_torch.datagen.metric_set import MetricSet

    gen = TimeSeriesGenerator(seed=args.seed)

    # 1. Fully random attributes -> series -> caption (the notebook's flow).
    pool = gen.generate_random_attributes(seq_len=args.seq_len)
    ts, pool = gen.generate(pool, args.seq_len)
    print("=== random attributes ===")
    print(attribute_to_caption(ts, pool))
    print("\nlocal fluctuations:")
    pprint(pool["local"])

    # 2. Controlled generation from a metric's domain prior.
    mset = MetricSet.load()
    names = sorted(mset.all_metrics())
    name = names[args.seed % len(names)]
    cpool = gen.generate_controlled_attributes(
        mset.metric_to_controlled_attributes(name), seq_len=args.seq_len
    )
    cts, cpool = gen.generate(cpool, args.seq_len)
    print(f"\n=== controlled: {name!r} ===")
    print(attribute_to_text(cts, cpool))

    # 3. Value-preserved sp encoding of the random series.
    encoded, fragment, meta = timeseries_encoding(ts, "sp")
    print("\n=== sp encoding ===")
    print("prompt fragment:", fragment)
    print("encoded shape:", encoded.shape, "(2L interleaved value/valid)")
    print("offset/scaling:", {k: round(float(v), 4) for k, v in meta.items()})

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 1, figsize=(10, 5))
        axes[0].plot(ts)
        axes[0].set_title("random attributes")
        axes[1].plot(cts)
        axes[1].set_title(f"controlled: {name}")
        fig.tight_layout()
        fig.savefig(PLOT_PATH)
        print(f"\nsaved plot to {PLOT_PATH}")


if __name__ == "__main__":
    main()
