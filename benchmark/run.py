"""Run one cell of the benchmark of salva_tpu_torch and print its result.

    python3 benchmark/run.py --workload harness_basic3_n40.collapse \
        --seed 7 --seconds 30 --trace 0

Prints one JSON object as the last line of standard output: ``correct``,
``attempted`` and ``failed`` steps, the cell's end-to-end metrics (or with
``--trace 1`` its per-layer metrics, the device's busy and window seconds
and a breakdown), the device, and last the numbers the check compared,
each beside its limit (also the last lines of standard error). Exits 2
without a result when no CUDA device (or fewer than the cell asks for) is
present, and 3 when the process holds JAX or the JAX package.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds (the port's own nvcc cache is
# build/salva_tpu_torch/<hash>/ there already).
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, rows = harness.run_cell(cell, args.seed, args.seconds,
                                       bool(args.trace), T0)
    loaded = harness.forbidden_modules_loaded()
    if loaded:
        print(f"the process holds {loaded}: refused", file=sys.stderr)
        return 3
    result["card"] = harness.card_line()
    result["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    print(json.dumps(result), flush=True)
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
