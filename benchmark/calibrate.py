"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload harness_basic3_n40.collapse \
        --seeds 101-112 --control-seeds 201-203 --out readings.json

For each seed: the run's set-up (the scene from the seed, W warm-up steps),
then one episode of K steps from the snapshot, every step held to the
reference (``check.py``) as the run's check holds its sample, and the
first step from the inputs. The program's readings give the lower end of
each limit. The control named in ``limits/<workload>.json`` gives the
upper end, on its own seeds (``harness.CONTROLS``):

- ``program_frozen_bfloat16``: the program with its frozen pair
  coefficients in bfloat16 (``dense_frozen_pairs``, ``dense_pair_dtype``),
  the program's own lower-precision path, switched on from the start;
- ``reference_bfloat16``: the reference with every pair term in bfloat16
  and its sums in float32, put in the program's place on the program's
  states.

Each seed's line gives each number's widest and smallest reading over the
steps: the control's smallest is what a sample of one step reads.

Prints one JSON line per seed and writes them all to ``--out``. The
benchmark's own runs do not run this.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import check, harness  # noqa: E402

def episode_entries(cell, seed, device, control=None):
    """The first step's entry and every step of one episode, as the run's
    check records them; ``control`` switches the program's own
    lower-precision path on."""
    scene = harness.Scene(cell.config, seed, device, control=control)
    first = None
    for k in range(int(cell.traffic["warmup_steps"])):
        harness.take_step(scene, False)
        if k == 0:
            first = dict(after=scene.state(), slots=scene.slots())
    ep = copy.deepcopy(scene)
    entries = [first]
    for _ in range(int(cell.traffic["episode_steps"])):
        before = ep.state()
        harness.take_step(ep, False)
        entries.append(dict(before=before, after=ep.state(),
                            slots=ep.slots(), step=ep.steps_taken))
    return scene.initial, entries


def readings(cell, seed, device, control=None):
    """Per-step gaps of one seed: [{number: value}] over the first step and
    the episode's steps."""
    program_control = control == "program_frozen_bfloat16"
    initial, entries = episode_entries(
        cell, seed, device, control if program_control else None)
    stepper = (check.reference_stepper(torch.bfloat16, torch.float32)
               if control == "reference_bfloat16" else None)
    return [check.compare(cell.config, initial, [e], device, stepper=stepper)
            for e in entries]


def summary(per_step):
    return {k: dict(max=max(g[k] for g in per_step),
                    min=min(g[k] for g in per_step))
            for k in check.NUMBERS}


def _seeds(text):
    a, _, b = text.partition("-")
    return list(range(int(a), int(b or a) + 1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    control = cell.limits["control"]
    if control not in harness.CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    rows = []
    jobs = [(s, None) for s in (_seeds(args.seeds) if args.seeds else [])]
    if args.control_seeds:
        jobs += [(s, control) for s in _seeds(args.control_seeds)]
    for seed, ctl in jobs:
        t = time.monotonic()
        per_step = readings(cell, seed, "cuda", ctl)
        row = dict(workload=args.workload, seed=seed,
                   side=ctl or "program", steps=len(per_step),
                   seconds=time.monotonic() - t, **summary(per_step),
                   per_step=per_step)
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "per_step"}),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
