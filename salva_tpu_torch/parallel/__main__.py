"""``python -m salva_tpu_torch.parallel <n_devices> [--device cpu]``:
:func:`salva_tpu_torch.parallel.dryrun` on ``n_devices`` slabs, on the
card unless ``--device`` names another device."""

import argparse
import sys

from .domain import dryrun


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m salva_tpu_torch.parallel",
        description="One sharded-binning step of the dense DFSPH solver on "
                    "n slabs (LocalHalos), checked.")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dryrun(args.n_devices, device=args.device)
    print(f"dryrun({args.n_devices}) ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
