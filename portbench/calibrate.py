"""Readings that set the limits of ``correct``: the sound program over many
seeds, the control and the planted faults, each at a cell's own size and
load, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        --seconds 2 --variants sound,control[,...] [--out file.json]

The variants are those of the cell's kind (``kinds/<kind>.py``'s
``VARIANTS``). The control is the computation one precision below the
configuration's bf16: the plain reference with its products in fp8, put in
the program's place. Each reading prints as one JSON line and all go to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from portbench import harness

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--variants", default="sound")
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, config, traffic = harness.load_cell(bench, args.workload, ROOT)
    kind = harness.kind_of(traffic["kind"])
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    rows = []
    for variant in args.variants.split(","):
        if variant not in kind.VARIANTS:
            raise SystemExit(f"{traffic['kind']} has no variant {variant!r}: {kind.VARIANTS}")
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.time()
            ctx = harness.context(cell, config, traffic, seed, args.seconds, False, device, t0)
            row = {"workload": args.workload, "variant": variant, "seed": seed,
                   **kind.reading(ctx, variant), "seconds": round(time.time() - t0, 1)}
            print(json.dumps(row), flush=True)
            rows.append(row)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
