"""Run one cell of the port's benchmark once, on the machine it starts on:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs a CUDA card (as many as the cell
asks for) and exits non-zero without a result otherwise; there is no CPU
fallback. It prints the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``) as the last line of standard output, one
JSON object, and each number of the correctness check beside its limit as
the last lines of standard error. Kernel builds stay inside the checkout
(``build/``), so only a checkout's first run compiles.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
os.environ["USE_FLAX"] = "0"

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pointvit_tpu")


def forbidden_modules() -> list[str]:
    """Modules loaded whose whole top-level name is JAX's or the JAX
    package's (``pointvit_tpu_torch`` is not)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _finite(x):
    """``x`` with every non-finite float as None (JSON has no infinity)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return None if isinstance(x, float) and not math.isfinite(x) else x


def metric_values(bench: dict, cell: str, trace_on: bool, t) -> dict:
    from portbench.harness import reader

    listed = bench["per_layer"] if trace_on else bench["end_to_end"]
    out = {}
    for m in listed:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        value = reader(m["name"])(t)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path(ROOT)
    bench = json.loads((root / "BENCHMARK.json").read_text())

    import torch

    from portbench import check, harness

    cell, config, traffic = harness.load_cell(bench, args.workload, root)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, config, traffic, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    t = out["trace"]
    correct, checks = check.judge(out["numbers"], harness.limits_of(config["name"],
                                                                    traffic["kind"]))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(out["peak"]), "power_limit": _power_limit()}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metric_values(bench, args.workload, bool(args.trace), t),
              "device": device}
    if args.trace:
        if t.device is None or not t.device["busy_s"] > 0:
            print("portbench: the traced stretch holds no device time", file=sys.stderr)
            return 4
        device.update(busy_s=t.device["busy_s"], window_s=t.device["window_s"])
        result["breakdown"] = {"device_ops": t.device["device_ops"],
                               "idle_gaps": t.device["idle_gaps"]}
    for e in out.get("errors", []):
        print(f"portbench: a request failed: {e}", file=sys.stderr)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r}): "
              f"{'ok' if c['limit'] is not None and c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
