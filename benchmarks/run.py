"""Run one cell of the benchmark once and print its result line.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port's package. Everything of
the cell is found by name under ``benchmarks/`` (see ``harness.py`` and
``README.md``). The run sets up (CUDA context, the port's kernels built or
loaded, weights and inputs from the seed, a warm-up of the cell's own
shapes), measures for ``--seconds``, with ``--trace 1`` profiles a fixed
slice of whole requests or steps, then compares what the window produced
with the plain reference. Standard output's last line is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and last ``compared``: each number of the
comparison beside its limit, which also end standard error.

Exits non-zero without a result where there is no CUDA device, fewer than
the cell asks for, or where a module of JAX or of the JAX package was
loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# the port loads no JAX; keep libraries that could from doing so
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def _power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import harness

    workload = harness.load_json(harness.BENCH / "workloads" / f"{args.workload}.json")
    import torch

    if not torch.cuda.is_available():
        print("run.py: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < workload["chips"]:
        print(f"run.py: {args.workload} needs {workload['chips']} CUDA devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    print(f"card: {_power_limit()}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
