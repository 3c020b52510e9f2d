"""The readings that a cell's limits are set from: on each seed, the
numbers compared for the program's own requests (the lower readings) and
for the control, the plain reference computed in the precision below the
one the configuration states (the workload's ``control``: int4 for the
int8 path, TF32 for float32 with TF32 off, fp8 for bf16), put in the
program's place (the upper readings).

    python3 benchmarks/control.py --workload <cell> --seeds 11,12,13 [--requests 2]

Each seed builds the cell's program with weights from that seed, serves
``--requests`` requests of the cell's own size through the timed path
(after the cell's warm-up), and compares them, then the control's
outputs of the same requests, with the reference. One JSON line a seed,
then a summary line: the largest program reading and the smallest control
reading of each number. The benchmark's own runs do not run this.
"""
import argparse
import json
import os
import sys
import time


def readings(cell_name: str, seeds, requests: int, *, device: str = "cuda",
             config_overrides=None, mix_overrides=None, faults=()):
    """[(seed, program numbers, control numbers, {fault: numbers})] for
    ``seeds``; ``faults`` are planted in the reference put in the program's
    place (a training cell's)."""
    import torch

    import harness

    cell = harness.load_cell(cell_name, config_overrides, mix_overrides)
    harness.set_tf32(bool(cell.workload["tf32"]))
    out = []
    for seed in seeds:
        program = harness.make_program(cell, seed, device)
        cell.driver.warm_up(program, cell.mix)
        if hasattr(program, "readings"):        # a training step: its first steps, recorded
            got = program.readings(cell.workload["reference"], cell.workload["control"], faults)
            out.append((seed, got.pop("program"), got.pop("control"), got))
            continue
        kept = [(req, program.serve(req)) for req in map(program.request, range(requests))]
        if hasattr(program, "release"):
            program.release()
        prog_nums, ctrl_nums = harness.worst_numbers(program, kept, cell.workload["reference"],
                                                     cell.workload["control"])
        out.append((seed, prog_nums, ctrl_nums, {}))
        del program
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--faults", default="", help="comma-separated faults to read (training)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")], args.requests,
                    faults=[f for f in args.faults.split(",") if f])
    for seed, prog, ctrl, faults in rows:
        print(json.dumps({"workload": args.workload, "seed": seed, "program": prog, "control": ctrl,
                          **faults}))
    keys = [k for k, v in rows[0][1].items() if isinstance(v, float)]
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "card": torch.cuda.get_device_name(0),
                      "program_max": {k: max(r[1][k] for r in rows) for k in keys},
                      "control_min": {k: min(r[2][k] for r in rows) for k in keys},
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
