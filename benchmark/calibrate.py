"""The readings the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--tf32-seeds 1]

In one process, for each seed: the cell's set-up, one unit of work
through the timed entry, and its numbers against the plain reference
(the lower reading). For each control seed: the reference computed with
bfloat16 storage put in the program's place, against the float64
reference (the upper reading). For each TF32 seed: one unit with the
program's own TF32 switch on. Prints one JSON line a reading.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the script's own folder would shadow the standard library's ``trace``
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "benchmark"]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_record(ref: dict, limits: dict) -> dict:
    """The control's outputs under the keys a unit's record uses: those
    of the numbers the cell compares (its ``limits``)."""
    return {k: ref[k] for k in limits if k in ref}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--tf32-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default="{}",
                    help="JSON replacing configuration keys (small "
                    "shapes for the CPU)")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    cell.sizes.update(json.loads(args.sizes))
    Driver = harness.load_driver(cell.traffic["driver"]).Driver
    seeds = sorted(set(args.seeds) | set(args.control_seeds)
                   | set(args.tf32_seeds))
    for seed in seeds:
        t0 = time.perf_counter()
        drv = Driver(cell.sizes, cell.traffic, seed,
                     torch.device(args.device))
        rec = drv.step()
        t1 = time.perf_counter()
        rows = []
        if seed in args.seeds:
            rows.append(("program", [rec]))
        if seed in args.tf32_seeds:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            rows.append(("program_tf32", [drv.step()]))
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if seed in args.control_seeds:
            t2 = time.perf_counter()
            ctrl = control_record(drv.reference("bf16"),
                                  cell.traffic["limits"])
            rows.append(("control_bf16", [ctrl]))
            print(json.dumps({"seed": seed, "control_ref_s":
                              time.perf_counter() - t2}), flush=True)
        t2 = time.perf_counter()
        ref = drv.reference("f64")
        ref_s = time.perf_counter() - t2
        drv.reference = lambda prec, _r=ref: _r
        for kind, recs in rows:
            print(json.dumps({"seed": seed, "kind": kind,
                              "numbers": drv.compare(recs, "f64")[0],
                              "setup_and_unit_s": t1 - t0,
                              "reference_s": ref_s}), flush=True)
        del drv, rec, rows, ref
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
