"""Run one cell of the benchmark on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The last line of standard output is the result (JSON); the last lines
of standard error are the compared numbers beside their limits. Exits
non-zero, printing no result, when no card is there (or fewer than the
cell asks for) and when a module of JAX or of the JAX package is
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the script's own folder would shadow the standard library's ``trace``
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "benchmark"]
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = harness.load_cell(args.workload, manifest).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from comapreduce_tpu_torch import _build
    _build.set_build_dir(ROOT / "build" / "comapreduce_tpu_torch")
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START,
                      manifest=manifest)
    return harness.emit(out)


if __name__ == "__main__":
    sys.exit(main())
