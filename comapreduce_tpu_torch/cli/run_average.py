"""TOD-reduction entry point (port of ``comapreduce_tpu/cli/run_average.py``)::

    python -m comapreduce_tpu_torch.cli.run_average [--device=cpu] \
        configuration.toml

reads ``[Global] filelist`` (one Level-1 path per line), runs the
configured stage chain through :class:`~..pipeline.runner.Runner` and
writes ``Level2_*.hd5`` into ``[Global] output_dir``, with per-rank logs
in ``log_dir``. The stages run on the card; ``--device=cpu`` runs the
plain versions on the CPU. The port runs as rank 0 of 1. A config must
set ``[resilience] quarantine = "off"``, ``lease_ttl_s = 0`` and
``[quality] enabled = false``: the quarantine ledger, elastic claiming
and the quality ledger the reference turns on by default are not
ported. ``--figures``, ``--retry-quarantined``, ``--live-port`` and
``[Global] calibrator_filelist`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import sys

from comapreduce_tpu_torch.pipeline import Runner, load_toml, set_logging
from comapreduce_tpu_torch.pipeline.config import read_filelist

_UNPORTED_FLAGS = {"--figures": "diagnostics (QA figures)",
                   "--retry-quarantined": "the quarantine ledger",
                   "--live-port": "telemetry/live"}


def _duration_table(timings: dict) -> str:
    """Per-stage count, mean and total wall seconds."""
    rows = [f"{'stage':<34} {'n':>4} {'mean_s':>10} {'total_s':>10}"]
    for name, vals in timings.items():
        if vals:
            rows.append(f"{name:<34} {len(vals):>4} "
                        f"{sum(vals) / len(vals):>10.3f} {sum(vals):>10.3f}")
    return "\n".join(rows) if len(rows) > 1 else ""


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rest = []
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag in _UNPORTED_FLAGS:
            raise NotImplementedError(
                f"{flag} needs {_UNPORTED_FLAGS[flag]}, which is not ported")
        if flag == "--device":
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    if len(rest) != 1:
        print("usage: python -m comapreduce_tpu_torch.cli.run_average "
              "[--device=DEV] configuration.toml", file=sys.stderr)
        return 2
    config = load_toml(rest[0])
    glob = config.get("Global", {})
    for key in ("calibrator_filelist", "figure_dir"):
        if glob.get(key):
            raise NotImplementedError(
                f"[Global] {key}: its stages are not ported")
    rank, n_ranks = 0, 1
    log_dir = str(glob.get("log_dir", "") or
                  os.path.join(str(glob.get("output_dir", ".")), "logs"))
    runner = Runner.from_config(config, rank=rank, n_ranks=n_ranks,
                                device=device)
    set_logging(base="run_average", log_dir=log_dir, rank=rank,
                level=str(glob.get("log_level", "INFO")))
    runner.run_tod(read_filelist(glob["filelist"]))
    table = _duration_table(runner.timings)
    if table:
        print(table)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
