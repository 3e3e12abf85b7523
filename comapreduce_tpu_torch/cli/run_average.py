"""TOD-reduction entry point (port of ``comapreduce_tpu/cli/run_average.py``)::

    python -m comapreduce_tpu_torch.cli.run_average [--device=cpu] \
        [--figures[=DIR]] [--retry-quarantined] [--live-port=N] \
        configuration.toml

reads ``[Global] filelist`` (one Level-1 path per line), runs the
configured stage chain through :class:`~..pipeline.runner.Runner` and
writes ``Level2_*.hd5`` into ``[Global] output_dir``, with per-rank logs
and the run state (quarantine ledger, heartbeat, leases, quality ledger)
in ``log_dir``. The stages run on the card; ``--device=cpu`` runs the
plain versions on the CPU. The rank and the number of ranks are
``COMAP_RANK`` / ``COMAP_NRANKS`` when both are set (as ``cli.batchrun``
sets them), else 0 of 1. With
``[Global] calibrator_filelist`` (Level-1 paths of calibrator
observations reduced in the same run, ``"FitSource"`` among the
processes) a second pass writes the nearest calibrator's factors into
every file's Level-2 store (``Runner.run_astro_cal``), the calibrator
database cached at ``[Global] calibration_cache`` when given. As in the
reference, the quarantine ledger, retries, elastic claiming and the
quality ledger are on unless the config turns them off. ``--figures``
(into ``figures``), ``--figures=DIR`` or ``[Global] figure_dir`` gives
every stage with a ``figure_dir`` that directory for its per-obsid QA
figures (matplotlib on the host). ``--live-port=N`` serves the live
observability sidecar (``/metrics``, ``/healthz``, ``/v1/campaign``,
``/v1/quality``; :class:`~comapreduce_tpu_torch.telemetry.live.
LiveServer`) over the run's state directory on port ``N`` (0: an
ephemeral one, printed) while the run goes on. The end-of-run table of
stage durations is :func:`~comapreduce_tpu_torch.telemetry.report.
format_duration_table`'s, and with ``[telemetry] enabled`` the event
stream is drained before exit.
"""

from __future__ import annotations

import os
import sys

from comapreduce_tpu_torch.pipeline import Runner, load_toml, set_logging
from comapreduce_tpu_torch.pipeline.config import read_filelist
from comapreduce_tpu_torch.pipeline.runner import level2_path
from comapreduce_tpu_torch.pipeline.stages import rank_info
from comapreduce_tpu_torch.telemetry import TELEMETRY
from comapreduce_tpu_torch.telemetry.report import format_duration_table


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    retry_quarantined = False
    figure_dir = ""
    live_port = None
    rest = []
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag == "--live-port":
            live_port = int(a.split("=", 1)[1])
        elif flag == "--device":
            device = a.split("=", 1)[1]
        elif a == "--figures":
            figure_dir = "figures"
        elif flag == "--figures":
            figure_dir = a.split("=", 1)[1]
        elif a == "--retry-quarantined":
            retry_quarantined = True
        else:
            rest.append(a)
    if len(rest) != 1:
        print("usage: python -m comapreduce_tpu_torch.cli.run_average "
              "[--device=DEV] [--figures[=DIR]] [--retry-quarantined] "
              "[--live-port=N] configuration.toml",
              file=sys.stderr)
        return 2
    config = load_toml(rest[0])
    glob = config.get("Global", {})
    if retry_quarantined:
        config = dict(config)
        config["resilience"] = dict(config.get("resilience", {}),
                                    retry_quarantined=True)
    rank, n_ranks = rank_info()
    log_dir = str(glob.get("log_dir", "") or
                  os.path.join(str(glob.get("output_dir", ".")), "logs"))
    runner = Runner.from_config(config, rank=rank, n_ranks=n_ranks,
                                device=device)
    set_logging(base="run_average", log_dir=log_dir, rank=rank,
                level=str(glob.get("log_level", "INFO")))
    figure_dir = figure_dir or str(glob.get("figure_dir", ""))
    if figure_dir:
        for p in runner.processes:
            if hasattr(p, "figure_dir"):
                p.figure_dir = figure_dir
    live = None
    if live_port is not None and rank == 0:
        # the plane reads every rank's on-disk state: one sidecar per
        # campaign (rank 0's) is the whole picture
        from comapreduce_tpu_torch.telemetry.live import LiveServer

        live = LiveServer(runner.state_dir or runner.output_dir,
                          port=live_port, n_ranks=n_ranks).start()
        print(f"live plane: http://{live.host}:{live.port}/metrics",
              flush=True)
    try:
        filelist = read_filelist(glob["filelist"])
        runner.run_tod(filelist)
        cal_list_path = glob.get("calibrator_filelist")
        if cal_list_path:
            cal_l2 = [level2_path(runner.output_dir, f, runner.prefix)
                      for f in read_filelist(cal_list_path)]
            runner.run_astro_cal(filelist, cal_l2,
                                 cache_path=glob.get("calibration_cache",
                                                     ""))
        # one definition of count/mean/p50/p95, shared with
        # campaign_report; skip-path placeholders counted, not averaged
        table = format_duration_table(runner.timings)
        if table:
            print(table)
        if TELEMETRY.enabled:
            TELEMETRY.close()  # drain the event buffer before exit
            print(f"telemetry: {TELEMETRY.path} (merge with python -m "
                  "comapreduce_tpu_torch.cli.campaign_report)")
    finally:
        if live is not None:
            live.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
