"""The scale drill: a generated file queue against the whole serving
stack at once (port of ``comapreduce_tpu/synthetic/loadgen.py``).

``run_synthetic_drill`` points an N-file virtual campaign
(``synth://`` members, zero bytes of Level-1 on disk) at every moving
part the repo ships, simultaneously:

- **elastic reduce**: three real worker processes (``python -m
  comapreduce_tpu_torch.synthetic.loadgen --worker``) share one lease-file
  queue and run the REAL stage chain (``Runner.from_config``) over the
  virtual members; each worker re-registers the scenario from its TOML
  on the command line — the determinism contract is what makes a
  late-joining process serve identical bytes;
- **ranks leaving and joining**: rank 1 is SIGKILLed the moment it
  holds a live lease (the leaked lease must be stolen by a survivor),
  then a NEW process rejoins as rank 1 mid-run and drains queue tail —
  its fresh heartbeat is also what returns ``/healthz`` to 200;
- **publish pressure**: a ``serving.MapServer`` (with a tile root
  attached) folds committed files into versioned epochs WHILE the
  queue is still draining — one mid-run epoch under load, one final
  epoch over the full census;
- **live observability**: a ``telemetry.live.LiveServer`` sidecar is
  scraped throughout — ``/healthz`` must flip 503 within one TTL of
  the kill and recover after the rejoin, and the final ``/metrics``
  commit counters must match the per-rank scheduler accounting
  exactly for ranks whose telemetry stream was drained cleanly.

Every gate is machine-independent (counts, lease states, census
equality — never wall time), so ``python -m
comapreduce_tpu_torch.cli.check_resilience --synthetic-only`` behaves
identically on a laptop and in CI.

The workers' stage chain and the map server run on ``device`` (default
``cuda``; without a card it raises unless ``device="cpu"``), which each
worker receives on its command line. The workers write Level-2 HDF5
files, so the drill needs ``h5py``.
"""

from __future__ import annotations

import glob as _glob
import json
import logging
import os
import time

__all__ = ["SCALE_SCENARIO", "scale_scenario", "write_scenario_toml",
           "run_synthetic_drill"]

logger = logging.getLogger("comapreduce_tpu_torch")

# Per-file shape is deliberately tiny (one feed, one band, 16 channels,
# two ~256-sample scans): the drill's subject is the QUEUE — hundreds
# of files through claim/reduce/commit/fold — not per-file science.
# shape_jitter varies the per-file shapes across the campaign (the
# reference's shape-bucket compile reuse); the small spike/NaN rates
# keep the numerical tripwires in
# the hot path; TauA routes the calibrator reduce chain (cheapest).
SCALE_SCENARIO = dict(
    name="scale",
    source="TauA",
    n_feeds=1,
    n_bands=1,
    n_channels=16,
    n_scans=2,
    scan_samples=256,
    vane_samples=64,
    # gap must exceed MeasureSystemTemperature's window pad (30 in
    # _reduce_config) or the padded vane windows swallow faulted scan
    # samples and the Tsys solve zeroes out — see _reduce_config.
    gap_samples=40,
    shape_jitter=16,
    az_throw=0.25,
    t_atm_sigma=0.01,
    t_atm_fknee=1.0,
    t_atm_alpha=1.5,
    spike_rate=0.002,
    nan_rate=0.001,
)

_N_RANKS = 3
# the drill's MeasureSystemTemperature window pad — ONE constant shared
# by _reduce_config and the load-time pad-vs-gap fault trap
# (ScenarioConfig.validate_vane_pad), so the stage chain and the
# validation can never drift apart
_VANE_PAD = 30
MAP_SHAPE = (64, 64)
CDELT = (1.0 / 60.0, 1.0 / 60.0)


def scale_scenario(seed: int = 0, n_files: int = 200, **overrides):
    from comapreduce_tpu_torch.synthetic.scenario import ScenarioConfig

    knobs = dict(SCALE_SCENARIO)
    knobs.update(overrides)
    knobs["seed"] = int(seed)
    knobs["n_files"] = int(n_files)
    return ScenarioConfig.coerce(knobs)


def write_scenario_toml(cfg, path: str) -> str:
    """Serialise ``cfg`` as a loadable ``[scenario]`` TOML file — the
    hand-off a subprocess worker (or another host) re-registers from."""
    lines = ["[scenario]"]
    for key in type(cfg).KNOBS:
        v = getattr(cfg, key)
        if isinstance(v, str):
            lines.append(f'{key} = "{v}"')
        elif isinstance(v, bool):
            lines.append(f"{key} = {str(v).lower()}")
        else:
            lines.append(f"{key} = {v!r}")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)
    return path


def _reduce_config(out_dir: str, state_dir: str, ttl_s: float) -> dict:
    """The workers' stage chain: the standard calibration front half
    (enough to produce a servable Level-2), elastic claiming on."""
    return {
        "Global": {
            "processes": ["CheckLevel1File", "AssignLevel1Data",
                          "MeasureSystemTemperature", "AtmosphereRemoval",
                          "Level1AveragingGainCorrection"],
            "output_dir": out_dir,
            "log_dir": state_dir,
        },
        "CheckLevel1File": {"min_duration_seconds": 5.0},
        # pad must stay below gap_samples: the stage widens each vane
        # window by `pad` to catch post-retraction sky samples, and at
        # the default 50 it reaches past the 40-sample gap into the
        # scan cells where the scenario's spike/NaN faults live — one
        # fault inside the window NaNs the range normalisation and
        # zeroes the whole event's Tsys (hence every Level-2 weight).
        "MeasureSystemTemperature": {"pad": _VANE_PAD},
        "Level1AveragingGainCorrection": {"feed_batch": 1},
        "resilience": {"lease_ttl_s": ttl_s,
                       "heartbeat_s": max(ttl_s / 5.0, 0.05)},
    }


def _worker_main(argv=None) -> int:
    """One elastic reduce rank over a virtual campaign (the
    ``python -m comapreduce_tpu_torch.synthetic.loadgen --worker`` entry).

    The scenario TOML on the command line is the ONLY data hand-off:
    the worker re-registers it, derives the same ``synth://`` filelist
    every sibling derives, and claims from the shared lease queue."""
    import argparse

    from comapreduce_tpu_torch.pipeline.runner import Runner
    from comapreduce_tpu_torch.synthetic.generator import virtual_filelist
    from comapreduce_tpu_torch.synthetic.memsource import \
        register_scenario_file

    p = argparse.ArgumentParser(prog="loadgen-worker")
    p.add_argument("--scenario", required=True)
    p.add_argument("--state-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--n-ranks", type=int, default=_N_RANKS)
    p.add_argument("--ttl", type=float, default=2.0)
    p.add_argument("--telemetry", action="store_true")
    p.add_argument("--device", default=None,
                   help="the parent drill's device (default cuda)")
    a = p.parse_args(argv)
    if a.telemetry:
        from comapreduce_tpu_torch.telemetry import TELEMETRY

        TELEMETRY.configure(a.state_dir, rank=a.rank, flush_s=0.2)
    # vane_pad threads the chain's window pad into the load-time
    # pad-vs-gap fault trap: a scenario whose gap the padded vane
    # windows would overrun fails HERE, not as silently-zero weights
    cfg = register_scenario_file(a.scenario, vane_pad=_VANE_PAD)
    files = virtual_filelist(cfg)
    runner = Runner.from_config(
        _reduce_config(a.output_dir, a.state_dir, a.ttl),
        rank=a.rank, n_ranks=a.n_ranks, device=a.device)
    results = runner.run_tod(files)
    out = {"rank": a.rank, "n_results": len(results),
           "stats": dict(runner.scheduler_stats or {})}
    tmp = os.path.join(a.state_dir, f".result.rank{a.rank}.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(out, f)
    os.replace(tmp, os.path.join(a.state_dir,
                                 f"result.rank{a.rank}.json"))
    if a.telemetry:
        from comapreduce_tpu_torch.telemetry import TELEMETRY

        TELEMETRY.close()
    return 0


def _scan_leases(state_dir: str) -> dict:
    """``{basename: lease dict}`` for every lease file in the queue."""
    from comapreduce_tpu_torch.resilience.lease import read_lease

    out = {}
    for p in _glob.glob(os.path.join(state_dir, "lease.*.json")):
        st = read_lease(p)
        if st is not None:
            out[os.path.basename(str(st.get("file", p)))] = st
    return out


def run_synthetic_drill(workdir: str, seed: int = 0, n_files: int = 200,
                        ttl_s: float = 2.0,
                        timeout_s: float = 600.0, device=None) -> dict:
    """The scale drill; returns the evidence dict, raises
    ``AssertionError`` with a named criterion on any broken promise."""
    import subprocess
    import sys
    from urllib.error import URLError
    from urllib.request import urlopen

    from comapreduce_tpu_torch.mapmaking.wcs import WCS
    from comapreduce_tpu_torch.resilience.drill import (_child_env,
                                                        _device_arg)
    from comapreduce_tpu_torch.serving.epochs import EpochStore
    from comapreduce_tpu_torch.serving.ledger import ServedLedger
    from comapreduce_tpu_torch.serving.server import MapServer
    from comapreduce_tpu_torch.synthetic.generator import virtual_filelist
    from comapreduce_tpu_torch.synthetic.memsource import register_scenario
    from comapreduce_tpu_torch.telemetry.live import LiveServer
    from comapreduce_tpu_torch.tiles.tiler import TileSet

    t0 = time.perf_counter()
    dev = _device_arg(device)
    dirs = {k: os.path.join(workdir, k)
            for k in ("state", "level2", "epochs", "tiles")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    # the same trap the workers run at registration — fired before any
    # process spawns, so a pad-vs-gap override fails in one stack trace
    cfg = scale_scenario(seed, n_files).validate_vane_pad(_VANE_PAD)
    register_scenario(cfg)
    scenario_toml = write_scenario_toml(
        cfg, os.path.join(workdir, "scenario.toml"))
    files = virtual_filelist(cfg)
    names = sorted(os.path.basename(f) for f in files)
    env = _child_env()
    srv = LiveServer(dirs["state"], port=0, stale_s=ttl_s,
                     n_ranks=_N_RANKS).start()

    def spawn(rank: int):
        cmd = [sys.executable, "-m", "comapreduce_tpu_torch.synthetic.loadgen",
               "--worker", f"--scenario={scenario_toml}",
               f"--state-dir={dirs['state']}",
               f"--output-dir={dirs['level2']}", f"--rank={rank}",
               f"--n-ranks={_N_RANKS}", f"--ttl={ttl_s}", "--telemetry",
               f"--device={dev}"]
        return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)

    def wait(pr):
        try:
            stdout, _ = pr.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            pr.kill()
            stdout, _ = pr.communicate()
        return pr.returncode, (stdout or b"").decode(errors="replace")

    def probe() -> int:
        try:
            with urlopen(f"http://{srv.host}:{srv.port}/healthz",
                         timeout=10) as r:
                return r.status
        except URLError as exc:
            code = getattr(exc, "code", None)
            if code is not None:
                return int(code)
            raise

    def poll_until(pred, deadline_s: float, what: str):
        t_start = time.monotonic()
        while True:
            got = pred()
            if got:
                return got
            if time.monotonic() - t_start > deadline_s:
                raise AssertionError(
                    f"scale drill: {what} never happened within "
                    f"{deadline_s:.0f} s")
            time.sleep(0.05)

    server = MapServer(
        dirs["state"], dirs["epochs"], wcs=WCS.from_field(
            (cfg.ra0, cfg.dec0), CDELT, MAP_SHAPE),
        band=0, level2_dir=dirs["level2"], offset_length=50, n_iter=50,
        threshold=1e-5, medfilt_window=51, use_calibration=False,
        warm_start=True, tiles_root=dirs["tiles"], tile_px=16,
        device=dev)
    store = EpochStore(dirs["epochs"])

    procs = {r: spawn(r) for r in range(_N_RANKS)}
    rc, out = {}, {}
    try:
        # -- rank 1 leaves: SIGKILL while it HOLDS a live lease --------
        def rank1_held():
            return [n for n, st in _scan_leases(dirs["state"]).items()
                    if st.get("state") == "claimed"
                    and int(st.get("owner", -1)) == 1]

        leaked = poll_until(rank1_held, 120.0,
                            "rank 1 claiming its first lease")
        procs[1].kill()
        rc[1], out[1] = wait(procs[1])
        t_kill = time.monotonic()
        assert rc[1] == -9, \
            f"scale drill: killed rank exited {rc[1]}, expected " \
            f"SIGKILL (-9):\n{out[1]}"
        # the dead rank's heartbeat freezes: /healthz must flip within
        # one lease TTL (plus poll slack)
        poll_until(lambda: probe() == 503, ttl_s + 3.0,
                   "/healthz flipping 503 after the SIGKILL")
        t_503 = time.monotonic() - t_kill

        # -- a fresh process rejoins as rank 1 mid-run ----------------
        # The rejoin's heartbeat shadows its dead predecessor's file,
        # but the lease layer keys claim liveness on the claimant's
        # PID, not the rank alone (lease.LeaseBoard.expired) — so the
        # leaked unit stays stealable by any rank, including the
        # rejoined one, and the rejoin can enter the live queue
        # immediately instead of waiting out the survivors' drain.
        rejoin = spawn(1)

        # -- publish pressure: fold an epoch while the queue drains ---
        def done_count():
            return sum(1 for st in _scan_leases(dirs["state"]).values()
                       if st.get("state") == "done")

        mid_target = max(3, n_files // 4)
        poll_until(lambda: done_count() >= mid_target, timeout_s,
                   f"{mid_target} commits for the mid-run epoch")
        n_mid = server.poll_once(force=True)
        mid_epoch = store.current()
        mid_census = len(store.census(mid_epoch)) if mid_epoch else 0
        mid_healthz = probe()

        # -- drain ----------------------------------------------------
        for r in (0, 2):
            rc[r], out[r] = wait(procs[r])
        rc["rejoin"], out["rejoin"] = wait(rejoin)
        for r in (0, 2, "rejoin"):
            assert rc[r] == 0, \
                f"scale drill: rank {r} failed ({rc[r]}):\n{out[r]}"
        # the rejoined rank 1's fresh heartbeat (clean .done) is what
        # returns the campaign to healthy
        poll_until(lambda: probe() == 200, 10.0,
                   "/healthz recovering after the rejoin drained")
    finally:
        for pr in list(procs.values()):
            if pr.poll() is None:
                pr.kill()

    # -- exactly-once at the lease layer -------------------------------
    leases = _scan_leases(dirs["state"])
    not_done = sorted(n for n, st in leases.items()
                      if st.get("state") != "done")
    assert sorted(leases) == names and not not_done, \
        f"scale drill: {len(not_done)}/{len(names)} units not done " \
        f"({not_done[:5]}...) — the queue did not drain exactly-once"
    l2 = sorted(_glob.glob(os.path.join(dirs["level2"], "Level2_*.hd5")))
    assert len(l2) == n_files, \
        f"scale drill: {len(l2)} Level-2 products for {n_files} units"

    results = {}
    for r in range(_N_RANKS):
        with open(os.path.join(dirs["state"], f"result.rank{r}.json"),
                  encoding="utf-8") as f:
            results[r] = json.load(f)
    committed_results = sum(r["stats"].get("committed", 0)
                            for r in results.values())
    # the killed process committed its pre-kill units but wrote no
    # result file; the gap is exactly its share
    dead_commits = n_files - committed_results
    assert dead_commits >= 0, \
        f"scale drill: survivor commit counters ({committed_results}) " \
        f"exceed the filelist ({n_files}) — a unit committed twice"
    stolen = sum(r["stats"].get("stolen", 0) for r in results.values())
    assert stolen >= 1, \
        f"scale drill: rank 1 died holding {leaked} but no survivor " \
        f"ledgered a steal (stats: " \
        f"{ {r: v['stats'] for r, v in results.items()} })"
    for n in leaked:
        assert leases[n].get("state") == "done", \
            f"scale drill: leaked unit {n} never recovered"
    rejoin_committed = results[1]["stats"].get("committed", 0)
    if n_files >= 100:
        assert rejoin_committed >= 1, \
            "scale drill: the late-joining rank committed nothing — " \
            "it never actually joined the live queue"

    # -- epochs + tiles: fresh, exactly-once folding --------------------
    n_final = server.poll_once(force=True)
    epochs = store.list_epochs()
    final = store.current()
    assert final == store.latest() and store.census(final) == set(names), \
        f"scale drill: final epoch census {len(store.census(final))} " \
        f"!= campaign {n_files}"
    if n_files >= 48:
        assert len(epochs) >= 2 and mid_census < n_files, \
            f"scale drill: no mid-run epoch under load (epochs " \
            f"{epochs}, mid census {mid_census}/{n_files})"
    folded = []
    for n in epochs:
        folded += list(store.manifest(n).get("new_files", []))
    assert sorted(folded) == names, \
        f"scale drill: epochs folded {len(folded)} files, expected " \
        f"each of {n_files} exactly once"
    led = ServedLedger(os.path.join(dirs["epochs"], "served.jsonl"))
    assert sorted(led.files) == names and len(led) == len(names), \
        "scale drill: admission ledger is not exactly the census"
    ts = TileSet(dirs["tiles"])
    man = ts.manifest(final)
    assert ts.current() == final and man and man["n_tiles"] > 1, \
        f"scale drill: tile tier not current (tiles CURRENT=" \
        f"{ts.current()}, epoch {final})"

    # -- /metrics: the live counters match the scheduler exactly -------
    with urlopen(f"http://{srv.host}:{srv.port}/metrics",
                 timeout=10) as r:
        prom = r.read().decode("utf-8")
    srv.stop()
    per_rank = {}
    for ln in prom.splitlines():
        if ln.startswith("comap_scheduler_committed_total{"):
            label, val = ln.rsplit(" ", 1)
            rk = label.split('rank="')[1].split('"')[0]
            per_rank[int(rk)] = per_rank.get(int(rk), 0.0) + float(val)
    # ranks 0 and 2 drained their telemetry stream cleanly: their live
    # counter must equal their scheduler accounting EXACTLY. rank 1's
    # lane mixes the killed process (buffer lost at SIGKILL) with the
    # rejoined one, so it is bounded, not equal.
    for r in (0, 2):
        want = float(results[r]["stats"].get("committed", 0))
        assert per_rank.get(r) == want, \
            f"scale drill: /metrics committed for rank {r} is " \
            f"{per_rank.get(r)}, scheduler says {want}"
    assert sum(per_rank.values()) <= n_files, \
        f"scale drill: /metrics total {sum(per_rank.values())} " \
        f"exceeds the filelist — a commit double-counted"
    assert "comap_live_healthy 1" in prom, \
        "scale drill: /metrics lacks comap_live_healthy 1 at the end"

    return {
        "n_files": n_files,
        "seed": seed,
        "returncodes": {str(k): v for k, v in rc.items()},
        "t_503_after_kill_s": round(t_503, 3),
        "leaked_units": leaked,
        "stolen": stolen,
        "dead_rank_commits": dead_commits,
        "rejoin_commits": rejoin_committed,
        "commits_by_rank": {r: v["stats"].get("committed", 0)
                            for r, v in results.items()},
        "mid_epoch_census": mid_census,
        "mid_epoch_published": n_mid,
        "mid_healthz": mid_healthz,
        "final_epoch": final,
        "final_published": n_final,
        "epochs": epochs,
        "n_tiles": man["n_tiles"],
        "metrics_committed": per_rank,
        "wall_s": round(time.perf_counter() - t0, 3),
    }


if __name__ == "__main__":
    import sys as _sys

    _argv = _sys.argv[1:]
    if "--worker" in _argv:
        _argv.remove("--worker")
        raise SystemExit(_worker_main(_argv))
    raise SystemExit("usage: python -m "
                     "comapreduce_tpu_torch.synthetic.loadgen --worker "
                     "... (the drill entry is python -m "
                     "comapreduce_tpu_torch.cli.check_resilience "
                     "--synthetic-only)")
