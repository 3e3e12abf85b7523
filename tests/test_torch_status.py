"""The port's campaign status report (``resilience/status.py``), the
control-plane records it reads (``control/decisions.py``, the reading
half of ``control/supervisor.py``) and the operator CLIs over them
(``cli.watchdog_report``, ``cli.campaign_watch status|check``) against
the reference's, on the CPU.

Seeded campaign state directories (numpy): heartbeats fresh, stale and
terminal (``.done``), a sealed quarantine ledger with stalls, hangs,
corruption and steals, claimed, expired, done and torn leases, the queue
manifest, quality records, control decisions and, on some seeds, a
supervisor snapshot (live, stuck or drained: the schema-3 report).
``build_report`` runs at one fixed ``now`` (``time.time`` pinned) and
must equal the reference's report whole; ``report_healthy``, the
rendered watchdog report, the probe's exit codes and line and the
decision ledger agree too. The files are written by the port's writers
and read by both packages.
"""

import json
import os
import signal
import time

import numpy as np
import pytest

import comapreduce_tpu.control.decisions as ref_dec
import comapreduce_tpu.control.supervisor as ref_sup
import comapreduce_tpu.resilience.status as ref_status
import comapreduce_tpu_torch.control.decisions as port_dec
import comapreduce_tpu_torch.control.supervisor as port_sup
import comapreduce_tpu_torch.resilience.status as port_status
from comapreduce_tpu_torch.cli import campaign_watch as port_watch
from comapreduce_tpu_torch.cli import watchdog_report as port_wr
from comapreduce_tpu_torch.resilience.heartbeat import heartbeat_path
from comapreduce_tpu_torch.resilience.lease import LeaseBoard
from comapreduce_tpu_torch.resilience.ledger import QuarantineLedger
from comapreduce_tpu_torch.telemetry import quality as port_q
from tools import campaign_watch as ref_watch
from tools import watchdog_report as ref_wr

TIME_LIMIT_S = 60
STALE_S = 30.0


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded {TIME_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _age(path, seconds, now):
    os.utime(path, (now - seconds, now - seconds))


def campaign_state(directory, seed: int, supervisor: str = "") -> float:
    """Fill ``directory`` with one campaign's state from ``seed``;
    returns the ``now`` the state is aged against. ``supervisor``:
    ``""`` (none), ``"live"``, ``"stuck"`` or ``"drained"``."""
    rng = np.random.default_rng(seed)
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    now = float(int(time.time()))
    n_ranks = int(rng.integers(2, 5))
    for r in range(n_ranks):
        kind = rng.choice(["fresh", "stale", "done"], p=[0.5, 0.3, 0.2])
        age = {"fresh": float(rng.uniform(0, STALE_S / 2)),
               "stale": float(rng.uniform(2 * STALE_S, 10 * STALE_S)),
               "done": float(rng.uniform(0, 10 * STALE_S))}[kind]
        p = heartbeat_path(directory, r)
        with open(p, "w", encoding="utf-8") as f:
            json.dump({"rank": r, "pid": 100 + r, "host": f"h{r}",
                       "seq": int(rng.integers(1, 50)),
                       "stage": "run_tod.done" if kind == "done"
                       else str(rng.choice(["ingest.read",
                                            "stage_chain"])),
                       "unit": f"/data/obs{r}.hd5",
                       "progress": {"files_done": int(rng.integers(9))},
                       "deadline": ({"name": "ingest.read",
                                     "state": "soft", "elapsed_s": 12.5}
                                    if rng.random() < 0.3 else None),
                       "t_wall_unix": now - age}, f)
        _age(p, age, now)
    ledger = QuarantineLedger(os.path.join(directory, "quarantine.jsonl"))
    for i in range(int(rng.integers(3, 9))):
        cls, disp = [("hang", "stalled"), ("hang", "deferred"),
                     ("corrupt", "corrupt"), ("io", "quarantined"),
                     ("", "stolen"), ("", "recovered")][
            int(rng.integers(6))]
        ledger.record(f"/data/obs{int(rng.integers(6))}.hd5",
                      failure_class=cls, disposition=disp,
                      stage=str(rng.choice(["ingest.read",
                                            "stage_chain"])),
                      message=f"event {i}")
    files = [f"/data/obs{i}.hd5" for i in range(int(rng.integers(4, 9)))]
    boards = [LeaseBoard(directory, rank=r, lease_ttl_s=STALE_S)
              for r in range(n_ranks)]
    for i, f in enumerate(files):
        state = rng.choice(["pending", "claimed", "done", "torn"],
                           p=[0.3, 0.3, 0.3, 0.1])
        if state == "pending":
            continue
        board = boards[int(rng.integers(n_ranks))]
        if state == "torn":
            with open(board.path_for(f), "w") as fh:
                fh.write('{"key": "tor')
        else:
            lease = board.claim(f)
            if state == "done":
                board.commit(lease)
        _age(board.path_for(f), float(rng.uniform(0, 4 * STALE_S)), now)
    with open(os.path.join(directory, "queue.json"), "w") as fh:
        json.dump({"files": files}, fh)
    port_q.append_quality(port_q.quality_path(directory, 0), [
        {"schema": 1, "file": f"obs{i}.hd5", "feed": int(fe), "band": 0,
         "t": "2026-01-01T00:00:00Z",
         "fknee_hz": float(rng.uniform(0.01, 2.0)),
         "flags": ["fknee_high"] if rng.random() < 0.4 else [],
         "flagged": False}
        for i, fe in enumerate(rng.integers(0, 19, 4))])
    for i in range(int(rng.integers(0, 4))):
        port_dec.record_decision(directory, "admission", "defer",
                                 f"backlog {i}", writer="rank0",
                                 file=f"obs{i}.hd5")
    if supervisor:
        age = {"live": 1.0, "stuck": 120.0, "drained": 120.0}[supervisor]
        with open(os.path.join(directory, port_sup.SUPERVISOR_FILE),
                  "w") as fh:
            json.dump({"t_unix": now - age, "poll_s": 2.0,
                       "desired_ranks": n_ranks, "live_ranks": [0],
                       "dead_ranks": [], "backlog": 3, "shed_backlog": 1,
                       "files_per_hour": 12.5, "eta_s": 900.0,
                       "drained": supervisor == "drained",
                       "n_decisions": 2,
                       "last_decision": {"loop": "autoscaler",
                                         "action": "spawn",
                                         "reason": "replace dead rank"}},
                      fh)
    return now


@pytest.fixture
def pinned_now(monkeypatch):
    """Pin ``time.time`` (both packages read the same clock) so ages,
    staleness and lease expiry are computed at one instant."""
    def pin(now):
        monkeypatch.setattr(time, "time", lambda: now)
    return pin


CASES = [(seed, sup) for seed in range(6) for sup in ("", "live")] + [
    (7, "stuck"), (8, "drained")]


@pytest.mark.parametrize("seed,supervisor", CASES,
                         ids=[f"{s}-{v or 'none'}" for s, v in CASES])
def test_build_report_matches_reference(tmp_path, pinned_now, seed,
                                        supervisor):
    now = campaign_state(tmp_path / "logs", seed, supervisor)
    pinned_now(now + 0.5)
    for root in (str(tmp_path), str(tmp_path / "logs")):
        # the output dir resolves to its logs/ child, as the reference's
        assert port_status.resolve_state_dir(root) == \
            ref_status.resolve_state_dir(root)
        for n_ranks in (0, 5):
            got = port_status.build_report(root, stale_s=STALE_S,
                                           n_ranks=n_ranks)
            want = ref_status.build_report(root, stale_s=STALE_S,
                                           n_ranks=n_ranks)
            assert got == want
            assert port_status.report_healthy(got) == \
                ref_status.report_healthy(want)
            assert port_wr.render_text(got) == ref_wr.render_text(want)
    assert got["schema"] == (3 if supervisor else 2)
    if supervisor == "stuck":
        assert got["supervisor"]["stuck"] is True
        assert port_status.report_healthy(got) is False
    if supervisor == "drained":
        assert got["supervisor"]["stuck"] is False


def _ref_fsck(text: str) -> str:
    """The port's report with its fsck command named as the reference
    names its own: the two packages send the operator to their own tool
    (``tools/campaign_fsck.py`` needs JAX)."""
    port = "python -m comapreduce_tpu_torch.cli.campaign_fsck"
    assert "tools/campaign_fsck.py" not in text
    return text.replace(port, "tools/campaign_fsck.py")


@pytest.mark.parametrize("seed", range(4))
def test_probe_cli_matches_reference(tmp_path, pinned_now, capsys, seed):
    now = campaign_state(tmp_path, seed, "live" if seed % 2 else "")
    pinned_now(now + 0.5)
    for argv in (["check", str(tmp_path), "--stale-s", str(STALE_S)],
                 ["status", str(tmp_path), "--stale-s", str(STALE_S)],
                 ["status", str(tmp_path), "--json", "--n-ranks", "3"]):
        rc = port_watch.main(argv)
        got = capsys.readouterr().out
        assert rc == ref_watch.main(argv)
        assert _ref_fsck(got) == capsys.readouterr().out, argv
    rc = port_wr.main([str(tmp_path), "--stale-s", str(STALE_S)])
    got = capsys.readouterr().out
    assert rc == ref_wr.main([str(tmp_path), "--stale-s", str(STALE_S)])
    assert _ref_fsck(got) == capsys.readouterr().out
    rep = port_status.build_report(str(tmp_path), stale_s=STALE_S)
    assert rc == (0 if port_status.report_healthy(rep) else 1)


def test_empty_state_dir_is_healthy(tmp_path, capsys):
    rep = port_status.build_report(str(tmp_path))
    assert rep["schema"] == 2 and rep["ranks"] == []
    assert port_status.report_healthy(rep)
    assert port_watch.main(["check", str(tmp_path)]) == 0
    assert "healthy" in capsys.readouterr().out


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_decision_ledger_reads_the_same(tmp_path, writer):
    dec = port_dec if writer == "port" else ref_dec
    for i, loop in enumerate(("autoscaler", "admission", "solver")):
        dec.record_decision(str(tmp_path), loop, "spawn", f"why {i}",
                            writer="supervisor" if i % 2 else "rank0",
                            rank=i)
    with open(port_dec.decisions_path(str(tmp_path), "rank0"), "a") as f:
        f.write('{"loop": "x", "act')  # torn
    got, want = (port_dec.read_decisions(str(tmp_path)),
                 ref_dec.read_decisions(str(tmp_path)))
    assert got == want
    assert [d["loop"] for d in got] == ["autoscaler", "admission",
                                        "solver"]
    assert port_dec.decisions_paths(str(tmp_path)) == \
        ref_dec.decisions_paths(str(tmp_path))
    assert port_dec.read_decisions(
        port_dec.decisions_path(str(tmp_path), "supervisor")) == [got[1]]


@pytest.mark.parametrize("snap,age", [
    (None, 0.0), ({"poll_s": 2.0}, 5.0), ({"poll_s": 2.0}, 25.0),
    ({"poll_s": 2.0, "drained": True}, 500.0), ({}, 30.0)])
def test_supervisor_snapshot_rules(tmp_path, snap, age):
    now = 1.0e9
    if snap is not None:
        with open(os.path.join(tmp_path, port_sup.SUPERVISOR_FILE),
                  "w") as f:
            json.dump(dict(snap, t_unix=now - age), f)
    got = port_sup.read_supervisor(str(tmp_path))
    assert got == ref_sup.read_supervisor(str(tmp_path))
    assert port_sup.supervisor_stuck(got, now) == \
        ref_sup.supervisor_stuck(got, now)
    assert port_sup.SUPERVISOR_FILE == ref_sup.SUPERVISOR_FILE


@pytest.mark.parametrize("seed", range(3))
def test_shed_backlog_matches_reference(tmp_path, seed):
    rng = np.random.default_rng(seed)
    ledger = QuarantineLedger(os.path.join(tmp_path, "quarantine.jsonl"))
    for _ in range(12):
        ledger.record(f"/d/obs{int(rng.integers(5))}.hd5",
                      disposition=str(rng.choice(["deferred", "readmitted",
                                                  "quarantined"])),
                      failure_class="slo")
    assert port_sup.shed_backlog(str(tmp_path)) == \
        ref_sup.shed_backlog(str(tmp_path))
    assert port_sup.shed_backlog(str(tmp_path / "none")) == 0
