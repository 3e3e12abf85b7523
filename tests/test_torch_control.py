"""The port's control plane (``comapreduce_tpu_torch/control/``) against
the reference's (``comapreduce_tpu/control/``) on the CPU.

Each case of ``tests/test_control.py`` runs the same scenario through
both packages and holds the port to the reference's transcript as well
as to the reference test's own assertions:

- ``[control]``: defaults off, strict coercion, INI strings, validation;
- the decision ledger round trip, across packages;
- the autoscale policy (replace the dead with fresh ids, fill to the
  floor, cooldown, target rate, advisory retire, the ``max_ranks`` cap);
- the supervisor's sense cycle (a crashed rank's final beat never reads
  alive, a just-spawned child without a beat is starting, the snapshot
  and the stuck rule) and its operator CLI;
- admission control (hysteresis, the flag gate, the real elastic
  scheduler shedding ``deferred`` and re-admitting, the uncontrolled
  schedule when off) and ``Runner``'s ``[control]``;
- ``choose_solver`` (no evidence, the cheapest healthy rung, off a sick
  rung, the registry delta). The port has no program cost model
  (``telemetry/programs`` is not ported): where the reference halves
  ``pair_batch`` on a ``programs.jsonl`` record, the port keeps it;
- ``RankManager`` over real child processes;
- the supervisor over real ranks on the control drill's smallest
  campaign (two workers it spawns drain four units), in both packages;
- ``run_control_drill`` (12 files and 3 spikes, 4 ranks, 2 SIGKILLed at
  their third claim) in both packages and, at a second seed, in the
  port: ``slow``, as the reference marks its own run.
"""

import importlib
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("comapreduce_tpu", "comapreduce_tpu_torch")


def _mods(pkg: str):
    names = ("control.config", "control.decisions", "control.autoscaler",
             "control.supervisor", "control.admission", "control.policy",
             "control.manager", "pipeline.scheduler", "resilience.ledger",
             "resilience.heartbeat", "resilience.status")
    return SimpleNamespace(pkg=pkg, **{
        n.split(".")[1]: importlib.import_module(f"{pkg}.{n}")
        for n in names})


REF, PORT = (_mods(p) for p in PKGS)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (the suite's workers share the
    cores); the old count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakeManager:
    """RankManager stand-in: scripted reaps, recorded spawns."""

    def __init__(self):
        self.to_reap = []
        self.live = []
        self.spawned = []
        self.exited = []

    def reap(self):
        out, self.to_reap = self.to_reap, []
        self.exited.extend(out)
        return out

    def live_ranks(self):
        return list(self.live)

    def all_ranks(self):
        return sorted(set(self.live) | {r for r, _ in self.exited}
                      | set(self.spawned))

    def spawn(self, rank):
        self.spawned.append(int(rank))
        self.live.append(int(rank))
        return 12345


def _beat(m, directory, rank, seq=1):
    p = m.heartbeat.heartbeat_path(str(directory), rank)
    with open(p, "w", encoding="utf-8") as f:
        json.dump({"rank": rank, "seq": seq, "t_wall_unix": time.time()}, f)


def _manifest(directory, files):
    with open(os.path.join(str(directory), "queue.json"), "w",
              encoding="utf-8") as f:
        json.dump({"schema": 1, "n": len(files),
                   "files": [os.path.basename(x) for x in files],
                   "t_wall": "2026-08-07T00:00:00Z"}, f)


def _both(tmp_path, scenario):
    """``scenario(m, dir)`` through each package in its own directory;
    the two transcripts must be equal."""
    out = []
    for m in (REF, PORT):
        d = tmp_path / m.pkg
        d.mkdir()
        out.append(scenario(m, d))
    assert out[1] == out[0]
    return out[1]


# -- [control] config ------------------------------------------------------

CONFIGS = [None, {"autoscael": True},
           {"autoscale": "true", "admission": "no", "min_ranks": "2",
            "max_ranks": "4", "poll_s": "0.5"},
           {"min_ranks": 0}, {"min_ranks": 4, "max_ranks": 2},
           {"shed_low_water": 9, "shed_high_water": 4}, {"poll_s": 0},
           {"cooldown_s": -1}, {"admission": 1, "solver_policy": "on"}]


@pytest.mark.parametrize("value", CONFIGS,
                         ids=[f"cfg{i}" for i in range(len(CONFIGS))])
def test_config_coerces_like_the_reference(value):
    def coerce(m):
        try:
            cfg = m.config.ControlConfig.coerce(value)
        except ValueError as exc:
            return ("ValueError", str(exc))
        assert m.config.ControlConfig.coerce(cfg) is cfg
        return (repr(cfg), cfg.enabled)

    got, want = coerce(PORT), coerce(REF)
    assert got == want
    if value is None:
        assert got[1] is False
    if value == CONFIGS[2]:
        assert got[1] is True


def test_decisions_cross_packages_and_drop_torn_lines(tmp_path):
    REF.decisions.record_decision(str(tmp_path), "autoscaler", "spawn",
                                  "r0", ranks=[4])
    PORT.decisions.record_decision(str(tmp_path), "admission", "defer",
                                   "r1", writer="rank2", file="x.hd5")
    with open(tmp_path / "decisions.rank2.jsonl", "a",
              encoding="utf-8") as f:
        f.write('{"loop": "adm')
    got = PORT.decisions.read_decisions(str(tmp_path))
    assert got == REF.decisions.read_decisions(str(tmp_path))
    assert [g["action"] for g in got] == ["spawn", "defer"]
    assert got[0]["ranks"] == [4] and got[1]["file"] == "x.hd5"


# -- autoscale policy ------------------------------------------------------

def _policy(m, clock, **kw):
    return m.autoscaler.AutoscalePolicy(
        m.config.ControlConfig(autoscale=True, **kw), clock=clock)


def _d(d):
    return None if d is None else (d.action, tuple(d.ranks), d.reason)


POLICY = {
    "replace_dead": (dict(min_ranks=2, max_ranks=8, cooldown_s=1e9), [
        ("decide", dict(backlog=5, live_ranks=[2, 3], dead_ranks=[0, 1])),
        ("decide", dict(backlog=5, live_ranks=[2, 3], dead_ranks=[0],
                        reserved_ranks=[7]))]),
    "dead_no_backlog": (dict(min_ranks=1), [
        ("decide", dict(backlog=0, live_ranks=[1], dead_ranks=[0]))]),
    "floor": (dict(min_ranks=4, max_ranks=8, cooldown_s=1e9), [
        ("decide", dict(backlog=10, live_ranks=[0]))]),
    "cooldown": (dict(min_ranks=1, max_ranks=8, cooldown_s=30.0), [
        ("decide", dict(backlog=10, live_ranks=[0])),
        ("decide", dict(backlog=10, live_ranks=[0, 1])),
        ("advance", 31.0),
        ("decide", dict(backlog=10, live_ranks=[0, 1])),
        ("advance", 31.0), ("note", None),
        ("decide", dict(backlog=10, live_ranks=[0, 1, 2]))]),
    "target_rate": (dict(min_ranks=1, max_ranks=8,
                         target_files_per_hour=100.0, cooldown_s=0.0), [
        ("decide", dict(backlog=1, live_ranks=[0], files_per_hour=10.0)),
        ("decide", dict(backlog=1, live_ranks=[0],
                        files_per_hour=200.0))]),
    "retire": (dict(min_ranks=1, max_ranks=8), [
        ("decide", dict(backlog=0, live_ranks=[0, 1, 2])),
        ("decide", dict(backlog=0, live_ranks=[0, 1, 2])),
        ("decide", dict(backlog=3, live_ranks=[0, 1, 2])),
        ("decide", dict(backlog=0, live_ranks=[0, 1, 2]))]),
    "max_ranks": (dict(min_ranks=1, max_ranks=2, cooldown_s=0.0), [
        ("decide", dict(backlog=50, live_ranks=[0, 1])),
        ("decide", dict(backlog=50, live_ranks=[0, 1], dead_ranks=[2]))]),
}


@pytest.mark.parametrize("case", list(POLICY))
def test_autoscale_policy_decides_like_the_reference(case):
    cfg, steps = POLICY[case]
    runs = []
    for m in (REF, PORT):
        clock = FakeClock()
        pol = _policy(m, clock, **cfg)
        out = []
        for op, arg in steps:
            if op == "decide":
                out.append(_d(pol.decide(**arg)))
            elif op == "advance":
                clock.advance(arg)
            else:
                pol.note_spawned()
        runs.append(out)
    assert runs[1] == runs[0]
    got = runs[1]
    if case == "replace_dead":
        assert got[0][:2] == ("spawn", (4, 5)) and got[1][1] == (8,)
    elif case == "cooldown":
        assert got[0][1] == (1,) and got[1] is None
        assert got[2][1] == (2,) and got[3] is None
    elif case == "retire":
        assert got[0][:2] == ("retire", (1, 2)) and got[1] is None
        assert got[3][0] == "retire"
    elif case in ("dead_no_backlog", "max_ranks"):
        assert got[-1] is None


# -- the supervisor ---------------------------------------------------------

def _snap(s: dict) -> dict:
    return {k: v for k, v in s.items()
            if k not in ("t_unix", "t_wall", "last_decision")}


def test_crashed_ranks_final_beat_never_reads_alive(tmp_path):
    def scenario(m, d):
        clock = FakeClock()
        mgr = FakeManager()
        cfg = m.config.ControlConfig(autoscale=True, min_ranks=1,
                                     max_ranks=4, liveness_ttl_s=1000.0)
        sup = m.supervisor.Supervisor(str(d), cfg, manager=mgr,
                                      lease_ttl_s=5.0, clock=clock)
        _manifest(d, ["a.hd5", "b.hd5"])
        mgr.live = [0]
        _beat(m, d, 0, seq=1)
        sup.sense()
        clock.advance(0.5)
        _beat(m, d, 0, seq=2)
        s1 = sup.sense()
        mgr.live = []
        mgr.to_reap = [(0, -9)]
        s2 = sup.sense()
        snap = sup.step()
        s3 = sup.sense()
        return [_snap(s1), _snap(s2), _snap(snap),
                snap["last_decision"]["action"], list(mgr.spawned),
                s3["dead_ranks"]]

    s1, s2, snap, action, spawned, dead = _both(tmp_path, scenario)
    assert s1["live_ranks"] == [0] and s1["dead_ranks"] == []
    assert s2["live_ranks"] == [] and s2["dead_ranks"] == [0]
    assert action == "spawn" and spawned and spawned[0] != 0
    assert dead == []


def test_just_spawned_child_without_heartbeat_counts_live(tmp_path):
    def scenario(m, d):
        mgr = FakeManager()
        cfg = m.config.ControlConfig(autoscale=True, min_ranks=2,
                                     max_ranks=4)
        sup = m.supervisor.Supervisor(str(d), cfg, manager=mgr,
                                      lease_ttl_s=5.0, clock=FakeClock())
        _manifest(d, ["a.hd5", "b.hd5", "c.hd5"])
        for _ in range(3):
            sup.step()
        return sorted(mgr.spawned)

    assert _both(tmp_path, scenario) == [0, 1]


def test_supervisor_snapshot_and_stuck_rule(tmp_path):
    def scenario(m, d):
        sv = m.supervisor
        assert sv.read_supervisor(str(d)) is None
        sup = sv.Supervisor(str(d), m.config.ControlConfig(autoscale=True),
                            manager=None, lease_ttl_s=5.0,
                            clock=FakeClock())
        _manifest(d, ["a.hd5"])
        snap = sup.step()
        return [_snap(sv.read_supervisor(str(d))), snap["drained"],
                sv.supervisor_stuck(snap, now=snap["t_unix"] + 1.0),
                sv.supervisor_stuck(snap, now=snap["t_unix"] + 1e4),
                sv.supervisor_stuck({"drained": True, "t_unix": 0.0,
                                     "poll_s": 1.0}),
                sv.supervisor_stuck(None), sv.shed_backlog(str(d))]

    got = _both(tmp_path, scenario)
    assert got[0]["backlog"] == 1
    assert got[1:] == [False, False, True, False, False, 0]


def test_status_report_reads_a_port_supervisor(tmp_path):
    """A snapshot the port's supervisor published turns the campaign
    report to schema 3 in both packages."""
    sup = PORT.supervisor.Supervisor(
        str(tmp_path), PORT.config.ControlConfig(autoscale=True),
        manager=None, lease_ttl_s=5.0)
    _manifest(tmp_path, ["a.hd5"])
    sup.step()
    reps = [m.status.build_report(str(tmp_path), stale_s=60.0)
            for m in (REF, PORT)]
    for rep in reps:
        assert rep["schema"] == 3 and not rep["supervisor"]["stuck"]
    assert reps[1]["supervisor"] == reps[0]["supervisor"]


def test_supervisor_cli_observes_like_the_reference(tmp_path):
    """``python -m <package>.control.supervisor STATE --json`` without a
    spawn command observes (decides, spawns nothing) until ``--max-s``:
    the same exit code (1: the queue did not drain) and snapshot."""
    out = []
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        _manifest(d, ["a.hd5", "b.hd5"])
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.control.supervisor", str(d),
             "--json", "--poll-s=0.05", "--max-s=1"],
            capture_output=True, text=True, cwd=REPO, timeout=120,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        snap = _snap(json.loads(proc.stdout.strip().splitlines()[-1]))
        # one decision a poll: how many polls fit in --max-s is the
        # host's speed (the reference's first poll imports JAX)
        assert snap.pop("n_decisions") >= 1
        out.append((proc.returncode, snap))
    assert out[1] == out[0]
    rc, snap = out[1]
    assert rc == 1 and snap["backlog"] == 2 and not snap["drained"]


# -- admission control -----------------------------------------------------

def test_admission_hysteresis_and_flag_gate(tmp_path):
    def scenario(m, d):
        cfg = m.config.ControlConfig(admission=True, shed_high_water=4,
                                     shed_low_water=1)
        gate = m.admission.AdmissionController(cfg, str(d), rank=2,
                                               flagged=["/x/bad.hd5"])
        out = [gate.should_defer("bad.hd5", 3),
               gate.should_defer("good.hd5", 4),
               gate.should_defer("bad.hd5", 4),
               gate.should_defer("bad.hd5", 2), gate.pressure_cleared(2),
               gate.pressure_cleared(1), gate.should_defer("bad.hd5", 1)]
        acts = [x["action"] for x in m.decisions.read_decisions(str(d))]
        return [o if not isinstance(o, str) else "defer" for o in out], acts

    got, acts = _both(tmp_path, scenario)
    assert got == [None, None, "defer", "defer", False, True, None]
    assert acts == ["shed_on", "defer", "defer", "shed_off"]


@pytest.mark.parametrize("admission", [True, False], ids=["on", "off"])
def test_scheduler_admission_like_the_reference(tmp_path, admission):
    """On: the flagged unit is released ``deferred`` under pressure and
    re-admitted and committed last, exactly once. Off: the uncontrolled
    claim order and no control artifacts."""
    files = ["/d/obs-0.hd5", "/d/obs-1.hd5", "/d/flagged.hd5",
             "/d/obs-3.hd5"]

    def scenario(m, d):
        gate = None
        if admission:
            cfg = m.config.ControlConfig(admission=True, shed_high_water=2,
                                         shed_low_water=0)
            gate = m.admission.AdmissionController(
                cfg, str(d), rank=0, flagged=["flagged.hd5"])
        ledger = m.ledger.QuarantineLedger(str(d / "quarantine.rank0.jsonl"))
        s = m.scheduler.Scheduler(files, str(d), rank=0, n_ranks=1,
                                  lease_ttl_s=5.0, poll_s=0.01,
                                  ledger=ledger, admission=gate)
        got = [f for f in s.claim_iter() if s.commit(f)]
        disps = [e.disposition for e in ledger.entries]
        return (got, {k: s.stats[k] for k in ("deferred", "readmitted",
                                              "committed")}, disps,
                sorted(p.name for p in d.glob("decisions.*.jsonl")))

    got, stats, disps, decisions = _both(tmp_path, scenario)
    assert sorted(got) == sorted(files) and stats["committed"] == 4
    if admission:
        assert got[-1] == "/d/flagged.hd5"
        assert stats["deferred"] == stats["readmitted"] == 1
        assert disps == ["deferred", "readmitted"] and decisions
    else:
        assert got == files and stats["deferred"] == 0 and not decisions


def test_runner_admission_gate_coercion(tmp_path):
    from comapreduce_tpu.pipeline.runner import Runner as RefRunner
    from comapreduce_tpu_torch.pipeline.runner import Runner

    class Res:
        state_dir = str(tmp_path)

    cfg = {"Global": {"processes": [], "output_dir": str(tmp_path)},
           "control": {"admission": True, "shed_high_water": 9}}
    for cls, m, kw in ((RefRunner, REF, {}), (Runner, PORT,
                                              {"device": "cpu"})):
        r = cls.from_config(dict(cfg), **kw)
        assert isinstance(r.control, m.config.ControlConfig)
        assert r.control.admission and r.control.shed_high_water == 9
        gate = r._admission_gate(Res())
        assert isinstance(gate, m.admission.AdmissionController)
        assert gate.cfg.shed_high_water == 9
        r2 = cls.from_config({"Global": {"processes": [],
                                         "output_dir": str(tmp_path)}},
                             **kw)
        assert not r2.control.enabled and r2._admission_gate(Res()) is None
    with pytest.raises(ValueError, match="unknown"):
        Runner.from_config({"Global": {"processes": []},
                            "control": {"admision": True}}, device="cpu")


# -- solver policy ---------------------------------------------------------

def _solves(rung, n, iters, converged=True, stalled=False):
    return [{"schema": 1, "kind": "solve", "band": "band0",
             "n_iter": iters, "residual": 1e-7,
             "converged": converged, "diverged": False,
             "stalled": stalled, "stalled_at": None, "base": 0,
             "precond_id": f"{rung}|block=8", "precision_id": ""}
            for _ in range(n)]


def _write_trace(d, records):
    with open(d / "solver.rank0.jsonl", "w", encoding="utf-8") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def test_rung_order_mirrors_the_destriper_config():
    from comapreduce_tpu.mapmaking.destriper import CONFIG_PRECONDITIONERS

    assert PORT.policy.RUNG_ORDER == REF.policy.RUNG_ORDER == \
        tuple(CONFIG_PRECONDITIONERS)


SOLVER = {
    "no_evidence": ([], {"preconditioner": "jacobi"}, True, False),
    "cheapest_healthy": (_solves("jacobi", 3, 12)
                         + _solves("multigrid", 3, 30),
                         {"preconditioner": "multigrid", "mg_block": 8},
                         True, False),
    "sick_rung": (_solves("jacobi", 2, 400, converged=False, stalled=True)
                  + _solves("twolevel", 2, 40),
                  {"preconditioner": "jacobi"}, False, False),
    "registry_delta": (_solves("twolevel", 2, 60),
                       {"preconditioner": "twolevel"}, False, True),
}


@pytest.mark.parametrize("case", list(SOLVER))
def test_choose_solver_like_the_reference(tmp_path, case):
    records, static, record, registry = SOLVER[case]

    def scenario(m, d):
        _write_trace(d, records)
        reg = ""
        if registry:
            reg = str(d / "runs.jsonl")
            with open(reg, "w", encoding="utf-8") as f:
                for _ in range(5):
                    f.write(json.dumps(
                        {"kind": "perf",
                         "metrics": {"destriper_cg_iters": 20}}) + "\n")
        out = m.policy.choose_solver(str(d), static=dict(static),
                                     registry_path=reg, record=record)
        dec = [{k: x[k] for k in ("loop", "action", "knob", "old", "new")}
               for x in m.decisions.read_decisions(str(d))]
        return out, dec

    out, dec = _both(tmp_path, scenario)
    if case == "no_evidence":
        assert out == {"reasons": []} and not dec
    elif case == "cheapest_healthy":
        assert out["preconditioner"] == "jacobi"
        assert dec[0]["loop"] == "solver" and dec[0]["knob"] == \
            "preconditioner"
    elif case == "sick_rung":
        assert out["preconditioner"] == "twolevel" and not dec
    else:
        assert out["preconditioner"] == "multigrid" and out["mg_block"] == 8


def test_choose_solver_reads_no_program_cost_model(tmp_path):
    """The reference halves ``pair_batch`` on a ``programs.jsonl`` record
    over its budget; the port has no program records
    (``telemetry/programs`` is not ported) and keeps it."""
    _write_trace(tmp_path, _solves("jacobi", 2, 10))
    with open(tmp_path / "programs.jsonl", "w", encoding="utf-8") as f:
        f.write(json.dumps({"schema": 1, "kind": "program",
                            "name": "planned_matvec",
                            "shape_bucket": "f32[1048576]x8",
                            "temp_bytes": (2 << 30) + 1}) + "\n")
    static = {"preconditioner": "jacobi", "pair_batch": 8}
    ref = REF.policy.choose_solver(str(tmp_path), static=static,
                                   record=False)
    port = PORT.policy.choose_solver(str(tmp_path), static=static,
                                     record=False)
    assert ref["pair_batch"] == 4
    assert port == {"reasons": []}


# -- the rank manager -------------------------------------------------------

def test_rank_manager_spawns_reaps_and_terminates(tmp_path):
    def scenario(m, d):
        def argv(rank):
            code = ("import sys, time; time.sleep(60)" if rank == 1
                    else f"import sys; sys.exit({rank + 3})")
            return [sys.executable, "-c", code]

        mgr = m.manager.RankManager(argv, log_dir=str(d / "logs"))
        mgr.spawn(1)
        pid = mgr.spawn(1)
        assert mgr.spawn(1) == pid  # a live rank is never spawned twice
        mgr.spawn(0)
        deadline = time.monotonic() + 60
        done = []
        while not done and time.monotonic() < deadline:
            done = mgr.reap()
            time.sleep(0.05)
        live = mgr.live_ranks()
        mgr.terminate_all(timeout_s=5.0)
        return (done, live, mgr.live_ranks(), mgr.all_ranks(),
                sorted(os.listdir(d / "logs")))

    done, live, after, ranks, logs = _both(tmp_path, scenario)
    assert done == [(0, 3)] and live == [1] and after == []
    assert ranks == [0, 1] and logs == ["rank0.out", "rank1.out"]


# -- the supervisor over real ranks, and the end-to-end control drill ------

def test_supervised_smallest_campaign_like_the_reference(tmp_path):
    """The control drill's machinery on its smallest campaign, with no
    fault to time: the supervisor's floor fill spawns two real workers
    (``python -m <package>.control.drill --worker``) through a
    ``RankManager``, they drain four queued units through the elastic
    scheduler and the admission gate, and the supervisor sees the queue
    drained; every lease done once, by the ranks it spawned."""
    from comapreduce_tpu_torch.resilience.drill import _child_env

    def scenario(m, d):
        files = [str(d / f"Level2_small-{i:04d}.hd5") for i in range(4)]
        flist = d / "filelist.txt"
        flist.write_text("\n".join(files) + "\n")
        _manifest(d, files)

        def argv(rank):
            return [sys.executable, "-m", f"{m.pkg}.control.drill",
                    "--worker", f"--rank={rank}", "--n-ranks=2",
                    f"--state-dir={d}", f"--filelist={flist}", "--ttl=5",
                    "--hold-s=0.05", "--shed-high=16", "--shed-low=4"]

        mgr = m.manager.RankManager(argv, env=_child_env(
            JAX_PLATFORMS="cpu"), log_dir=str(d / "logs"))
        cfg = m.config.ControlConfig(autoscale=True, min_ranks=2,
                                     max_ranks=2, cooldown_s=30.0,
                                     poll_s=0.2, liveness_ttl_s=60.0)
        sup = m.supervisor.Supervisor(str(d), cfg, manager=mgr,
                                      lease_ttl_s=5.0)
        try:
            snap = sup.run(max_s=240.0)
        finally:
            mgr.terminate_all()
        lease = importlib.import_module(f"{m.pkg}.resilience.lease")
        done = sorted(lease.read_lease(lease.lease_path(
            str(d), lease.lease_key(f)))["state"] for f in files)
        committed = []
        for r in (0, 1):
            with open(d / f"result.rank{r}.json") as f:
                committed += json.load(f)["committed"]
        spawns = [x["ranks"] for x in m.decisions.read_decisions(str(d))
                  if x["action"] == "spawn"]
        return (snap["drained"], snap["n_done"], done, sorted(committed),
                spawns, sorted(mgr.exited))

    drained, n_done, done, committed, spawns, exited = _both(tmp_path,
                                                             scenario)
    assert drained and n_done == 4 and done == ["done"] * 4
    assert committed == [f"Level2_small-{i:04d}.hd5" for i in range(4)]
    assert spawns == [[0, 1]] and exited == [(0, 0), (1, 0)]


_EV_KEYS = ("control_drained", "control_n_done", "control_replaced",
            "control_shed", "control_committed_metric",
            "control_map_byte_identical")


@pytest.mark.slow
def test_control_drill_matches_reference(tmp_path):
    """The end-to-end drill (the reference's is ``slow``: its SIGKILLs
    land on each rank's third claim, a race a loaded host can lose) in
    both packages at seed 0."""
    from comapreduce_tpu.control.drill import run_control_drill as ref
    from comapreduce_tpu_torch.control.drill import run_control_drill

    want = ref(str(tmp_path / "ref"), seed=0)
    got = run_control_drill(str(tmp_path / "port"), seed=0, device="cpu")
    for key in _EV_KEYS:
        assert got[key] == want[key], key
    assert got["control_drained"] and got["control_n_done"] == 15
    assert got["control_replaced"] == [0, 1]
    assert len(got["control_spawned"]) >= 2
    assert got["control_supervisor_snapshot"]["shed_backlog"] == 0


@pytest.mark.slow
def test_control_drill_end_to_end(tmp_path):
    """The reference's slow acceptance drill, on the port, at seed 1."""
    from comapreduce_tpu_torch.control.drill import run_control_drill

    ev = run_control_drill(str(tmp_path), seed=1, device="cpu")
    assert ev["control_drained"] and ev["control_n_done"] == 15
    assert ev["control_replaced"] == [0, 1]
    assert len(ev["control_spawned"]) >= 2
    assert len(ev["control_shed"]) == 3
    assert ev["control_committed_metric"] == 15.0
    assert ev["control_map_byte_identical"]
    assert ev["control_supervisor_snapshot"]["shed_backlog"] == 0


def test_control_drill_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    from comapreduce_tpu_torch.control.drill import run_control_drill

    if torch.cuda.is_available():
        pytest.skip("a card is present: the drill would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_control_drill(str(tmp_path))
    assert not os.listdir(tmp_path)
