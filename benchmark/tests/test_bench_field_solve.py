"""The field cell ``field32.solve`` at the staged field cell's small size
on the CPU: a whole run is correct and reports its end-to-end metrics, a
planted answer fault turns ``correct`` false, and the joint readers read
the program's capture (and nothing without it)."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark import trace as tr
from benchmark.inputs import field as gen
from conftest import SMALL as SMALL_CELLS

CELL = "field32.solve"
SMALL = SMALL_CELLS["field32.joint"]
SPAN_READERS = ("upload_s.field32", "h2d_gbs.field32",
                "host_prep_s.field32", "cg_iter_ms.field32")
READERS = SPAN_READERS + ("cg_iters.field32", "k3_roofline.field32",
                          "device_idle.field32")
MS = 1_000_000        # ns


def _run():
    return harness.run(CELL, 2**31 + 4242, 0.3, False, device="cpu",
                       sizes=SMALL)


def test_a_run_is_correct_and_reports_its_metrics():
    out = _run()
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"tod_samples_per_sec", "setup_s"}
    assert out["metrics"]["tod_samples_per_sec"]["value"] > 0
    assert out["metrics"]["tod_samples_per_sec"]["unit"] == "samples/s"
    assert list(out)[-1] == "compared"
    assert set(out["compared"]) == {"offsets", "map", "naive"}
    names = {m["name"] for m in harness.load_cell(CELL).per_layer}
    assert names == set(READERS)


def test_samples_a_solve_are_every_band_in_whole_offsets():
    cell = harness.load_cell(CELL)
    cell.sizes.update(SMALL)
    drv = harness.load_driver(cell.traffic["driver"]).Driver(
        cell.sizes, cell.traffic, 7, torch.device("cpu"))
    n = SMALL["n_obs"] * SMALL["n_feeds"] * gen.stream_samples(cell.sizes)
    assert drv.samples_a_solve() == 4 * n
    e2e = drv.end_to_end([{}, {}, {}], 2.0)
    assert e2e == {"tod_samples_per_sec": 4 * n * 3 / 2.0}


def test_a_planted_answer_fault_turns_correct_false(monkeypatch):
    from comapreduce_tpu_torch.cli import run_destriper
    orig = run_destriper._expand_joint_results

    def altered(res, uniq, npix, nb):
        out = orig(res, uniq, npix, nb)
        out[0].destriped_map[uniq[0]] += 1.0
        return out
    monkeypatch.setattr(run_destriper, "_expand_joint_results", altered)
    out = _run()
    assert not out["correct"]
    assert out["failed"] == out["attempted"] > 0


def _trace():
    """A window of 100 ms whose device work is a 10 ms upload and a 40 ms
    kernel."""
    return tr.analyse([("Memcpy HtoD (Pageable -> Device)", 0, 10 * MS),
                       ("kernel", 10 * MS, 50 * MS)],
                      [("window", 0, 100 * MS), ("solve", 0, 100 * MS)])


def _ctx(cap, records, trace):
    # a CPU run's K3 probe records no call (its shapes are the card's)
    probes = {n: cap for n in SPAN_READERS}
    probes["k3_roofline.field32"] = []
    return SimpleNamespace(cell=CELL, sizes=SMALL, records=records,
                           trace=trace, probes=probes)


@pytest.fixture(scope="module")
def captured():
    """Two solves of the cell's driver under the program's capture."""
    from comapreduce_tpu_torch.telemetry.core import TELEMETRY

    cell = harness.load_cell(CELL)
    cell.sizes.update(SMALL)
    drv = harness.load_driver(cell.traffic["driver"]).Driver(
        cell.sizes, cell.traffic, 11, torch.device("cpu"))
    with TELEMETRY.capture() as cap:
        records = [drv.step(), drv.step()]
    drv.release()
    return drv, cap, records


def test_readers_on_a_cpu_capture(captured):
    drv, cap, records = captured
    ctx = _ctx(cap, records, _trace())
    vals = {n: harness.load_metric(n).read(ctx) for n in READERS}
    for n in SPAN_READERS:
        assert vals[n] is not None and vals[n] > 0, n
    assert vals["h2d_gbs.field32"] == pytest.approx(
        8 * drv.samples_a_solve() * 2 / 0.010 / 1e9)
    assert vals["cg_iters.field32"] == records[0]["n_iter"] > 0
    assert vals["device_idle.field32"] == pytest.approx(50.0)
    assert vals["k3_roofline.field32"] is None


def _span(sid, name, parent, t0, t1):
    return {"name": name, "id": sid, "parent": parent, "root": 1,
            "tid": "MainThread", "t0": t0 * MS, "t1": t1 * MS, "attrs": {}}


def test_readers_find_nothing_without_a_joint_tree():
    # the parent's program: the solve's own spans, no joint tree above
    parent = SimpleNamespace(
        spans=[_span(1, "destripe.cg", 0, 0, 5), _span(2, "cg.iter", 1, 1, 2)],
        counters=[{"name": "h2d_bytes", "value": 8, "t": 0, "span": 1,
                   "root": 1, "attrs": {}}])
    for cap in (None, parent):
        for trace in (None, _trace()):
            ctx = _ctx(cap, [], trace)
            for n in SPAN_READERS:
                assert harness.load_metric(n).read(ctx) is None, n
    ctx = _ctx(None, [], None)
    for n in READERS:
        assert harness.load_metric(n).read(ctx) is None, n
