"""The joint field route's spans and counters
(``cli.run_destriper.solve_bands_joint`` and its plan memo) on the CPU at
a small field, and the route against the benchmark's plain float64
destriper.

The field is the benchmark's (``benchmark.inputs.field``: observations
turned against each other, so they cross-link and the Jacobi CG reaches
its 1e-6 stopping rule) at 2 observations x 2 feeds x 4 000 samples on
16 x 16 pixels, four bands. The limits are the field cell's own
(``benchmark/workloads/field32.solve.json``).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.inputs import field as gen
from benchmark.reference import destriper as ref_destriper
from comapreduce_tpu_torch.cli import run_destriper
from comapreduce_tpu_torch.mapmaking.leveldata import DestriperData
from comapreduce_tpu_torch.telemetry.core import TELEMETRY

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
SIZES = {**json.loads((BENCH / "configs" / "field32.json").read_text()),
         "n_obs": 2, "n_feeds": 2, "raw_samples": 4000, "nx": 16, "ny": 16}
TRAFFIC = json.loads((BENCH / "workloads" / "field32.solve.json")
                     .read_text())
BANDS = TRAFFIC["bands"]
#: the joint tree's spans directly under ``joint``, in the order they run
#: on a warm memo (the plan already on the device)
WARM_ORDER = ["joint.check", "joint.upload", "plan.digest",
              "destripe.setup", "destripe.cg", "destripe.maps",
              "joint.expand"]
PLAN_PHASES = {"plan.unique", "plan.sort_samples", "plan.sort_pairs",
               "plan.windows"}
FIELDS = ("offsets", "destriped_map", "naive_map", "weight_map", "hit_map",
          "residual", "diverged")


@pytest.fixture(scope="module")
def field():
    pix, gid, az = gen.geometry(SIZES)
    npix = SIZES["nx"] * SIZES["ny"]
    datas = []
    for b in BANDS:
        tod, w = gen.make_band(SIZES, TRAFFIC["model"],
                               torch.as_tensor(pix, dtype=torch.int64),
                               torch.as_tensor(gid, dtype=torch.int64),
                               torch.as_tensor(az), 2**31 + 5, b)
        datas.append(DestriperData(
            tod=tod.numpy(), pixels=pix, weights=w.numpy(),
            ground_ids=gid, az=az,
            n_groups=SIZES["n_obs"] * SIZES["n_feeds"], npix=npix))
    return datas


@pytest.fixture(autouse=True)
def cold_memo():
    run_destriper._PLAN_MEMO.clear()
    yield
    run_destriper._PLAN_MEMO.clear()


def _solve(datas):
    z = SIZES
    return run_destriper.solve_bands_joint(
        datas, BANDS, offset_length=z["offset_length"], n_iter=z["n_iter"],
        threshold=z["threshold"], precond=TRAFFIC["precond"], device="cpu")


def _captured(datas):
    with TELEMETRY.capture() as cap:
        res = _solve(datas)
    return res, cap


def _children(cap, parent_id):
    return [s for s in cap.spans if s["parent"] == parent_id]


def test_joint_tree_names_nesting_and_order(field):
    _solve(field)                      # the plan built and uploaded
    res, cap = _captured(field)
    assert res is not None
    roots = [s for s in cap.spans if s["parent"] == 0]
    assert [s["name"] for s in roots] == ["joint"]
    root = roots[0]
    n = field[0].tod.size // SIZES["offset_length"] * SIZES["offset_length"]
    assert root["attrs"] == {"bands": len(BANDS), "samples": len(BANDS) * n}
    assert all(s["root"] == root["id"] and s["t1"] is not None
               for s in cap.spans)
    kids = _children(cap, root["id"])
    assert [s["name"] for s in kids] == WARM_ORDER
    assert all(a["t1"] <= b["t0"] for a, b in zip(kids, kids[1:]))
    cg = next(s for s in kids if s["name"] == "destripe.cg")
    its = [s for s in _children(cap, cg["id"]) if s["name"] == "cg.iter"]
    assert len(its) == res[0].n_iter > 0
    assert not _children(cap, kids[2]["id"])      # a hit builds nothing


def test_first_call_builds_the_plan_inside_the_digest(field):
    _, cap = _captured(field)
    root = next(s for s in cap.spans if s["parent"] == 0)
    kids = _children(cap, root["id"])
    assert [s["name"] for s in kids] == (
        WARM_ORDER[:3] + ["destripe.upload"] + WARM_ORDER[3:])
    digest = kids[2]
    assert digest["attrs"] == {"tag": "plan"}
    inner = {s["name"] for s in cap.spans if s["parent"] == digest["id"]}
    assert inner == PLAN_PHASES
    names = [c["name"] for c in cap.counters if c["name"].startswith("plan.")]
    assert names == ["plan.memo_miss"]


def test_h2d_bytes_counts_the_stacks(field):
    _, cap = _captured(field)
    h2d = [c for c in cap.counters if c["name"] == "h2d_bytes"]
    assert len(h2d) == 1
    n = field[0].tod.size // SIZES["offset_length"] * SIZES["offset_length"]
    assert h2d[0]["value"] == 8 * len(BANDS) * n
    upload = next(s for s in cap.spans if s["name"] == "joint.upload")
    assert h2d[0]["span"] == upload["id"]


def test_second_call_hits_the_memo(field):
    _captured(field)
    _, cap = _captured(field)
    names = [c["name"] for c in cap.counters if c["name"].startswith("plan.")]
    assert names == ["plan.memo_hit"]
    assert not PLAN_PHASES & {s["name"] for s in cap.spans}
    assert "destripe.upload" not in {s["name"] for s in cap.spans}


def test_outputs_bitwise_with_telemetry_on_and_off(field):
    off = _solve(field)
    run_destriper._PLAN_MEMO.clear()
    on, cap = _captured(field)
    assert cap.spans and TELEMETRY._capture is None
    assert len(on) == len(off) == len(BANDS)
    for a, b in zip(off, on):
        assert a.n_iter == b.n_iter
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert np.array_equal(np.asarray(x), np.asarray(y)), f


def test_a_second_pointing_is_refused_inside_the_tree(field):
    other = DestriperData(tod=field[1].tod, pixels=field[1].pixels[::-1],
                          weights=field[1].weights,
                          ground_ids=field[1].ground_ids, az=field[1].az,
                          n_groups=field[1].n_groups, npix=field[1].npix)
    with TELEMETRY.capture() as cap:
        res = run_destriper.solve_bands_joint(
            [field[0], other], BANDS[:2], device="cpu")
    assert res is None
    assert [s["name"] for s in cap.spans] == ["joint", "joint.check"]
    assert not cap.counters


def test_joint_route_against_the_plain_reference(field):
    z = SIZES
    res = _solve(field)
    n = field[0].tod.size // z["offset_length"] * z["offset_length"]
    ref = ref_destriper.destripe(
        torch.stack([torch.as_tensor(d.tod[:n]) for d in field]),
        torch.stack([torch.as_tensor(d.weights[:n]) for d in field]),
        torch.as_tensor(field[0].pixels[:n]).to(torch.int64),
        z["nx"] * z["ny"], z["offset_length"], z["n_iter"], z["threshold"],
        "f64")
    hits = ref["hits"]
    gaps = {
        "offsets": check.rel_gap(
            check.centred(torch.stack([r.offsets for r in res])),
            check.centred(ref["offsets"])),
        "map": check.rel_gap(
            check.hit_map_values(np.stack([r.destriped_map for r in res]),
                                 hits),
            check.hit_map_values(ref["map"], hits)),
        "naive": check.rel_gap(
            torch.as_tensor(np.stack([r.naive_map for r in res]))[
                ..., hits > 0], ref["naive"][..., hits > 0])}
    limits = TRAFFIC["limits"]
    assert all(gaps[k] <= limits[k] for k in limits), gaps
    assert 0 < res[0].n_iter < z["n_iter"]        # the stopping rule fired
