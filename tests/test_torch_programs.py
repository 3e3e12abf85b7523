"""The port's program registry (``comapreduce_tpu_torch/telemetry/
programs.py``) against the reference's (``comapreduce_tpu/telemetry/
programs.py``) on the CPU:

- ``program_key``, ``programs_path`` and ``shape_bucket`` (numpy
  arguments; tensors give the same signature) as the reference's;
- ``read_programs`` over the same files (latest wins per key, torn,
  unparseable and foreign lines dropped) and ``hbm_regressions`` over
  the same records and baselines;
- the registry: ``configure`` / ``seen`` / ``snapshot`` / ``close``,
  records written by the port read by the reference's reader, dedup per
  key, ``TELEMETRY.configure`` / ``close`` switching it;
- ``record_call`` / ``analyze`` on the CPU: the argument and output bytes
  exact, no ``temp_bytes`` (measured on a CUDA device only);
- the stage programs a telemetry-enabled run records: one per stage and
  shape bucket.
"""

import json
import os

import numpy as np
import pytest
import torch

import comapreduce_tpu.telemetry.programs as ref_prog
import comapreduce_tpu_torch.telemetry.programs as prog
from comapreduce_tpu_torch.telemetry import TELEMETRY

RECORDS = [
    {"schema": 1, "kind": "program", "name": "level1.reduce_feeds",
     "shape_bucket": "f32[2,4,1024,16384]", "precision_id": "",
     "temp_bytes": 3000, "output_bytes": 1000},
    {"schema": 1, "kind": "program", "name": "atmosphere.scan_fit",
     "shape_bucket": "f32[4,1024,16384]", "precision_id": "",
     "temp_bytes": 100, "output_bytes": 50, "kernels": "auto"},
    {"schema": 1, "kind": "program", "name": "level1.frequency_bin",
     "shape_bucket": "f32[4,1024,16384]", "precision_id": "tod=bf16",
     "temp_bytes": 0, "output_bytes": 0},
]


def test_keys_paths_and_buckets_like_the_reference():
    for args in (("n", "", "", ""), ("n", "f32[3]", "tod=f32", ""),
                 ("n", "b", "p", "auto")):
        assert prog.program_key(*args) == ref_prog.program_key(*args)
    assert prog.programs_path("d") == ref_prog.programs_path("d")
    assert prog.programs_path("") == ref_prog.programs_path("")
    arrays = (np.zeros((4096, 64), np.float32), np.zeros(7, np.int32),
              np.zeros((2, 3), np.float64), np.zeros(1, bool))
    assert prog.shape_bucket(*arrays) == ref_prog.shape_bucket(*arrays) \
        == "f32[4096,64]xi32[7]xf64[2,3]xb1[1]"
    assert prog.shape_bucket(*(torch.as_tensor(a) for a in arrays)) == \
        ref_prog.shape_bucket(*arrays)
    many = [np.zeros(i + 1, np.float32) for i in range(14)]
    assert prog.shape_bucket(*many, 3, "x") == \
        ref_prog.shape_bucket(*many, 3, "x")
    assert prog.shape_bucket(1, "x") == ref_prog.shape_bucket(1, "x") == ""


def test_read_programs_like_the_reference(tmp_path):
    """Latest wins per key, torn, unparseable and foreign lines dropped;
    a directory reads every ``programs*.jsonl``, a list each path."""
    a = tmp_path / "programs.jsonl"
    b = tmp_path / "programs.rank1.jsonl"
    with open(a, "w", encoding="utf-8") as f:
        for r in RECORDS:
            f.write(json.dumps(r) + "\n")
        f.write(json.dumps(dict(RECORDS[0], temp_bytes=5000)) + "\n")
        f.write("not json\n")
        f.write(json.dumps({"kind": "span", "name": "x"}) + "\n")
        f.write('{"kind": "program", "name": "torn')
    with open(b, "w", encoding="utf-8") as f:
        f.write(json.dumps(dict(RECORDS[1], name="other")) + "\n")
    for src in (str(tmp_path), str(a), [str(a), str(b)],
                str(tmp_path / "missing.jsonl")):
        assert prog.read_programs(src) == ref_prog.read_programs(src)
    got = prog.read_programs(str(tmp_path))
    assert len(got) == 4
    assert [r["temp_bytes"] for r in got
            if r["name"] == "level1.reduce_feeds"] == [5000]


@pytest.mark.parametrize("slack", [None, 1.0, 2.0])
def test_hbm_regressions_like_the_reference(slack):
    baseline = {prog.program_key(r["name"], r["shape_bucket"],
                                 r["precision_id"], r.get("kernels", "")):
                2000 for r in RECORDS}
    baseline["gone|x|"] = 10
    kw = {} if slack is None else {"slack": slack}
    got = prog.hbm_regressions(RECORDS, baseline, **kw)
    assert got == ref_prog.hbm_regressions(RECORDS, baseline, **kw)
    # 4000 B against 2000 B fails at any slack below 2
    assert len(got) == (0 if slack == 2.0 else 1)
    assert prog.HBM_SLACK == ref_prog.HBM_SLACK


def test_registry_records_dedups_and_rides_telemetry(tmp_path):
    reg = prog.ProgramRegistry()
    assert reg.record("x", {"argument_bytes": 1}) is None   # disabled
    reg.configure(str(tmp_path), rank=2)
    rec = reg.record("x", {"argument_bytes": 8, "output_bytes": 4},
                     shape_bucket="f32[2]", kernels="auto", backend="cpu")
    assert rec["rank"] == 2 and rec["kernels"] == "auto"
    assert reg.seen("x", "f32[2]", "", "auto")
    assert reg.record("x", {"argument_bytes": 9}, shape_bucket="f32[2]",
                      kernels="auto") is None
    assert len(reg.snapshot()) == 1
    # a torn tail left by a killed writer is repaired on the next append
    with open(reg.path, "a", encoding="utf-8") as f:
        f.write('{"kind": "program", "na')
    reg.record("y", {"argument_bytes": 1})
    assert [r["name"] for r in ref_prog.read_programs(str(tmp_path))] == \
        ["x", "y"]
    assert prog.read_programs(str(tmp_path)) == \
        ref_prog.read_programs(str(tmp_path))
    reg.close()
    assert not reg.enabled and reg.snapshot() == []
    try:
        TELEMETRY.configure(str(tmp_path / "t"), rank=0)
        assert prog.PROGRAMS.enabled
        assert prog.PROGRAMS.path == str(tmp_path / "t" / "programs.jsonl")
    finally:
        TELEMETRY.close()
    assert not prog.PROGRAMS.enabled


def test_record_call_measures_an_eager_call_on_the_cpu(tmp_path):
    """The call's result is returned; its record holds the exact argument
    and output bytes and no ``temp_bytes`` off a CUDA device; a second
    call of the same bucket records nothing, another bucket records."""
    reg = prog.ProgramRegistry().configure(str(tmp_path))
    x = torch.ones((3, 5))
    y = torch.ones(5, dtype=torch.float64)

    def fn(a, b, scale=1.0):
        return (a * scale).sum(0), {"m": b * 2}

    out = reg.record_call("f", fn, x, y, scale=2.0)
    assert torch.equal(out[0], torch.full((5,), 6.0))
    (rec,) = reg.snapshot()
    assert rec["shape_bucket"] == "f32[3,5]xf64[5]"
    assert rec["argument_bytes"] == 3 * 5 * 4 + 5 * 8
    assert rec["output_bytes"] == 5 * 4 + 5 * 8
    assert rec["backend"] == "cpu" and "temp_bytes" not in rec
    reg.record_call("f", fn, x, y)
    reg.record_call("f", fn, torch.ones((2, 5)), y)
    assert len(reg.snapshot()) == 2
    assert prog.PROGRAMS.record_call("f", fn, x, y)[1]["m"][0] == 2.0


def test_telemetry_run_records_each_stage_program_once(tmp_path):
    """The reference test's small observation through the four hooked
    stages with ``[telemetry]`` on: one record per stage program and
    shape bucket (the reduction's feed batches, the per-feed fits and
    binning), each with argument and output bytes."""
    from comapreduce_tpu.data.synthetic import (SyntheticObsParams,
                                                generate_level1_file)
    from comapreduce_tpu_torch.pipeline import Runner, stages as s

    path = str(tmp_path / "comap-0000042-synth.hd5")
    generate_level1_file(path, SyntheticObsParams(
        n_feeds=2, n_bands=1, n_channels=16, n_scans=3,
        scan_samples=400, vane_samples=120, seed=42, obsid=42))
    chain = [s.CheckLevel1File(min_duration_seconds=0.0),
             s.AssignLevel1Data(), s.MeasureSystemTemperature(),
             s.SkyDip(), s.AtmosphereRemoval(),
             s.Level1Averaging(frequency_bin_size=8),
             s.Level1AveragingGainCorrection(medfilt_window=301)]
    runner = Runner(processes=chain, output_dir=str(tmp_path / "out"),
                    telemetry={"enabled": True}, device="cpu",
                    resilience={"quarantine": "off", "heartbeat_s": 0})
    try:
        assert runner.run_tod([path])[0] is not None
    finally:
        TELEMETRY.close()
    recs = prog.read_programs(str(tmp_path / "out"))
    assert sorted(r["name"] for r in recs) == [
        "atmosphere.scan_fit", "level1.frequency_bin",
        "level1.reduce_feeds", "skydip.atmosphere_fit"]
    for r in recs:
        assert r["argument_bytes"] > 0 and r["output_bytes"] > 0
        assert r["backend"] == "cpu"
    assert os.path.exists(tmp_path / "out" / "events.rank0.jsonl")
