"""The port's legacy front end against the reference's on the CPU:

- ``mapmaking.legacy.read_legacy_level2`` (host numpy/h5py, the
  reference's code): the same flat vectors, bit for bit, on the
  reference test's legacy files (``tests/test_legacy_reader.py``), with
  and without a channel mask and calibration factors; a bad file drops;
- ``Runner.from_legacy_config`` on an INI with every section it reads
  (``[Inputs]`` jobs and ingest knobs, ``[Resilience]``, ``[Campaign]``,
  ``[Telemetry]``, ``[Quality]``, ``[Slo]``, ``[Control]``, ``[Tuning]``):
  the same stages and the same config objects as the reference's; a typo
  in a dedicated section raises in both; the runner reduces a file;
- ``cli.batchrun``'s argv: the same worker count, ``COMAP_RANK`` /
  ``COMAP_NRANKS`` and ``run_average`` arguments as the reference's
  launch, usage errors, and two real workers sharing a filelist.
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from comapreduce_tpu.data.synthetic import (SyntheticObsParams,
                                            generate_level1_file)
from comapreduce_tpu.mapmaking.legacy import \
    read_legacy_level2 as ref_read
from comapreduce_tpu.pipeline import Runner as RefRunner
from comapreduce_tpu_torch.cli import batchrun
from comapreduce_tpu_torch.mapmaking.legacy import read_legacy_level2
from comapreduce_tpu_torch.pipeline import Runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_legacy_file(path, seed=0):
    """The reference test's legacy file (``tests/test_legacy_reader.py:
    10``, its white noise drawn in one call): a common-mode signal under
    per-channel filter and atmosphere templates, 2 feeds x 4 bands x 8
    channels x 2 scans."""
    rng = np.random.default_rng(seed)
    F, B, C, T = 2, 4, 8, 1200
    S = 2
    edges = np.array([[50, 550], [620, 1150]])
    signal = np.sin(np.arange(T) / 40.0)
    medfilts = [rng.normal(0, 1, (F, B, e - s)).cumsum(axis=-1) * 0.05
                for s, e in edges]
    atmos = rng.uniform(5, 10, (F, B, S))
    mf_coef = rng.normal(1.0, 0.1, (F, B, C, S, 1))
    at_coef = rng.normal(0.5, 0.05, (F, B, C, S, 1))
    wnoise = rng.uniform(0.5, 2.0, (F, B, C, S, 1))
    el = np.full((F, T), 45.0) + rng.normal(0, 0.1, (F, T))
    az = np.linspace(0, 30, T)[None, :].repeat(F, axis=0)
    airmass = 1.0 / np.clip(np.sin(np.radians(el)), 0.05, None)
    tod = np.zeros((F, B, C, T))
    for isc, (s, e) in enumerate(edges):
        tod[..., s:e] = (
            signal[s:e]
            + medfilts[isc][:, :, None, :] * mf_coef[..., isc, :]
            + (atmos[:, :, isc][:, :, None, None]
               * airmass[:, None, None, s:e]) * at_coef[..., isc, :]
            + wnoise[..., isc, :] * 0.01 * rng.normal(size=(F, B, C,
                                                            e - s)))
    with h5py.File(path, "w") as h:
        h["level2/averaged_tod"] = tod
        h["level2/Statistics/scan_edges"] = edges
        h["level2/Statistics/filter_coefficients"] = mf_coef
        h["level2/Statistics/atmos"] = atmos
        h["level2/Statistics/atmos_coefficients"] = at_coef
        h["level2/Statistics/wnoise_auto"] = wnoise
        for isc in range(S):
            h[f"level2/Statistics/FilterTod_Scan{isc:02d}"] = medfilts[isc]
        h["level1/spectrometer/pixel_pointing/pixel_az"] = az
        h["level1/spectrometer/pixel_pointing/pixel_el"] = el
    return signal, edges


def _same(got, want):
    for k in ("tod", "weights", "az", "el", "file_ids"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert got.files == want.files


@pytest.mark.parametrize("case", ["plain", "mask_cal", "feeds_L25"])
def test_read_legacy_level2_like_the_reference(tmp_path, case):
    paths = [str(tmp_path / f"legacy{i}.hd5") for i in range(2)]
    signal, edges = _write_legacy_file(paths[0], seed=0)
    _write_legacy_file(paths[1], seed=3)
    bad = tmp_path / "bad.hd5"
    bad.write_bytes(b"not hdf5")
    files = [paths[0], str(bad), paths[1]]
    kw = {}
    if case == "mask_cal":
        mask = np.ones((2, 4, 8), bool)
        mask[:, :, ::2] = False
        cal = np.random.default_rng(1).uniform(0.5, 2.0, (2, 4, 8))
        cal[0, 0, 1] = 0.0            # a missing factor divides by 1
        kw = {"channel_mask": mask, "cal_factors": cal}
    elif case == "feeds_L25":
        kw = {"feeds": [1], "offset_length": 25}
    got = read_legacy_level2(files, **kw)
    _same(got, ref_read(files, **kw))
    assert got.files == paths
    L = kw.get("offset_length", 50)
    n_feeds = len(kw.get("feeds", [0, 1]))
    assert got.tod.size == 2 * n_feeds * sum((e - s) // L * L
                                             for s, e in edges)
    if case == "plain":
        # the cleaned stream recovers the injected signal to the noise
        n0 = (edges[0][1] - edges[0][0]) // L * L
        g = got.tod[:n0] - np.median(got.tod[:n0])
        w = signal[edges[0][0]:edges[0][0] + n0]
        assert np.std(g - (w - np.median(w))) < 0.02
    empty = read_legacy_level2([str(bad)])
    _same(empty, ref_read([str(bad)]))
    assert empty.files == [] and empty.tod.size == 0


LEGACY_INI = """[Inputs]
output_dir : {out}
log_dir : {out}/logs
prefetch : 1
cache_mb : 32
pipeline : CheckLevel1File, AssignLevel1Data, MeasureSystemTemperature
[CheckLevel1File]
min_duration_seconds : 0.0
[Resilience]
max_retries : 5
quarantine : off
lease_ttl_s : 0
heartbeat_s : 0
[Campaign]
t_quantum : 2048
scan_quantum : 4
warm_compile : true
[Telemetry]
enabled : false
flush_s : 0.5
[Quality]
enabled : true
[Slo]
max_tsys_k : 250.0
[Control]
admission : false
[Tuning]
enabled : false
device_hbm_mb : 2048
"""


def test_from_legacy_config_like_the_reference(tmp_path):
    """Every section the reference reads builds the same objects in the
    port; a typo'd dedicated section raises in both; the port's runner
    reduces a small observation with them."""
    ini = tmp_path / "legacy.ini"
    ini.write_text(LEGACY_INI.format(out=tmp_path / "out"))
    port = Runner.from_legacy_config(str(ini), device="cpu")
    ref = RefRunner.from_legacy_config(str(ini))
    assert [type(p).__name__ for p in port.processes] == \
        [type(p).__name__ for p in ref.processes] == [
            "CheckLevel1File", "AssignLevel1Data",
            "MeasureSystemTemperature"]
    assert port.processes[0].min_duration_seconds == 0.0
    assert (port.output_dir, port.state_dir) == (ref.output_dir,
                                                 ref.state_dir)
    for table in ("resilience", "quality", "slo", "control"):
        assert repr(getattr(port, table)) == repr(getattr(ref, table)), \
            table
    assert (port.ingest.prefetch, port.ingest.cache_mb) == \
        (ref.ingest.prefetch, ref.ingest.cache_mb) == (1, 32)
    for k in ("t_quantum", "scan_quantum", "l_quantum", "warm_compile"):
        assert getattr(port.campaign, k) == getattr(ref.campaign, k)
    for k in port.tuning.KNOBS:
        assert getattr(port.tuning, k) == getattr(ref.tuning, k)
    assert (port.telemetry.enabled, port.telemetry.flush_s) == \
        (ref.telemetry.enabled, ref.telemetry.flush_s)
    for section in ("Resilience", "Campaign", "Tuning"):
        bad = tmp_path / f"typo_{section}.ini"
        bad.write_text(f"[Inputs]\noutput_dir : out\n[{section}]\n"
                       "typo_knob : 5\n")
        for cls in (Runner, RefRunner):
            with pytest.raises(ValueError, match="unknown"):
                cls.from_legacy_config(str(bad))
    path = str(tmp_path / "comap-0000042-synth.hd5")
    generate_level1_file(path, SyntheticObsParams(
        n_feeds=1, n_bands=1, n_channels=16, n_scans=2, scan_samples=400,
        vane_samples=120, seed=42, obsid=42))
    (lvl2,) = port.run_tod([path])
    assert lvl2 is not None and lvl2.contains_groups(["vane"])


def test_batchrun_argv_like_the_reference(monkeypatch):
    """The workers ``main`` spawns: the reference's count, rank
    environment and ``run_average`` arguments, on the port's module;
    malformed lines print the usage and return 2."""
    import comapreduce_tpu.cli.batchrun as ref_batch

    spawned = []

    class _Popen:
        def __init__(self, cmd, env):
            spawned.append((cmd, env))

        def wait(self):
            return 0

    monkeypatch.setattr(subprocess, "Popen", _Popen)
    argv = ["-n", "3", "cfg.toml", "--device=cpu"]
    assert ref_batch.main(argv) == 0
    ref_spawned, spawned[:] = list(spawned), []
    assert batchrun.main(argv) == 0
    assert len(spawned) == len(ref_spawned) == 3
    for (cmd, env), (rcmd, renv) in zip(spawned, ref_spawned):
        assert cmd[-2:] == rcmd[-2:] == ["cfg.toml", "--device=cpu"]
        assert cmd[2] == "comapreduce_tpu_torch.cli.run_average"
        assert (env["COMAP_RANK"], env["COMAP_NRANKS"]) == \
            (renv["COMAP_RANK"], renv["COMAP_NRANKS"])
    assert [e["COMAP_RANK"] for _, e in spawned] == ["0", "1", "2"]
    assert batchrun.worker_commands(["--n-procs=2", "c.toml"])[1][1][
        "COMAP_NRANKS"] == "2"
    assert len(batchrun.worker_commands(["c.toml"])) == 2   # the default
    for bad in ([], ["-n"], ["-n", "x", "c.toml"], ["--n-procs=0", "c"],
                ["-n", "2"]):
        assert batchrun.main(bad) == ref_batch.main(bad) == 2


def test_batchrun_two_workers_share_a_filelist(tmp_path):
    """Two real ``run_average`` workers on the CPU drain a two-file list:
    each file reduced once, each rank beating its own heartbeat (the
    reference test's ``test_batchrun_spawns_sharded_workers``)."""
    paths = []
    for i in range(2):
        p = str(tmp_path / f"comap-010{i}.hd5")
        generate_level1_file(p, SyntheticObsParams(
            n_feeds=1, n_bands=1, n_channels=16, n_scans=2,
            scan_samples=400, vane_samples=200, seed=40 + i))
        paths.append(p)
    (tmp_path / "filelist.txt").write_text("\n".join(paths) + "\n")
    outdir = tmp_path / "level2"
    cfg = tmp_path / "run.toml"
    cfg.write_text(f"""
[Global]
processes = ["CheckLevel1File", "AssignLevel1Data",
             "MeasureSystemTemperature"]
filelist = "{tmp_path}/filelist.txt"
output_dir = "{outdir}"
log_dir = "{tmp_path}/logs"

[CheckLevel1File]
min_duration_seconds = 0.0
""")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "comapreduce_tpu_torch.cli.batchrun", "-n",
         "2", str(cfg), "--device=cpu"], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    level2 = sorted(p for p in os.listdir(outdir)
                    if p.startswith("Level2_") and not p.endswith(".s256"))
    assert len(level2) == 2, level2
    beats = sorted(p for p in os.listdir(tmp_path / "logs")
                   if p.startswith("heartbeat.rank"))
    assert beats == ["heartbeat.rank0.json", "heartbeat.rank1.json"]
