"""The port's runner and reduction entry point (``pipeline/runner.py``,
``cli/run_average.py``) against the reference's on the shipped field
reduction (``examples/configs/configuration.toml`` with ``[resilience]
quarantine = "off"``, ``lease_ttl_s = 0`` and ``[quality] enabled =
false``, the knobs the port runs), on the CPU:

- ``Runner.from_config(...).run_tod`` and ``run_average.main`` write
  Level-2 files whose datasets match the reference's files, held by
  ``chip_smoke.level2_diffs`` (its rules and measured margins are stated
  there and in ``tests/test_torch_stages.py``);
- a second run resumes: every contained stage skips, as in the reference;
- a falsy ``STATE`` aborts the file before any checkpoint;
- an unreadable file takes a ``None`` slot and the run goes on;
- rank r of n takes files ``i % n == r``;
- every knob whose machinery is not ported raises ``NotImplementedError``
  naming itself, at ``from_config`` and at ``run_tod``, and the default
  device needs a card.
"""

import copy
import os

import pytest
import torch

from chip_smoke import (ROOT, SHIPPED_CONFIG, check_level2,
                        pipeline_test_params, shipped_chain_config)
from comapreduce_tpu.data.hdf5io import HDF5Store as RefStore
from comapreduce_tpu.data.synthetic import (SyntheticObsParams,
                                            generate_level1_file)
from comapreduce_tpu.pipeline import Runner as RefRunner
from comapreduce_tpu.pipeline.runner import level2_path as ref_level2_path
from comapreduce_tpu_torch.cli import run_average
from comapreduce_tpu_torch.data.hdf5io import HDF5Store
from comapreduce_tpu_torch.pipeline import Runner
from comapreduce_tpu_torch.pipeline.runner import (level2_path, set_logging,
                                                   unported_knobs)
from comapreduce_tpu_torch.pipeline.stages import CheckLevel1File


def _write_toml(path, cfg):
    """A minimal TOML writer for the config's flat tables."""
    def val(v):
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, str):
            return '"' + v + '"'
        if isinstance(v, list):
            return "[" + ", ".join(val(x) for x in v) + "]"
        return repr(v)
    with open(path, "w") as fh:
        for table, kv in cfg.items():
            fh.write(f"[{table}]\n")
            for k, v in kv.items():
                fh.write(f"{k} = {val(v)}\n")


def _config(tmp, name, filelist):
    cfg = shipped_chain_config()
    cfg["Global"].update(filelist=filelist,
                         output_dir=str(tmp / name / "level2"),
                         log_dir=str(tmp / name / "logs"))
    return cfg


@pytest.fixture(scope="module")
def obs(tmp_path_factory):
    """Two Level-1 files of the reference pipeline test's observation
    (seeds 7 and 8), their filelist, and the reference's Level-2 files
    from ``Runner.from_config(...).run_tod``."""
    tmp = tmp_path_factory.mktemp("runner")
    p = pipeline_test_params()
    files = []
    for seed in (7, 8):
        path = str(tmp / f"comap-{seed:07d}-000000.hd5")
        generate_level1_file(path, SyntheticObsParams(**{
            k: getattr(p, k) for k in ("n_feeds", "n_bands", "n_channels",
                                       "n_scans", "scan_samples",
                                       "vane_samples")}, seed=seed))
        files.append(path)
    filelist = str(tmp / "filelist.txt")
    with open(filelist, "w") as fh:
        fh.write("# two observations\n" + "\n".join(files) + "\n")
    ref = RefRunner.from_config(_config(tmp, "ref", filelist))
    results = ref.run_tod(files)
    assert all(r is not None for r in results)
    return tmp, files, filelist, [r.filename for r in results]


def _check_files(got_paths, want_paths):
    for got, want in zip(got_paths, want_paths):
        assert os.path.basename(got) == os.path.basename(want)
        check_level2(HDF5Store().read(got), RefStore().read(want), got)


def test_run_tod_from_config_matches_reference_files(obs):
    tmp, files, filelist, want = obs
    runner = Runner.from_config(_config(tmp, "port", filelist),
                                device="cpu")
    results = runner.run_tod(files)
    assert [r.filename for r in results] == [
        os.path.join(str(tmp / "port" / "level2"), os.path.basename(w))
        for w in want]
    _check_files([r.filename for r in results], want)
    assert set(runner.timings) >= {"ingest.read", "ingest.compute",
                                   "Level1AveragingGainCorrection"}


def test_run_average_main_matches_reference_files(obs):
    tmp, files, filelist, want = obs
    cfg = _config(tmp, "main", filelist)
    path = str(tmp / "main.toml")
    _write_toml(path, cfg)
    assert run_average.main([path, "--device=cpu"]) == 0
    out = cfg["Global"]["output_dir"]
    _check_files([os.path.join(out, os.path.basename(w)) for w in want],
                 want)
    assert any(f.startswith("run_average_") for f in
               os.listdir(cfg["Global"]["log_dir"]))


def test_second_run_resumes_like_the_reference(obs):
    tmp, files, filelist, _ = obs
    runs = {}
    for name, cls, kw in (("resume_port", Runner, {"device": "cpu"}),
                          ("resume_ref", RefRunner, {})):
        cfg = _config(tmp, name, filelist)
        cls.from_config(cfg, **kw).run_tod(files[:1])
        again = cls.from_config(cfg, **kw)
        (lvl2,) = again.run_tod(files[:1])
        runs[name] = (sorted(k for k, v in again.timings.items()
                             if not k.startswith("ingest") and len(v)),
                      lvl2.groups)
    # only the group-less gate runs again; every other stage is contained
    assert runs["resume_port"] == runs["resume_ref"]
    assert runs["resume_port"][0] == ["CheckLevel1File"]


def test_falsy_state_aborts_before_any_checkpoint(obs, tmp_path):
    tmp, files, filelist, _ = obs
    cfg = _config(tmp_path, "abort", filelist)
    cfg["CheckLevel1File"] = {"min_duration_seconds": 1e6}
    port = Runner.from_config(copy.deepcopy(cfg), device="cpu")
    ref = RefRunner.from_config(copy.deepcopy(cfg))
    (p,), (r,) = port.run_tod(files[:1]), ref.run_tod(files[:1])
    assert p.groups == r.groups == []
    assert not os.path.exists(p.filename) and not os.path.exists(r.filename)
    assert list(port.timings.get("CheckLevel1File", [])) and \
        "AssignLevel1Data" not in port.timings


def test_bad_file_takes_a_none_slot(obs, tmp_path):
    tmp, files, filelist, _ = obs
    junk = tmp_path / "junk.hd5"
    junk.write_bytes(b"not an hdf5 file")
    listing = [str(tmp_path / "missing.hd5"), files[0], str(junk)]
    cfg = _config(tmp_path, "bad", filelist)
    results = Runner.from_config(cfg, device="cpu").run_tod(listing)
    assert results[0] is None and results[2] is None
    assert results[1] is not None and results[1].contains_groups(
        ["noise_statistics"])


def test_static_shard_matches_reference(obs, tmp_path):
    tmp, files, filelist, _ = obs
    names = [f"f{i}" for i in range(7)]
    for n in (1, 2, 3):
        for r in range(n):
            assert Runner(rank=r, n_ranks=n).shard(names) == \
                RefRunner(rank=r, n_ranks=n).shard(names)
    cfg = _config(tmp_path, "shard", filelist)
    runner = Runner.from_config(cfg, rank=1, n_ranks=2, device="cpu")
    (only,) = runner.run_tod(files)
    assert os.path.basename(only.filename) == "Level2_" + \
        os.path.basename(files[1])


def test_level2_path_and_logging_match_reference(tmp_path):
    assert level2_path("out", "/a/comap-1.hd5") == \
        ref_level2_path("out", "/a/comap-1.hd5")
    assert level2_path("o", "x.hd5", "L2") == ref_level2_path("o", "x.hd5",
                                                              "L2")
    log = set_logging("run_average", str(tmp_path), rank=0)
    assert os.path.exists(log) and "_rank0.log" in log


UNPORTED = [
    ("ingest", {"prefetch": 2}, "ingest.prefetch"),
    ("ingest", {"cache_mb": 64}, "ingest.cache_mb"),
    ("ingest", {"writeback": 1}, "ingest.writeback"),
    ("ingest", {"compile_cache_dir": "cc"}, "ingest.compile_cache_dir"),
    ("resilience", None, "resilience.quarantine"),
    ("resilience", {"quarantine": "auto", "lease_ttl_s": 0},
     "resilience.quarantine"),
    ("resilience", {"quarantine": "off"}, "resilience.lease_ttl_s"),
    ("resilience", {"quarantine": "off", "lease_ttl_s": 30},
     "resilience.lease_ttl_s"),
    ("resilience", {"quarantine": "off", "lease_ttl_s": 0,
                    "max_retries": 2}, "resilience.max_retries"),
    ("resilience", {"quarantine": "off", "lease_ttl_s": 0,
                    "inject": "read_error:0.5"}, "resilience.inject"),
    ("campaign", {"t_quantum": 4096}, "campaign.t_quantum"),
    ("campaign", {"warm_compile": True}, "campaign.warm_compile"),
    ("telemetry", {"enabled": True}, "telemetry.enabled"),
    ("precision", {"tod_dtype": "bf16"}, "precision.tod_dtype"),
    ("precision", {"cg_dot": "compensated"}, "precision.cg_dot"),
    ("quality", None, "quality.enabled"),
    ("quality", {"enabled": True}, "quality.enabled"),
    ("slo", {"max_tsys_k": 100.0}, "slo.max_tsys_k"),
    ("control", {"admission": True}, "control.admission"),
    ("tuning", {"enabled": True}, "tuning.enabled"),
]


@pytest.mark.parametrize("table,value,knob", UNPORTED,
                         ids=[k for _, _, k in UNPORTED])
def test_unported_knob_raises_at_from_config_and_run_tod(table, value,
                                                         knob):
    cfg = shipped_chain_config()
    if value is None:
        cfg.pop(table, None)
    else:
        cfg[table] = dict(value)
    with pytest.raises(NotImplementedError, match=knob.replace(".", r"\.")):
        Runner.from_config(cfg, device="cpu")
    if knob == "resilience.lease_ttl_s" and "lease_ttl_s" not in value:
        return            # a direct Runner's default is the static shard
    kw = {"resilience": {"quarantine": "off"},
          "quality": {"enabled": False}}
    kw[table] = value
    runner = Runner(processes=[CheckLevel1File()], device="cpu", **kw)
    with pytest.raises(NotImplementedError, match=knob.replace(".", r"\.")):
        runner.run_tod([])


def test_ported_knob_values_are_accepted():
    assert unported_knobs({
        "ingest": {"prefetch": 0, "cache_mb": 0, "eager_tod": True},
        "resilience": {"quarantine": "off", "lease_ttl_s": 0},
        "campaign": {"t_quantum": 0}, "telemetry": {"enabled": False},
        "precision": {"tod_dtype": "f32", "cg_dot": "f32"},
        "quality": {"enabled": False}, "slo": {}, "control": {},
        "tuning": {"enabled": False, "device_hbm_mb": 1000}},
        campaign_defaults=True) == []
    with pytest.raises(ValueError, match="unknown"):
        unported_knobs({"ingest": {"prefetchh": 1}})
    with pytest.raises(NotImplementedError, match="profile_dir"):
        Runner(resilience={"quarantine": "off"},
               quality={"enabled": False}, profile_dir="prof",
               device="cpu").run_tod([])


@pytest.mark.parametrize("flag", ["--figures", "--figures=figs",
                                  "--retry-quarantined", "--live-port=9000"])
def test_run_average_refuses_unported_flags(flag):
    with pytest.raises(NotImplementedError, match=flag.split("=")[0]):
        run_average.main([flag, os.path.join(ROOT, SHIPPED_CONFIG)])


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    runner = Runner(resilience={"quarantine": "off"},
                    quality={"enabled": False})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.run_tod([])
