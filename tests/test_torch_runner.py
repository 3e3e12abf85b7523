"""The port's runner and reduction entry point (``pipeline/runner.py``,
``cli/run_average.py``) against the reference's on the shipped field
reduction (``examples/configs/configuration.toml`` as shipped: the
quarantine ledger, retries, heartbeats, elastic lease claiming and the
quality ledger all on), on the CPU:

- ``Runner.from_config(...).run_tod`` and ``run_average.main`` write
  Level-2 files whose datasets match the reference's files, held by
  ``chip_smoke.level2_diffs`` (its rules and measured margins are stated
  there and in ``tests/test_torch_stages.py``);
- a second run resumes: every contained stage skips, as in the reference;
- a falsy ``STATE`` aborts the file before any checkpoint;
- an unreadable file takes a ``None`` slot and the run goes on;
- rank r of n takes files ``i % n == r`` on the static shard;
- a chaos drill (a read error, a NaN burst and a first-read flake, each
  aimed at one file) over four files gives the reference's ledger
  dispositions, lease states, quality records (every field equal but
  the vane's, within the vane tolerance ``chip_smoke.VANE_RTOL``, and
  the noise fit's, degenerate on this white TOD and held through the
  Level-2 fits by ``level2_diffs``) and Level-2 files, their noise fits
  held by ``check_level2(fit_loss=...)`` with the reference's loss on the
  reference's binned PSD: within a standard error of the reference's
  model per log bin or, on a scan where the reference's own fit leaves
  its 1/f part unmeasured, within 3 standard errors and no worse a fit
  (measured on the CPU, in the reference's loss: seed 10's red-noise
  fit of scan 0 lies 1.06 standard errors from the reference's, at a
  log-chi^2 of 9.69 against the reference's 11.33; the NaN-burst file's
  knee fit of its burst scan 2.7, at 153.1 against 176.9); a second run
  skips the quarantined file without a read, and ``--retry-quarantined``
  re-admits it;
- every knob whose machinery is not ported raises ``NotImplementedError``
  naming itself, at ``from_config`` and at ``run_tod``, and the default
  device needs a card; the ingest knobs (``prefetch``, ``cache_mb``,
  ``writeback``) and ``[precision]`` (``tod_dtype = bf16``, ``cg_dot``)
  run the chain in both packages, the Level-2 files held as above;
- ``run_average`` with ``[Global] calibrator_filelist`` (the shipped
  config plus ``FitSource``) over a field and a calibrator observation
  writes ``TauA_source_fit/*`` into the calibrator's Level-2 file and
  ``astro_calibration/*`` into both, matching the reference CLI's within
  ``chip_smoke.calibration_diffs``' limits (stated and measured there);
  FitSource's falsy ``STATE`` on the field file leaves that file's
  Level-2 datasets, ledger, leases and quality records as the
  reference's (every other dataset held by ``check_level2``); the apply
  pass runs on the static shard, so it calibrates every file though the
  reduction's leases are committed.
"""

import copy
import os

import numpy as np
import pytest
import torch

from chip_smoke import (CAL_GROUPS, VANE_RTOL,
                        check_calibration, check_level2,
                        pipeline_test_params, shipped_chain_config,
                        without_groups)
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


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the whole module: its many small ops gain
    nothing from more on the CPU, and the suite's parallel workers
    oversubscribe the cores (the old count is restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
        # a fresh state directory: the first run's committed leases
        # would otherwise say the campaign is done
        cfg["Global"]["log_dir"] += "_again"
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
    cfg["Global"]["log_dir"] += "_ref"      # each its own leases
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
    cfg["resilience"]["lease_ttl_s"] = 0         # the static shard
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
    ("campaign", {"t_quantum": 4096}, "campaign.t_quantum"),
    ("campaign", {"warm_compile": True}, "campaign.warm_compile"),
    ("telemetry", {"enabled": True}, "telemetry.enabled"),
    ("precision", {"tod_dtype": "bf16"}, "precision.tod_dtype"),
    ("precision", {"cg_dot": "compensated"}, "precision.cg_dot"),
    ("control", {"admission": True}, "control.admission"),
    ("tuning", {"enabled": True}, "tuning.enabled"),
]


# the knobs of UNPORTED that the ingest tier, bf16 streaming, the
# telemetry plane and the control plane now run; bf16 narrows only in
# the eager loader, so its case reads ahead
RUNS = {"ingest.prefetch": {}, "ingest.cache_mb": {},
        "ingest.writeback": {}, "precision.cg_dot": {},
        "precision.tod_dtype": {"ingest": {"prefetch": 1}},
        "telemetry.enabled": {}, "control.admission": {}}


@pytest.mark.parametrize("table,value,knob", UNPORTED,
                         ids=[k for _, _, k in UNPORTED])
def test_unported_knob_raises_at_from_config_and_run_tod(table, value,
                                                         knob, obs,
                                                         tmp_path):
    """Each knob whose machinery is not ported raises naming itself, at
    ``from_config`` and at ``run_tod`` (``compile_cache_dir`` naming
    XLA, whose cache it is). The knobs of ``RUNS`` were refused until
    the ingest tier (and, for ``[telemetry]`` and ``[control]``, the
    telemetry and control planes) was ported; each now runs the shipped
    chain over one observation in both
    packages, the port's Level-2 file held to the reference's by
    ``check_level2`` (each package's telemetry stream closed after)."""
    cfg = shipped_chain_config()
    cfg[table] = dict(value)
    if knob in RUNS:
        _, files, filelist, _ = obs
        paths = {}
        for name, cls, kw in (("port", Runner, {"device": "cpu"}),
                              ("ref", RefRunner, {})):
            run_cfg = _config(tmp_path, name, filelist)
            run_cfg[table] = dict(value)
            run_cfg.update(copy.deepcopy(RUNS[knob]))
            runner = cls.from_config(run_cfg, **kw)
            try:
                (lvl2,) = runner.run_tod(files[:1])
            finally:
                from comapreduce_tpu.telemetry import TELEMETRY as ref_t
                from comapreduce_tpu_torch.telemetry import TELEMETRY

                TELEMETRY.close()
                ref_t.close()
            paths[name] = lvl2.filename
            if table == "ingest" and "writeback" in value:
                assert runner.writeback_stats["writes"] >= 7
        # the narrowed TOD is the same bits in both packages; its noise
        # fits, degenerate on this white TOD, are held through the
        # reference's loss as the drill's are (measured on the CPU: the
        # white fit of one scan 1.27 standard errors from the
        # reference's, at no worse a log-chi^2)
        check_level2(HDF5Store().read(paths["port"]),
                     RefStore().read(paths["ref"]), paths["port"],
                     fit_loss=_ref_fit_losses)
        return
    with pytest.raises(NotImplementedError,
                       match=knob.replace(".", r"\.")) as err:
        Runner.from_config(cfg, device="cpu")
    if knob == "ingest.compile_cache_dir":
        assert "XLA" in str(err.value)
    runner = Runner(processes=[CheckLevel1File()], device="cpu",
                    **{table: value})
    with pytest.raises(NotImplementedError, match=knob.replace(".", r"\.")):
        runner.run_tod([])


# [resilience], [quality] and [slo]: ported, validated by their own
# config objects (an unknown option raises ValueError, as the reference's
# coercion does)
PORTED = [
    ("resilience", None), ("resilience", {"quarantine": "auto",
                                          "lease_ttl_s": 0}),
    ("resilience", {"quarantine": "off"}),
    ("resilience", {"max_retries": 2, "inject": "read_error:0.5",
                    "deadlines": "ingest.read=60/300"}),
    ("quality", None), ("quality", {"enabled": True}),
    ("slo", {"max_tsys_k": 100.0, "exclude_flagged": True}),
]


@pytest.mark.parametrize("table,value", PORTED,
                         ids=[f"{t}-{i}" for i, (t, _) in enumerate(PORTED)])
def test_resilience_quality_and_slo_tables_build_like_the_reference(
        table, value):
    cfg = shipped_chain_config()
    if value is None:
        cfg.pop(table, None)
    else:
        cfg[table] = dict(value)
    port = Runner.from_config(copy.deepcopy(cfg), device="cpu")
    ref = RefRunner.from_config(copy.deepcopy(cfg))
    assert repr(port.resilience) == repr(ref.resilience)
    assert repr(port.quality) == repr(ref.quality)
    assert repr(port.slo) == repr(ref.slo)
    cfg[table] = dict(value or {}, bogus=1)
    with pytest.raises(ValueError):
        Runner.from_config(cfg, device="cpu")


def test_ported_knob_values_are_accepted():
    assert unported_knobs({
        "ingest": {"prefetch": 0, "cache_mb": 0, "eager_tod": True},
        "resilience": {"quarantine": "auto", "lease_ttl_s": 60},
        "campaign": {"t_quantum": 0}, "telemetry": {"enabled": False},
        "precision": {"tod_dtype": "f32", "cg_dot": "f32"},
        "quality": {"enabled": True}, "slo": {"max_tsys_k": 1.0},
        "control": {},
        "tuning": {"enabled": False, "device_hbm_mb": 1000}}) == []
    with pytest.raises(ValueError, match="unknown"):
        unported_knobs({"ingest": {"prefetchh": 1}})
    # profile_dir runs now (a torch.profiler trace per run_file): an
    # empty filelist profiles nothing
    assert Runner(profile_dir="prof", device="cpu",
                  resilience={"quarantine": "off",
                              "heartbeat_s": 0}).run_tod([]) == []


# the QA figures the shipped chain writes for each observation
CHAIN_FIGURES = ("fnoise_fits_feed00_band00_scan00.png",
                 "gain_feed00_scan00.png",
                 "noise_statistics_feed00_band00_scan00.png",
                 "vane_feed00_event00.png")


def _figures(root) -> dict:
    return {d: sorted(os.listdir(os.path.join(root, d)))
            for d in sorted(os.listdir(root))}


@pytest.mark.parametrize("flag", ["--figures", "--figures=figs",
                                  "--live-port=9000"])
def test_run_average_refuses_unported_flags(flag, obs, tmp_path,
                                            monkeypatch):
    """``--live-port`` runs the live sidecar beside the run (refused
    until the live plane was ported; the case keeps its id but binds an
    ephemeral port) and stops it after; ``--figures`` (into
    ``./figures``) and ``--figures=DIR`` give the stages their figure
    directory (the vane's figure here; the whole chain's in
    ``test_run_average_refuses_figure_dir``)."""
    monkeypatch.chdir(tmp_path)
    if flag.startswith("--live-port"):
        path = str(tmp_path / "cfg.toml")
        cfg = _config(tmp_path, "live", obs[2])
        cfg["Global"]["processes"] = ["CheckLevel1File"]
        _write_toml(path, cfg)
        assert run_average.main(["--live-port=0", path,
                                 "--device=cpu"]) == 0
        return
    path = str(tmp_path / "cfg.toml")
    cfg = _config(tmp_path, "run", obs[2])
    cfg["Global"]["processes"] = ["CheckLevel1File", "AssignLevel1Data",
                                  "MeasureSystemTemperature"]
    _write_toml(path, cfg)
    assert run_average.main([flag, path, "--device=cpu"]) == 0
    root = str(tmp_path / (flag.partition("=")[2] or "figures"))
    # both observations carry the generator's obsid 1000001
    assert _figures(root) == {"1000001": ["vane_feed00_event00.png"]}


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Runner().run_tod([])


# the chaos drill: a read error, a NaN burst in the Level-1 TOD and a
# first-read flake, each aimed at one file by its seed number; backoff
# shortened so the drill does not wait out the shipped 0.5 s base
DRILL_INJECT = "read_error@0000008:1,nan_burst@0000009:1,flaky@0000010:1"


def _drill_config(tmp, name, filelist, **resilience):
    cfg = _config(tmp, name, filelist)
    cfg["resilience"].update(dict(inject=DRILL_INJECT, inject_seed=3,
                                  retry_base_s=0.01), **resilience)
    return cfg


def _ref_fit_losses(store, params, knee):
    """The reference's log-chi^2 (``ops/power.py``'s
    ``_fit_noise_model_with_loss``) of ``params`` (F, B, S, 3) on the
    reference's binned PSD of ``store``'s averaged TOD (peak-masked, the
    shipped config's log bins over each scan's quantised length), f64[F,
    B, S], NaN where unfitted."""
    import jax.numpy as jnp
    import numpy as np
    from chip_smoke import NOISE_MAX_BUCKETS, NOISE_NBINS, NOISE_QUANTUM
    from comapreduce_tpu.ops import power
    from comapreduce_tpu.pipeline.stages import bucket_scan_lengths

    tod = np.asarray(store["averaged_tod/tod"], np.float32)
    edges = np.asarray(store["averaged_tod/scan_edges"])
    model = power.knee_model if knee else power.red_noise_model
    out = np.full(params.shape[:-1], np.nan)
    for lq, sids in bucket_scan_lengths(edges, NOISE_QUANTUM,
                                        NOISE_MAX_BUCKETS).items():
        for si in sids:
            x = jnp.asarray(tod[..., edges[si, 0]:edges[si, 0] + lq])
            freqs, ps = power.psd(x)
            d = x[..., 1:] - x[..., :-1]
            mask = power.psd_peak_mask(freqs, ps, jnp.var(d, axis=-1) / 2.0)
            nu, pb, cnt = (np.asarray(v, np.float64) for v in
                           power.log_bin_psd(freqs, ps, nbins=NOISE_NBINS,
                                             sample_mask=mask))
            good = (cnt > 0) & (pb > 0) & (nu > 0)
            logp = np.where(good, np.log(np.maximum(pb, 1e-30)), 0.0)
            wgt = np.sqrt(np.maximum(cnt, 0.0)) * good
            p = np.asarray(params[..., si, :], np.float64)
            m = np.asarray(model((p[..., 0:1], p[..., 1:2], p[..., 2:3]),
                                 np.maximum(nu, 1e-6)))
            r = (logp - np.log(np.maximum(m, 1e-30))) * wgt
            out[..., si] = np.where(np.isfinite(p[..., 0]),
                                    (r * r).sum(-1), np.nan)
    return out


def _dispositions(ledger_path, ledger_cls):
    return sorted((os.path.basename(e.unit["file"]), e.unit["feed"],
                   e.unit["band"], e.disposition, e.failure_class,
                   e.retries, e.stage)
                  for e in ledger_cls(ledger_path).entries)


@pytest.fixture(scope="module")
def drill(tmp_path_factory, obs):
    """Four Level-1 files (seeds 7-10), each package's first drill run
    and the reference's results."""
    from comapreduce_tpu.resilience.ledger import QuarantineLedger

    tmp = tmp_path_factory.mktemp("drill")
    _, files2, _, _ = obs
    p = pipeline_test_params()
    files = list(files2)
    for seed in (9, 10):
        path = str(tmp / f"comap-{seed:07d}-000000.hd5")
        generate_level1_file(path, SyntheticObsParams(**{
            k: getattr(p, k) for k in ("n_feeds", "n_bands", "n_channels",
                                       "n_scans", "scan_samples",
                                       "vane_samples")}, seed=seed))
        files.append(path)
    filelist = str(tmp / "filelist.txt")
    with open(filelist, "w") as fh:
        fh.write("\n".join(files) + "\n")
    ref = RefRunner.from_config(_drill_config(tmp, "ref", filelist))
    want = ref.run_tod(files)
    return tmp, files, filelist, ref, want, QuarantineLedger


def test_chaos_drill_matches_reference(drill):
    from comapreduce_tpu.telemetry.quality import read_quality as ref_read
    from comapreduce_tpu_torch.resilience.ledger import QuarantineLedger
    from comapreduce_tpu_torch.resilience.lease import LeaseBoard
    from comapreduce_tpu_torch.telemetry.quality import read_quality

    tmp, files, filelist, ref, want, RefLedger = drill
    port = Runner.from_config(_drill_config(tmp, "port", filelist),
                              device="cpu")
    got = port.run_tod(files)
    assert [r is None for r in got] == [r is None for r in want] == \
        [False, True, False, False]
    for g, w in zip(got, want):
        if w is not None:
            check_level2(HDF5Store().read(g.filename),
                         RefStore().read(w.filename), g.filename,
                         fit_loss=_ref_fit_losses)
    ledgers = {}
    for name, cls in (("port", QuarantineLedger), ("ref", RefLedger)):
        path = str(tmp / name / "level2" / "quarantine.jsonl")
        ledgers[name] = _dispositions(path, cls)
        # each package's ledger reads back the same in the other's reader
        other = RefLedger if cls is QuarantineLedger else QuarantineLedger
        assert _dispositions(path, other) == ledgers[name]
    assert ledgers["port"] == ledgers["ref"] == [
        ("comap-0000008-000000.hd5", None, None, "quarantined",
         "transient", 2, "ingest.read"),
        ("comap-0000010-000000.hd5", None, None, "recovered",
         "transient", 1, "ingest.read")]
    assert sorted(port._resilience.chaos.injected) == \
        sorted(ref._resilience.chaos.injected)
    assert port.scheduler_stats == ref.scheduler_stats
    assert port.scheduler_stats["committed"] == 4
    for f in files:
        for name in ("port", "ref"):
            board = LeaseBoard(str(tmp / name / "logs"))
            assert board.is_done(f)
    records = {"port": read_quality(str(tmp / "port" / "logs")),
               "ref": ref_read(str(tmp / "ref" / "logs"))}
    assert len(records["port"]) == len(records["ref"]) == 3 * 2 * 2
    for g, w in zip(records["port"], records["ref"]):
        assert sorted(g) == sorted(w)
        for k in w:
            if k in ("t",):
                continue
            if k in ("tsys_k", "gain"):
                assert abs(g[k] - w[k]) <= VANE_RTOL * abs(w[k]) + 1e-6 * \
                    abs(w[k]), k
            elif k in ("white_sigma", "fknee_hz", "alpha"):
                assert (g[k] is None) == (w[k] is None), k
            else:
                assert g[k] == w[k], (k, g[k], w[k])
    for name in ("port", "ref"):
        logs = sorted(os.listdir(tmp / name / "logs"))
        assert "heartbeat.rank0.json" in logs and "queue.json" in logs


def test_rerun_skips_the_quarantined_file_and_retry_readmits(drill,
                                                              monkeypatch):
    """The same output directory (its quarantine ledger) with a fresh
    state directory: the quarantined file is skipped without a read (no
    loader call, no injected fault) and takes no result slot, as in the
    reference; then ``run_average --retry-quarantined`` with the drill
    off re-admits it (a ``readmitted`` ledger event) and reduces it."""
    from comapreduce_tpu_torch.ingest import loaders
    from comapreduce_tpu_torch.resilience.ledger import QuarantineLedger

    tmp, files, filelist, _, _, RefLedger = drill
    calls = []
    real = loaders.load_level1

    def counted(f, **kw):
        calls.append(os.path.basename(f))
        return real(f, **kw)

    monkeypatch.setattr(loaders, "load_level1", counted)
    out = {}
    for name, cls, kw in (("port", Runner, {"device": "cpu"}),
                          ("ref", RefRunner, {})):
        cfg = _drill_config(tmp, name, filelist)
        cfg["Global"]["log_dir"] += "_rerun"
        runner = cls.from_config(cfg, **kw)
        res = runner.run_tod(files)
        out[name] = ([os.path.basename(r.filename) for r in res],
                     sorted(runner._resilience.chaos.injected))
    assert out["port"] == out["ref"]
    assert "Level2_comap-0000008-000000.hd5" not in out["port"][0]
    assert len(out["port"][0]) == 3
    assert "comap-0000008-000000.hd5" not in calls
    assert all("0000008" not in f for f, _ in out["port"][1])
    calls.clear()
    for name in ("port", "ref"):
        cfg = _config(tmp, name, filelist)
        cfg["Global"]["log_dir"] += "_readmit"
        path = str(tmp / f"{name}_readmit.toml")
        _write_toml(path, cfg)
        if name == "port":
            assert run_average.main([path, "--device=cpu",
                                     "--retry-quarantined"]) == 0
        else:
            from comapreduce_tpu.cli import run_average as ref_ra

            assert ref_ra.main([path, "--retry-quarantined"]) == 0
    assert calls == [os.path.basename(f) for f in files]
    events = {}
    for name, cls in (("port", QuarantineLedger), ("ref", RefLedger)):
        events[name] = _dispositions(
            str(tmp / name / "level2" / "quarantine.jsonl"), cls)
    assert events["port"] == events["ref"]
    assert ("comap-0000008-000000.hd5", None, None, "readmitted", "", 0,
            "readmit") in events["port"]
    led = QuarantineLedger(str(tmp / "port" / "level2" /
                               "quarantine.jsonl"))
    assert not led.is_quarantined(files[1])
    assert os.path.exists(str(tmp / "port" / "level2" /
                              "Level2_comap-0000008-000000.hd5"))


# the reference's end-to-end calibrator (``tests/test_calibration.py:184``)
# with the field observation's two feeds: the factors are per (feed, band)
# and the map-maker's reader applies them feed by feed
TAUA = dict(source="TauA", n_feeds=2, n_bands=2, n_channels=32, n_scans=5,
            scan_samples=1500, vane_samples=250, seed=21,
            source_amplitude_k=7.0, source_fwhm_deg=0.075, az_throw=1.0,
            ra0=83.6331, dec0=22.0145)


@pytest.fixture(scope="module")
def calrun(tmp_path_factory, obs):
    """``run_average`` of each package on the shipped config plus
    ``FitSource`` with ``calibrator_filelist`` and ``calibration_cache``
    set, over a field file (seed 7) and the TauA calibrator."""
    from comapreduce_tpu.cli import run_average as ref_run_average

    tmp = tmp_path_factory.mktemp("calrun")
    _, files, _, _ = obs
    cal = str(tmp / "comap-0000021-000000.hd5")
    generate_level1_file(cal, SyntheticObsParams(**TAUA))
    filelist, cal_list = str(tmp / "filelist.txt"), str(tmp / "cals.txt")
    with open(filelist, "w") as fh:
        fh.write(f"{files[0]}\n{cal}\n")
    with open(cal_list, "w") as fh:
        fh.write(cal + "\n")
    # one intra-op thread: the fits' many small ops gain nothing from
    # more on the CPU, and the suite's parallel workers oversubscribe
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, main, flags in (("ref", ref_run_average.main, []),
                                  ("port", run_average.main,
                                   ["--device=cpu"])):
            cfg = _config(tmp, name, filelist)
            cfg["Global"]["processes"].append("FitSource")
            cfg["Global"].update(
                calibrator_filelist=cal_list,
                calibration_cache=str(tmp / name / "cal.npz"))
            path = str(tmp / f"{name}.toml")
            _write_toml(path, cfg)
            assert main([path] + flags) == 0
    finally:
        torch.set_num_threads(n_threads)
    return tmp, [files[0], cal]


def test_run_average_with_calibrator_filelist_matches_reference(calrun):
    tmp, files = calrun
    for f in files:
        base = "Level2_" + os.path.basename(f)
        paths = [str(tmp / name / "level2" / base) for name in ("port",
                                                               "ref")]
        got, want = HDF5Store().read(paths[0]), RefStore().read(paths[1])
        assert sorted(got.groups) == sorted(want.groups)
        assert "astro_calibration" in got.groups
        assert ("TauA_source_fit" in got.groups) == ("21" in base)
        check_calibration(got, want, base)
        if "TauA_source_fit" in want.groups:
            # the port's fits end no higher than the reference's
            c2 = [np.asarray(x["TauA_source_fit/chi2"]) for x in (got, want)]
            assert (c2[0] <= c2[1] * (1 + 1e-5)).all(), c2
        check_level2(without_groups(got, CAL_GROUPS),
                     without_groups(want, CAL_GROUPS), base,
                     fit_loss=_ref_fit_losses)
    fits = np.asarray(HDF5Store().read(str(
        tmp / "port" / "level2" / "Level2_comap-0000021-000000.hd5"))[
            "TauA_source_fit/fits"])
    assert ((fits[..., 0] > 3.5) & (fits[..., 0] < 10.5)).all()


def test_calibration_cache_crosses_packages(calrun):
    from comapreduce_tpu.calibration.apply_cal import \
        CalibratorDatabase as RefDatabase
    from comapreduce_tpu_torch.calibration.apply_cal import \
        CalibratorDatabase

    tmp, _ = calrun
    port = CalibratorDatabase.load(str(tmp / "port" / "cal.npz"))
    ref = RefDatabase.load(str(tmp / "ref" / "cal.npz"))
    crossed = RefDatabase.load(str(tmp / "port" / "cal.npz"))
    assert [e[:2] for e in port.entries] == [e[:2] for e in ref.entries] \
        == [e[:2] for e in crossed.entries]
    assert len(port.entries) == 1 and port.entries[0][1] == "TauA"
    np.testing.assert_allclose(port.entries[0][2], ref.entries[0][2],
                               rtol=3e-3)
    np.testing.assert_array_equal(port.entries[0][3], ref.entries[0][3])


def test_fit_source_state_on_the_field_file_leaves_what_the_reference_does(
        calrun):
    """FitSource's ``STATE = False`` on the field file stops its chain
    after every earlier stage's checkpoint: the same groups, an empty
    quarantine ledger, both leases committed and the same quality records
    (the apply pass ledgers each file's records again, in both)."""
    from comapreduce_tpu.resilience.ledger import \
        QuarantineLedger as RefLedger
    from comapreduce_tpu.telemetry.quality import read_quality as ref_read
    from comapreduce_tpu_torch.resilience.ledger import QuarantineLedger
    from comapreduce_tpu_torch.resilience.lease import LeaseBoard
    from comapreduce_tpu_torch.telemetry.quality import read_quality

    tmp, files = calrun
    for name, cls in (("port", QuarantineLedger), ("ref", RefLedger)):
        assert _dispositions(str(tmp / name / "level2" / "quarantine.jsonl"),
                             cls) == []
        board = LeaseBoard(str(tmp / name / "logs"))
        assert all(board.is_done(f) for f in files)
    got = read_quality(str(tmp / "port" / "logs"))
    want = ref_read(str(tmp / "ref" / "logs"))
    key = ("file", "feed", "band", "flags", "flagged")
    assert [[r[k] for k in key] for r in got] == \
        [[r[k] for k in key] for r in want]
    assert len(got) == 2 * 2 * 2
    lines = [sum(1 for _ in open(tmp / name / "logs" / "quality.rank0.jsonl"))
             for name in ("port", "ref")]
    assert lines == [2 * len(got)] * 2


def test_run_astro_cal_uses_the_static_shard_under_leases(obs, tmp_path):
    """The apply pass over files whose reduction leases are committed: a
    sub-run with leases would find every unit done; it takes the static
    shard and calibrates each file, sharing the runner's timings."""
    from comapreduce_tpu_torch.calibration.apply_cal import \
        CalibratorDatabase

    tmp, files, filelist, _ = obs
    cfg = _config(tmp_path, "astro", filelist)
    runner = Runner.from_config(cfg, device="cpu")
    assert runner._resilience_runtime().lease_ttl_s > 0
    l2 = [r.filename for r in runner.run_tod(files)]
    db = CalibratorDatabase()
    db.entries.append((59620.0, "TauA", np.full((2, 2), 0.9),
                       np.ones((2, 2), bool)))
    cache = str(tmp_path / "db.npz")
    db.save(cache)
    applied = runner.run_astro_cal(files, [], cache_path=cache)
    assert [a.filename for a in applied] == l2
    for a in applied:
        np.testing.assert_array_equal(
            np.asarray(a["astro_calibration/calibration_factors"]), 0.9)
    assert len(runner.timings["ApplyCalibration"]) == 2
    assert runner._resilience_runtime().lease_ttl_s > 0


def test_run_average_refuses_figure_dir(obs, tmp_path):
    """``[Global] figure_dir`` (refused by an earlier slice) gives the
    chain's stages their figure directory."""
    tmp, _, filelist, _ = obs
    cfg = _config(tmp_path, "figs", filelist)
    cfg["Global"]["figure_dir"] = str(tmp_path / "qa")
    path = str(tmp_path / "figs.toml")
    _write_toml(path, cfg)
    assert run_average.main([path, "--device=cpu"]) == 0
    assert _figures(str(tmp_path / "qa")) == {
        "1000001": list(CHAIN_FIGURES)}


def test_calibrated_stores_map_like_the_reference(calrun, tmp_path):
    """``run_destriper main`` on the shipped ``parameters.ini`` (cut to
    the stores' two bands, on ``chip_smoke.SMALL_FIELD``'s 6' pixels: at
    the shipped 2' this small store's 3 600 samples a band leave the solve
    unconverged, see there) over the port's calibrated field store: the
    reference's ``main`` on the same store gives the same maps (within
    ``chip_smoke.MAP_ATOL`` of scale, hits equal), and ``calibration :
    false`` gives other maps (the factors are not 1)."""
    import comapreduce_tpu.cli.run_destriper as ref_rd
    import comapreduce_tpu_torch.cli.run_destriper as port_rd
    from chip_smoke import MAP_ATOL, SMALL_FIELD, shipped_destriper_ini
    from comapreduce_tpu_torch.mapmaking import fits_io

    tmp, files = calrun
    l2 = str(tmp / "port" / "level2" / ("Level2_" +
                                        os.path.basename(files[0])))
    factors = np.asarray(HDF5Store().read(l2)[
        "astro_calibration/calibration_factors"])
    assert np.abs(factors - 1).min() > 0.01
    l2list = str(tmp_path / "l2list.txt")
    with open(l2list, "w") as fh:
        fh.write(l2 + "\n")
    maps = {}
    for name, main, flags, cal in (
            ("port", port_rd.main, ["--device=cpu"], "true"),
            ("ref", ref_rd.main, [], "true"),
            ("uncal", port_rd.main, ["--device=cpu"], "false")):
        ini = shipped_destriper_ini(
            l2list, str(tmp_path / name), str(tmp_path / f"{name}.ini"),
            field=SMALL_FIELD, log_dir=str(tmp_path / name / "logs"),
            bands=[0, 1], calibration=cal)
        assert main([ini] + flags) == 0
        maps[name] = [{n: d for n, _, d in fits_io.read_fits_image(
            str(tmp_path / name / f"field_band{b}.fits"))} for b in (0, 1)]
    for got, want, uncal in zip(maps["port"], maps["ref"], maps["uncal"]):
        hit = want["HITS"] > 0
        assert hit.any()
        np.testing.assert_array_equal(got["HITS"], want["HITS"])
        scale = max(float(np.nanstd(want["DESTRIPED"])), 1.0)
        for n in ("DESTRIPED", "NAIVE"):
            np.testing.assert_allclose(got[n][hit], want[n][hit], rtol=0,
                                       atol=MAP_ATOL * scale, err_msg=n)
        np.testing.assert_array_equal(uncal["HITS"], want["HITS"])
        assert np.abs(uncal["NAIVE"][hit] - got["NAIVE"][hit]).max() > \
            10 * MAP_ATOL * scale
