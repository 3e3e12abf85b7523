"""The port's synthetic campaign engine (``comapreduce_tpu_torch/
synthetic/`` scenario, generator and memsource, and ``cli/
run_synthetic``'s ``generate`` and ``drill``) against the reference's
(``comapreduce_tpu/synthetic/``) on the CPU.

- Scenario strictness as the reference's own tests hold it
  (``tests/test_synthetic_campaign.py``): unknown keys and sections
  raise, the vane-pad trap fires exactly where the reference's does, and
  a scenario TOML written by the reference's writer loads to the same
  config in both packages.
- Determinism, bit for bit: ``generate_level1_store(file_params(cfg,
  i))``, ``load_virtual`` and ``probe_virtual`` equal the reference's,
  array for array and attribute for attribute, on a scenario with an
  injected sky and faults and on one whose ``shape_jitter`` drives a
  scan to length 0; within the port, disk (``write_campaign``) equals
  memory (``load_virtual``).
- Missing members (unregistered, out of range, misnamed) raise
  ``FileNotFoundError``, also through ``ingest.loaders.load_level1``;
  the registries of the two packages are separate.
- ``Runner.run_tod`` over ``synth://`` members with the shipped chain:
  the port's Level-2 is bitwise equal with prefetch and cache on and
  off, and within ``chip_smoke.check_level2``'s chain tolerances of the
  reference's (the rules ``tests/test_torch_stages.py`` uses).
- ``run_synthetic generate`` prints the reference's JSON keys and writes
  the reference's files and truth; ``drill`` without a card raises
  before any worker starts.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import check_level2, noise_fit_losses, shipped_chain_config
from comapreduce_tpu.cli import run_synthetic as ref_cli
from comapreduce_tpu.data import synthetic as ref_syn
from comapreduce_tpu.data.hdf5io import HDF5Store as RefStore
from comapreduce_tpu.pipeline import Runner as RefRunner
from comapreduce_tpu.synthetic import generator as ref_gen
from comapreduce_tpu.synthetic import memsource as ref_mem
from comapreduce_tpu.synthetic import scenario as ref_scn
from comapreduce_tpu.synthetic.loadgen import write_scenario_toml
from comapreduce_tpu_torch.cli import run_synthetic
from comapreduce_tpu_torch.data import synthetic as port_syn
from comapreduce_tpu_torch.data.hdf5io import HDF5Store
from comapreduce_tpu_torch.ingest.loaders import load_level1
from comapreduce_tpu_torch.pipeline import Runner
from comapreduce_tpu_torch.synthetic import generator as gen
from comapreduce_tpu_torch.synthetic import memsource as mem
from comapreduce_tpu_torch.synthetic.scenario import (ScenarioConfig,
                                                      load_scenario)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The chain's stages are many small ops on these shapes: one torch
    thread (the suite's parallel workers would oversubscribe the
    cores); the default is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_registries():
    """Each package keeps its own process-global registry: clear both."""
    mem.clear_registry()
    ref_mem.clear_registry()
    yield
    mem.clear_registry()
    ref_mem.clear_registry()


TINY = dict(name="tinytest", n_files=2, seed=3, n_feeds=1, n_bands=1,
            n_channels=4, n_scans=2, scan_samples=96, vane_samples=48,
            gap_samples=24)
# an injected sky with a spectral index, additive 1/f, weather drift and
# faults: every knob that changes the bytes
RICH = dict(TINY, name="rich", n_files=3, n_feeds=2, n_bands=2,
            n_channels=8, gap_samples=60, t_atm_sigma=0.05,
            weather_drift=2.0, spike_rate=0.01, nan_rate=0.005,
            sky_amplitude_k=0.4, sky_fwhm_deg=0.2, sky_index=-2.0,
            shape_jitter=8)
# the jitter drives some member's scans to length 0
JITTER = dict(TINY, name="jitter", n_files=6, scan_samples=8,
              shape_jitter=16)


def _pair(**knobs):
    return ScenarioConfig.coerce(knobs), ref_scn.ScenarioConfig.coerce(knobs)


def _assert_stores_equal(got, want):
    """Two Level-1 stores (either package's) equal bit for bit: the same
    datasets with the same dtypes and bytes (NaN where NaN), and the
    same attributes."""
    assert sorted(got.keys()) == sorted(want.keys())
    for name in want.keys():
        a, b = np.asarray(got[name]), np.asarray(want[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    ga = {k: dict(v) for k, v in got.attr_items()}
    wa = {k: dict(v) for k, v in want.attr_items()}
    assert ga.keys() == wa.keys()
    for path in wa:
        assert ga[path].keys() == wa[path].keys(), path
        for key, v in wa[path].items():
            assert np.array_equal(np.asarray(ga[path][key]),
                                  np.asarray(v)), (path, key)


# ---------------------------------------------------------- scenario I/O
def test_knobs_and_defaults_match_reference():
    assert ScenarioConfig.KNOBS == ref_scn.ScenarioConfig.KNOBS
    assert dataclasses.asdict(ScenarioConfig()) == \
        dataclasses.asdict(ref_scn.ScenarioConfig())


@pytest.mark.parametrize("text, match", [
    ('[scenario]\nname = "x"\nn_fils = 10\n', "n_fils"),
    ('[scenario]\nname = "x"\n\n[Destriper]\nniter = 5\n', "Destriper"),
    ('[Global]\nx = 1\n', "scenario"),
])
def test_load_is_strict_like_the_reference(tmp_path, text, match):
    p = tmp_path / "bad.toml"
    p.write_text(text)
    with pytest.raises(ValueError, match=match):
        load_scenario(str(p))
    with pytest.raises(ValueError, match=match):
        ref_scn.load_scenario(str(p))


def test_missing_scenario_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="scenario file"):
        load_scenario(str(tmp_path / "none.toml"))


def test_coerce_rejects_unknown_keys_and_types():
    with pytest.raises(ValueError, match="sky_amplitude"):
        ScenarioConfig.coerce({"sky_amplitude": 1.0})
    with pytest.raises(TypeError, match="ScenarioConfig"):
        ScenarioConfig.coerce([("name", "x")])
    assert ScenarioConfig.coerce(None) == ScenarioConfig()
    cfg = ScenarioConfig(name="x")
    assert ScenarioConfig.coerce(cfg) is cfg
    # from_mapping picks the knobs out of a wider table
    assert ScenarioConfig.from_mapping({"n_files": 3, "niter": 5}) == \
        ScenarioConfig(n_files=3)


@pytest.mark.parametrize("knobs, match", [
    (dict(n_files=0), "n_files"), (dict(n_feeds=0), "n_feeds"),
    (dict(scan_samples=-1), "scan_samples"),
])
def test_invalid_scenarios_raise(knobs, match):
    with pytest.raises(ValueError, match=match):
        ScenarioConfig.coerce(knobs)
    with pytest.raises(ValueError, match=match):
        ref_scn.ScenarioConfig.coerce(knobs)


@pytest.mark.parametrize("knobs", [TINY, RICH, JITTER])
def test_reference_toml_round_trips_in_both_packages(tmp_path, knobs):
    cfg, ref = _pair(**knobs)
    path = write_scenario_toml(ref, str(tmp_path / "scn.toml"))
    back = load_scenario(path)
    assert back == cfg  # every knob survives the round trip
    assert dataclasses.asdict(back) == \
        dataclasses.asdict(ref_scn.load_scenario(path))


@pytest.mark.parametrize("knobs, pad, raises", [
    (dict(gap_samples=24, spike_rate=0.01), 24, True),
    (dict(gap_samples=24, nan_rate=0.01), 50, True),
    (dict(gap_samples=24), 50, False),          # fault-free passes
    (dict(gap_samples=24, spike_rate=0.01, nan_rate=0.01), 23, False),
    (dict(vane_samples=0, gap_samples=8, spike_rate=0.01), 50, False),
])
def test_vane_pad_trap_matches_reference(knobs, pad, raises):
    cfg, ref = _pair(**dict(TINY, **knobs))
    if raises:
        with pytest.raises(ValueError, match="vane window pad.*gap_samples"):
            cfg.validate_vane_pad(pad)
        with pytest.raises(ValueError, match="gap_samples"):
            ref.validate_vane_pad(pad)
    else:
        assert cfg.validate_vane_pad(pad) is cfg
        assert ref.validate_vane_pad(pad) is ref


def test_pad_trap_threads_through_load_and_register(tmp_path):
    p = tmp_path / "faulted.toml"
    p.write_text('[scenario]\nname = "x"\ngap_samples = 10\n'
                 'spike_rate = 0.01\n')
    with pytest.raises(ValueError, match="faulted.toml.*gap_samples"):
        load_scenario(str(p), vane_pad=30)
    # without the consumer's pad the trap cannot (and must not) fire
    assert load_scenario(str(p)).gap_samples == 10
    with pytest.raises(ValueError, match="gap_samples"):
        mem.register_scenario_file(str(p), vane_pad=30)
    assert mem.registered("x") is None  # nothing registered
    assert mem.register_scenario_file(str(p)) == mem.registered("x")


# ------------------------------------------------------------ generator
@pytest.mark.parametrize("knobs", [TINY, RICH, JITTER])
def test_file_params_truth_and_names_match_reference(knobs):
    cfg, ref = _pair(**knobs)
    for i in range(cfg.n_files):
        a, b = gen.file_params(cfg, i), ref_gen.file_params(ref, i)
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        sa, sb = da.pop("sky_model"), db.pop("sky_model")
        assert da == db
        assert (sa is None) == (sb is None)
        assert gen.file_basename(cfg, i) == ref_gen.file_basename(ref, i)
        assert gen._jitter(cfg, i) == ref_gen._jitter(ref, i)
    assert gen.campaign_truth(cfg) == ref_gen.campaign_truth(ref)
    assert gen.virtual_filelist(cfg) == ref_gen.virtual_filelist(ref)
    assert gen.SCHEME == ref_gen.SCHEME
    assert len(gen.campaign_params(cfg)) == cfg.n_files
    with pytest.raises(IndexError, match="outside scenario"):
        gen.file_params(cfg, cfg.n_files)


def test_jitter_reaches_a_zero_length_scan():
    cfg, _ = _pair(**JITTER)
    lengths = [gen.file_params(cfg, i).scan_samples
               for i in range(cfg.n_files)]
    assert min(lengths) == 0  # the edge is actually exercised


@pytest.mark.parametrize("knobs", [RICH, JITTER])
def test_generated_members_equal_reference_bit_for_bit(knobs):
    cfg, ref = _pair(**knobs)
    for i in range(cfg.n_files):
        _, got = port_syn.generate_level1_store(gen.file_params(cfg, i))
        _, want = ref_syn.generate_level1_store(ref_gen.file_params(ref, i))
        _assert_stores_equal(got, want)


@pytest.mark.parametrize("knobs", [RICH, JITTER])
def test_load_and_probe_virtual_equal_reference(knobs):
    cfg, ref = _pair(**knobs)
    mem.register_scenario(cfg)
    ref_mem.register_scenario(ref)
    for path in gen.virtual_filelist(cfg):
        got, want = mem.load_virtual(path), ref_mem.load_virtual(path)
        _assert_stores_equal(got, want)
        assert got.source_filename == want.source_filename == path
        probe = mem.probe_virtual(path)
        assert probe == ref_mem.probe_virtual(path)
        assert mem.probe_virtual(path, pad_to=64) == \
            ref_mem.probe_virtual(path, pad_to=64)
        tod = np.asarray(got["spectrometer/tod"])
        assert (probe["F"], probe["B"], probe["C"], probe["T"]) == tod.shape
        assert probe["S"] == cfg.n_scans


def test_disk_equals_memory_within_the_port(tmp_path):
    cfg = mem.register_scenario(ScenarioConfig.coerce(RICH))
    paths = gen.write_campaign(cfg, str(tmp_path), indices=[0, 2])
    assert [os.path.basename(p) for p in paths] == \
        [gen.file_basename(cfg, i) for i in (0, 2)]
    for i, path in zip((0, 2), paths):
        disk = HDF5Store().read(path)
        _assert_stores_equal(disk, mem.load_virtual(
            gen.virtual_filelist(cfg)[i]))


def test_write_campaign_writes_the_reference_bytes(tmp_path):
    cfg, ref = _pair(**TINY)
    got = gen.write_campaign(cfg, str(tmp_path / "port"), indices=[1])
    want = ref_gen.write_campaign(ref, str(tmp_path / "ref"), indices=[1])
    _assert_stores_equal(HDF5Store().read(got[0]),
                         RefStore().read(want[0]))


# ------------------------------------------------------------- registry
def test_registry_semantics():
    cfg = mem.register_scenario(dict(TINY))
    assert isinstance(cfg, ScenarioConfig)
    assert mem.register_scenario(ScenarioConfig.coerce(TINY)) == cfg
    with pytest.raises(ValueError, match="already registered"):
        mem.register_scenario(dict(TINY, seed=4))
    got, idx = mem.parse_virtual(gen.virtual_filelist(cfg)[1])
    assert got == cfg and idx == 1
    assert mem.is_virtual("synth://a/0/b") and not mem.is_virtual("a.hd5")
    assert not mem.is_virtual(None)
    with pytest.raises(ValueError, match="not a synth"):
        mem.parse_virtual("level1/comap.hd5")
    mem.clear_registry()
    assert mem.registered(cfg.name) is None


def _missing_paths(cfg):
    wider = dataclasses.replace(cfg, n_files=3)
    return [
        ("synth://nope/00000/x.hd5", "not registered"),
        (f"synth://{cfg.name}/00002/{gen.file_basename(wider, 2)}",
         "no such"),
        (f"synth://{cfg.name}/00000/other.hd5", "no such"),
        (f"synth://{cfg.name}/zero/{gen.file_basename(cfg, 0)}",
         "bad member index"),
        (f"synth://{cfg.name}/{gen.file_basename(cfg, 0)}", "malformed"),
    ]


def test_missing_members_are_file_not_found():
    cfg = mem.register_scenario(ScenarioConfig.coerce(TINY))
    ref_mem.register_scenario(ref_scn.ScenarioConfig.coerce(TINY))
    for path, match in _missing_paths(cfg):
        with pytest.raises(FileNotFoundError, match=match):
            mem.parse_virtual(path)
        with pytest.raises(FileNotFoundError, match=match):
            ref_mem.parse_virtual(path)
        # the loaders' per-file fault net sees a missing file
        with pytest.raises(FileNotFoundError, match=match):
            load_level1(path)
        with pytest.raises(FileNotFoundError, match=match):
            mem.probe_virtual(path)


def test_the_packages_keep_separate_registries():
    """One name, a different config in each package: each resolves its
    own, and neither registration collides with the other."""
    cfg = mem.register_scenario(dict(TINY, seed=5))
    ref = ref_mem.register_scenario(dict(TINY, seed=6))
    path = gen.virtual_filelist(cfg)[0]
    assert mem.parse_virtual(path)[0].seed == 5
    assert ref_mem.parse_virtual(path)[0].seed == 6
    got = np.asarray(mem.load_virtual(path)["spectrometer/tod"])
    _, want = ref_syn.generate_level1_store(ref_gen.file_params(
        ref_scn.ScenarioConfig.coerce(dict(TINY, seed=5)), 0))
    assert got.tobytes() == np.asarray(want["spectrometer/tod"]).tobytes()
    assert ref.seed == 6
    mem.clear_registry()
    assert ref_mem.registered(cfg.name) is not None


def test_load_level1_serves_members_eager_and_lazy():
    from comapreduce_tpu_torch.data.level import COMAPLevel1

    cfg = mem.register_scenario(ScenarioConfig.coerce(TINY))
    path = gen.virtual_filelist(cfg)[0]
    lazy = load_level1(path, eager_tod=False)
    assert isinstance(lazy, COMAPLevel1)
    payload = load_level1(path)
    assert payload["source"] == path
    want = mem.load_virtual(path)
    np.testing.assert_array_equal(payload["data"]["spectrometer/tod"],
                                  np.asarray(want["spectrometer/tod"]))
    bf16 = load_level1(path, tod_dtype="bf16")
    assert type(bf16["data"]["spectrometer/tod"]).__name__ == "BF16Array"


def test_cache_key_of_a_member_never_stats():
    from comapreduce_tpu_torch.ingest.cache import file_key

    p = "synth://whatever/00000/file.hd5"
    assert file_key(p) == (p, 0)


# ------------------------------------------------- the chain over synth://
# a faulted campaign the shipped chain reduces: the gap (64) clears the
# MeasureSystemTemperature pad (50), and the 1/f atmosphere keeps the
# noise fits well posed
CHAIN_SCN = dict(name="chainsynth", n_files=2, seed=11, n_feeds=2,
                 n_bands=2, n_channels=32, n_scans=2, scan_samples=600,
                 vane_samples=120, gap_samples=64, t_atm_sigma=0.02,
                 spike_rate=0.002, nan_rate=0.001)


def _chain_config(out, ingest=None):
    cfg = shipped_chain_config()
    cfg["Global"].update(output_dir=str(out / "level2"),
                         log_dir=str(out / "logs"))
    if ingest:
        cfg["ingest"] = ingest
    return cfg


@pytest.fixture(scope="module")
def chain_runs(tmp_path_factory):
    """The campaign through the shipped chain: the reference once, the
    port serially and with prefetch + cache. Returns the Level-2 paths
    of each run, in member order."""
    mem.clear_registry()
    ref_mem.clear_registry()
    tmp = tmp_path_factory.mktemp("synthchain")
    cfg, ref = _pair(**CHAIN_SCN)
    cfg.validate_vane_pad(50)
    mem.register_scenario(cfg)
    ref_mem.register_scenario(ref)
    files = gen.virtual_filelist(cfg)
    out = {}
    results = RefRunner.from_config(_chain_config(tmp / "ref")).run_tod(
        list(files))
    out["ref"] = [r.filename for r in results]
    for tag, ingest in (("serial", None),
                        ("prefetch", {"prefetch": 2, "cache_mb": 64})):
        runner = Runner.from_config(_chain_config(tmp / tag, ingest),
                                    device="cpu")
        results = runner.run_tod(list(files))
        assert all(r is not None for r in results), tag
        out[tag] = [r.filename for r in results]
    mem.clear_registry()
    ref_mem.clear_registry()
    return files, out


def test_chain_over_members_is_bitwise_with_prefetch_and_cache(chain_runs):
    files, out = chain_runs
    for i, base in enumerate(files):
        assert os.path.basename(out["serial"][i]) == \
            "Level2_" + os.path.basename(base)
        a = HDF5Store().read(out["serial"][i])
        b = HDF5Store().read(out["prefetch"][i])
        assert sorted(a.keys()) == sorted(b.keys())
        for name in a.keys():
            x, y = np.asarray(a[name]), np.asarray(b[name])
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name


def test_chain_over_members_matches_reference(chain_runs):
    _, out = chain_runs
    for got, want in zip(out["serial"], out["ref"]):
        assert os.path.basename(got) == os.path.basename(want)
        store = HDF5Store().read(got)
        w = np.asarray(store["averaged_tod/weights"])
        assert np.isfinite(w).all() and (w > 0).any()
        check_level2(store, RefStore().read(want), got,
                     fit_loss=noise_fit_losses)


# ------------------------------------------------------------------ CLI
def test_generate_prints_reference_keys_and_writes_reference_files(
        tmp_path, capsys):
    _, ref = _pair(**TINY)
    scn = write_scenario_toml(ref, str(tmp_path / "scn.toml"))
    lines = {}
    for tag, main in (("port", run_synthetic.main), ("ref", ref_cli.main)):
        assert main(["generate", scn, "--out-dir",
                     str(tmp_path / tag)]) == 0
        lines[tag] = json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1])
    assert lines["port"].keys() == lines["ref"].keys()
    for key in ("scenario", "seed", "n_files"):
        assert lines["port"][key] == lines["ref"][key]
    with open(lines["port"]["truth"]) as a, open(lines["ref"]["truth"]) as b:
        assert json.load(a) == json.load(b)
    for i in range(ref.n_files):
        base = ref_gen.file_basename(ref, i)
        _assert_stores_equal(HDF5Store().read(str(tmp_path / "port" / base)),
                             RefStore().read(str(tmp_path / "ref" / base)))


def test_drill_names_its_unported_parts(tmp_path):
    """``drill`` was refused until the scale drill was ported
    (``tests/test_torch_loadgen.py`` runs it through this CLI on the
    CPU); what it still refuses is the card it defaults to, before any
    worker starts, naming the CPU opt-in."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the drill would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_synthetic.main(["drill", "--workdir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_chip_phase_l2_rehearses_on_the_cpu(tmp_path):
    """``chip_smoke.phase_synth_full`` (phase L.2) on the CPU at a small
    width: both members reduced through the prefetcher, generated on its
    worker, with positive scan weights and the probe's shapes."""
    import chip_smoke

    line = chip_smoke.phase_synth_full(device="cpu", base=str(tmp_path),
                                       n_feeds=2, n_bands=2, n_channels=32,
                                       scan_samples=400)
    assert [f["thread"] for f in line["files"]] == ["ingest-prefetch"] * 2
    assert set(line["leases"].values()) == {"done"}
    for f in line["files"]:
        assert f["probe"]["S"] == 2 and f["generate_s"] > 0
        assert f["tod_shape"][:3] == [2, 2, 32]
    assert mem.registered("chip_full") is None
