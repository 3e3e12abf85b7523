"""The port's campaign layer (``comapreduce_tpu_torch/pipeline/
campaign.py``) against the reference's (``comapreduce_tpu/pipeline/
campaign.py``) on the CPU:

- ``CampaignConfig`` (coercion, strict keys, its ``ShapeBuckets``);
- ``probe_observation`` on a Level-1 file and on ``synth://`` members,
  ``campaign_bucket_set`` (jittered members in one bucket);
- ``Warmup``'s bookkeeping (``warmed``, ``shapes``, ``errors``, the
  dedup on the canonical bucket) over the same files and stub stages in
  both packages, and the port's stages' ``warm_programs`` hooks (the
  same four stages as the reference's; on the CPU they build nothing);
- ``CompileCounter`` over ``_build``'s events, ``enable_compile_cache``
  moving the library directory;
- bucketed against unbucketed Level-2 (the reference's parity cases,
  ``tests/test_campaign.py:187``): the port's bucketed run held to its
  exact run with the reference's tolerances (2e-5 relative, 1e-6
  absolute), and to the reference's bucketed run by ``check_level2``;
- ``Runner`` under ``[campaign] warm_compile`` with ``compile_cache_dir``
  on the CPU: the warm-up runs, records no error and builds nothing.

The reference's warm-up test that fails on the seed (its steady-state
recompile gate) is not copied.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import check_level2
from comapreduce_tpu.data.hdf5io import HDF5Store as RefStore
from comapreduce_tpu.data.synthetic import (SyntheticObsParams,
                                            generate_level1_file)
from comapreduce_tpu.ops.reduce import ShapeBuckets as RefBuckets
import comapreduce_tpu.pipeline.campaign as ref_camp
from comapreduce_tpu.synthetic import memsource as ref_mem
from comapreduce_tpu.synthetic.scenario import \
    ScenarioConfig as RefScenario
from comapreduce_tpu_torch import _build
from comapreduce_tpu_torch.data.hdf5io import HDF5Store
import comapreduce_tpu_torch.pipeline.campaign as camp
from comapreduce_tpu_torch.ops.reduce import ShapeBuckets
from comapreduce_tpu_torch.synthetic import generator as gen
from comapreduce_tpu_torch.synthetic import memsource as mem
from comapreduce_tpu_torch.synthetic.scenario import ScenarioConfig

# the reference's bucketed-vs-exact tolerances (tests/test_campaign.py:23)
PARITY_RTOL = 2e-5
PARITY_ATOL = 1e-6
# quanta that pad every axis of the fixture's geometry
# (T=1692 -> 2048, S=3 -> 4, L=512 -> 768), as the reference's
BUCKETS = {"t_quantum": 2048, "scan_quantum": 4, "l_quantum": 768}
# a jittered synthetic campaign: members differ in T and L
JITTER = dict(name="camp_jitter", n_files=3, n_feeds=2, n_channels=16,
              n_scans=3, scan_samples=400, shape_jitter=16, seed=5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth_obs(tmp_path_factory):
    """The reference test's two observations: a field and a TauA
    calibrator, 2 feeds x 1 band x 16 channels x 3 scans of 400."""
    d = tmp_path_factory.mktemp("campaign_obs")
    field = str(d / "comap-0000042-synth.hd5")
    generate_level1_file(field, SyntheticObsParams(
        n_feeds=2, n_bands=1, n_channels=16, n_scans=3,
        scan_samples=400, vane_samples=120, seed=42, obsid=42))
    cal = str(d / "comap-0000043-synth.hd5")
    generate_level1_file(cal, SyntheticObsParams(
        n_feeds=2, n_bands=1, n_channels=16, n_scans=3,
        scan_samples=400, vane_samples=120, seed=43, obsid=43,
        source="TauA"))
    return {"field": field, "cal": cal}


@pytest.fixture
def jitter_campaign():
    cfg = mem.register_scenario(ScenarioConfig.coerce(JITTER))
    ref_mem.register_scenario(RefScenario.coerce(JITTER))
    yield gen.virtual_filelist(cfg)
    mem.clear_registry()
    ref_mem.clear_registry()


def test_campaign_config_like_the_reference():
    for value in (None, {}, {"t_quantum": 4096, "scan_quantum": 4,
                             "l_quantum": 1024, "warm_compile": True},
                  {"t_quantum": -3, "warm_compile": 0}):
        got = camp.CampaignConfig.coerce(value)
        want = ref_camp.CampaignConfig.coerce(value)
        assert [getattr(got, k) for k in camp.CampaignConfig.KNOBS] == \
            [getattr(want, k) for k in ref_camp.CampaignConfig.KNOBS]
        assert repr(got.shape_buckets()) == repr(want.shape_buckets())
    assert camp.CampaignConfig.KNOBS == ref_camp.CampaignConfig.KNOBS
    for mod in (camp, ref_camp):
        with pytest.raises(ValueError, match="unknown campaign keys"):
            mod.CampaignConfig.coerce({"t_quantm": 1})
        with pytest.raises(TypeError):
            mod.CampaignConfig.coerce([1])


def test_probe_observation_and_bucket_set_like_the_reference(synth_obs):
    shapes = []
    for key in ("field", "cal"):
        got = camp.probe_observation(synth_obs[key])
        assert got == ref_camp.probe_observation(synth_obs[key])
        assert camp.probe_observation(synth_obs[key], pad_to=64) == \
            ref_camp.probe_observation(synth_obs[key], pad_to=64)
        shapes.append(got)
    assert (shapes[0]["F"], shapes[0]["B"], shapes[0]["C"]) == (2, 1, 16)
    assert shapes[1]["calibrator"] and not shapes[0]["calibrator"]
    bk = ShapeBuckets(**BUCKETS)
    jit1 = dict(shapes[0], T=shapes[0]["T"] - 40, L=shapes[0]["L"] - 64)
    for s in ([shapes[0], shapes[1]], [shapes[0], jit1]):
        assert camp.campaign_bucket_set(s, bk) == \
            ref_camp.campaign_bucket_set(s, RefBuckets(**BUCKETS))
    assert len(camp.campaign_bucket_set(shapes, bk)) == 2
    assert len(camp.campaign_bucket_set([shapes[0], jit1], bk)) == 1


def test_probe_of_synth_members_like_the_reference(jitter_campaign):
    shapes = [camp.probe_observation(p) for p in jitter_campaign]
    assert shapes == [ref_camp.probe_observation(p)
                      for p in jitter_campaign]
    # the jitter moves T and L between members ...
    assert len({(s["T"], s["L"]) for s in shapes}) > 1
    # ... and the documented quanta put them in one bucket
    bk = ShapeBuckets(t_quantum=4096, scan_quantum=4, l_quantum=1024)
    assert len(camp.campaign_bucket_set(shapes, bk)) == 1


class _Stub:
    """A stage with the warm-up hook: records its calls, and raises for
    one calibrator flag when asked."""

    def __init__(self, name, fail_on=None):
        self.name = name
        self.calls = []
        self.fail_on = fail_on

    def warm_programs(self, **shape):
        self.calls.append(shape)
        if shape.get("calibrator") == self.fail_on:
            raise RuntimeError("warm failed")


@pytest.mark.parametrize("bucketed", [True, False])
def test_warmup_bookkeeping_like_the_reference(synth_obs, jitter_campaign,
                                               bucketed):
    """The same files (two jittered members, one field file, one
    calibrator, a missing path) through both packages' ``Warmup`` with
    the same stubs: the same shapes, warmed entries and stage calls, the
    same errors (one probe error, one stage failure); with the canonical
    bucket the jittered members warm once."""
    files = list(jitter_campaign[:2]) + [synth_obs["field"],
                                         synth_obs["cal"], "/nonexistent.hd5"]
    out = {}
    for mod, buckets in (
            (camp, ShapeBuckets(**BUCKETS) if bucketed else None),
            (ref_camp, RefBuckets(**BUCKETS) if bucketed else None)):
        stubs = [_Stub("A"), _Stub("B", fail_on=True), object()]
        w = mod.start_warmup(stubs, files, buckets=buckets)
        w.join(timeout=120)
        assert w.done
        out[mod.__name__] = (w.shapes, w.warmed, [len(s.calls)
                                                  for s in stubs[:2]],
                             [e.split(":")[0] for e in w.errors])
    got, want = out[camp.__name__], out[ref_camp.__name__]
    assert got == want
    shapes, warmed, calls, errors = got
    assert len(shapes) == 4 and len(errors) == 2
    assert errors[0].startswith("_Stub @ ")
    assert errors[1] == "probe /nonexistent.hd5"
    bk = ShapeBuckets(**BUCKETS)
    keys = {(s["F"], s["B"], s["C"]) + bk.canonical(s["T"], s["S"], s["L"])
            + (s["calibrator"],) if bucketed else tuple(sorted(s.items()))
            for s in shapes}
    # one warm a stage a distinct key; the failing stub's calibrator call
    # is the one missing from warmed
    assert calls == [len(keys)] * 2
    assert len(warmed) == 2 * len(keys) - 1
    if bucketed:
        # the two jittered members share one bucket
        assert len(keys) < 4


def test_stages_carry_the_reference_warm_hooks():
    """The port's stages with ``warm_programs`` are the reference's; on
    the CPU the hook builds nothing (the plain versions need no library)
    and the reduction names K1's, K2's and K5's libraries."""
    import comapreduce_tpu.pipeline.stages as ref_stages
    import comapreduce_tpu_torch.pipeline.stages as stages

    def hooked(m):
        return sorted(n for n in m.__all__ if callable(getattr(
            getattr(m, n), "warm_programs", None)))

    assert hooked(stages) == hooked(ref_stages) == [
        "AtmosphereRemoval", "Level1Averaging",
        "Level1AveragingGainCorrection", "SkyDip"]
    red = stages.Level1AveragingGainCorrection(device="cpu")
    assert red.kernel_libraries == ("masked_fill", "rolling_median",
                                    "prefilter")
    events = []

    def listen(*e):
        events.append(e)

    _build.add_listener(listen)
    try:
        for name in hooked(stages):
            getattr(stages, name)(device="cpu").warm_programs(
                2, 1, 16, 1692, 3, 512, calibrator=False)
    finally:
        _build.remove_listener(listen)
    assert events == []


def test_compile_counter_and_cache_dir(tmp_path):
    """``CompileCounter`` counts ``_build``'s events under the
    reference's keys (a build is a backend compile and a cache miss, a
    library found on disk a hit) with the thread of each; detached it
    counts nothing. ``enable_compile_cache`` moves the library
    directory (idempotent; '' is off)."""
    with camp.CompileCounter() as c:
        assert set(c.snapshot()) == {"backend_compiles", "cache_hits",
                                     "cache_misses", "compile_s"}
        _build._notify("build", "masked_fill", 2.5)
        _build._notify("found", "rolling_median")
        snap = c.snapshot()
    assert snap == {"backend_compiles": 1, "cache_hits": 1,
                    "cache_misses": 1, "compile_s": 2.5}
    assert [e[:2] for e in c.events] == [("build", "masked_fill"),
                                         ("found", "rolling_median")]
    assert {e[2] for e in c.events} == {"MainThread"}
    _build._notify("build", "masked_fill", 1.0)
    assert c.snapshot() == snap
    try:
        assert not camp.enable_compile_cache("")
        assert camp.enable_compile_cache(str(tmp_path / "cc"))
        assert camp.enable_compile_cache(str(tmp_path / "cc"))
        assert _build.build_dir() == (tmp_path / "cc").resolve()
        assert _build._lib_path("masked_fill").parent == _build.build_dir()
    finally:
        _build.set_build_dir(None)
        camp._CACHE_DIR_ENABLED = None
    assert _build.build_dir().parts[-2:] == ("build",
                                             "comapreduce_tpu_torch")


def _chain(mod, window=301):
    s = mod.stages
    return [s.CheckLevel1File(min_duration_seconds=0.0),
            s.AssignLevel1Data(), s.MeasureSystemTemperature(),
            s.SkyDip(), s.AtmosphereRemoval(),
            s.Level1Averaging(frequency_bin_size=8),
            s.Level1AveragingGainCorrection(medfilt_window=window)]


def _run_chain(pkg, outdir, files, campaign=None, ingest=None):
    import comapreduce_tpu.pipeline as ref_pipeline
    import comapreduce_tpu_torch.pipeline as pipeline

    kw = {"device": "cpu"} if pkg == "port" else {}
    mod = pipeline if pkg == "port" else ref_pipeline
    runner = mod.Runner(processes=_chain(mod), output_dir=str(outdir),
                        campaign=campaign, ingest=ingest,
                        resilience={"quarantine": "off", "heartbeat_s": 0},
                        **kw)
    results = runner.run_tod(files)
    assert all(r is not None for r in results), "chain failed"
    (name,) = [f for f in os.listdir(outdir)
               if f.startswith("Level2_") and not f.endswith(".s256")]
    return runner, os.path.join(str(outdir), name)


def _datasets(path) -> dict:
    import h5py

    out = {}
    with h5py.File(path, "r") as h:
        def visit(name, node):
            if isinstance(node, h5py.Dataset):
                out[name] = node[...]
        h.visititems(visit)
    return out


@pytest.mark.parametrize("key", ["field", "cal"])
def test_bucketed_level2_matches_exact_and_the_reference(synth_obs,
                                                         tmp_path, key):
    """The reference's parity cases through the port: the bucketed
    run's Level-2 equals the exact run's within the reference's
    tolerances, and the port's bucketed Level-2 is held to the
    reference's bucketed one by ``check_level2``."""
    files = [synth_obs[key]]
    _, exact = _run_chain("port", tmp_path / "exact", files)
    _, bucketed = _run_chain("port", tmp_path / "bucketed", files,
                             campaign=BUCKETS)
    _, ref = _run_chain("ref", tmp_path / "ref", files, campaign=BUCKETS)
    a = _datasets(exact)
    b = _datasets(bucketed)
    assert set(a) == set(b)
    for path in sorted(a):
        assert a[path].shape == b[path].shape, path
        if np.issubdtype(a[path].dtype, np.floating):
            np.testing.assert_allclose(b[path], a[path], rtol=PARITY_RTOL,
                                       atol=PARITY_ATOL, equal_nan=True,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(b[path], a[path], err_msg=path)
    check_level2(HDF5Store().read(bucketed), RefStore().read(ref), key)


def test_runner_warm_compile_on_the_cpu(synth_obs, tmp_path):
    """``[campaign] warm_compile`` with ``compile_cache_dir``: the
    Runner's warm-up probes the file and calls the chain's four hooks,
    records no error, and on the CPU builds nothing (the cache directory
    stays empty); without ``compile_cache_dir`` it is skipped, as the
    reference's is."""
    try:
        with camp.CompileCounter() as c:
            runner, _ = _run_chain(
                "port", tmp_path / "warm", [synth_obs["field"]],
                campaign=dict(BUCKETS, warm_compile=True),
                ingest={"compile_cache_dir": str(tmp_path / "cc")})
            runner.warmup.join(timeout=60)
        assert runner.warmup.errors == []
        assert sorted(w["stage"] for w in runner.warmup.warmed) == [
            "AtmosphereRemoval", "Level1Averaging",
            "Level1AveragingGainCorrection", "SkyDip"]
        assert c.snapshot()["backend_compiles"] == 0
        assert os.listdir(tmp_path / "cc") == []
    finally:
        _build.set_build_dir(None)
        camp._CACHE_DIR_ENABLED = None
    runner, _ = _run_chain("port", tmp_path / "nocache",
                           [synth_obs["field"]],
                           campaign={"warm_compile": True})
    assert runner.warmup is None
