"""Each stage of the port (``pipeline/stages.py``) against the reference's
on the same Level-1 file and the same Level-2 inputs (CPU): the
reference runs the shipped chain (``examples/configs/configuration.toml``
kwargs) stage by stage once; every port stage then takes the reference's
Level-2 store as it stood before that stage, and its outputs are held to
the reference stage's dataset by dataset with ``chip_smoke.level2_diffs``
— the rules the card-vs-CPU comparison uses, stated there: the vane at
the reference's rtol 2e-5, the atmosphere fit's model at 2e-4 of scale,
the reduction at the chain's 2e-3 of scale (``tests/test_torch_reduce.py``),
spike masks equal up to near-threshold flips, and the noise fits'
models within one standard error of every log bin they fit (their 1/f
parameters are degenerate on this white data). Beside them: ``Level1Averaging``, a stage
under a campaign shape bucket, ``reduce_feeds`` against the reference's
``reduce_feeds_sharded`` on a one-device mesh, the scan-length buckets,
the falsy-``STATE`` gates and the unported options.
"""

import copy
import os

import numpy as np
import pytest
import torch

from chip_smoke import (ROOT, SHIPPED_CONFIG, atmosphere_model,
                        check_level2, pipeline_test_params)
from comapreduce_tpu.data.level import COMAPLevel1 as RefL1
from comapreduce_tpu.data.level import COMAPLevel2 as RefL2
from comapreduce_tpu.data.synthetic import (SyntheticObsParams,
                                            generate_level1_file)
from comapreduce_tpu.pipeline import stages as ref_st
from comapreduce_tpu.pipeline.config import load_toml
from comapreduce_tpu_torch.convert import (level2_from_reference,
                                           reduce_config_from_reference)
from comapreduce_tpu_torch.data.level import COMAPLevel1 as PortL1
from comapreduce_tpu_torch.pipeline import stages as port_st
from comapreduce_tpu_torch.pipeline.registry import resolve

CHAIN = load_toml(os.path.join(ROOT, SHIPPED_CONFIG))
NAMES = CHAIN["Global"]["processes"]


def _kwargs(name):
    return dict(CHAIN.get(name, {}))


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The reference's shipped chain over the reference pipeline test's
    observation: ``{stage: (ref stage after its call, Level-2 store
    before it)}`` and the file."""
    tmp = tmp_path_factory.mktemp("stages")
    path = str(tmp / "comap-0000007.hd5")
    p = pipeline_test_params()
    generate_level1_file(path, SyntheticObsParams(**{
        k: getattr(p, k) for k in ("n_feeds", "n_bands", "n_channels",
                                   "n_scans", "scan_samples",
                                   "vane_samples", "seed")}))
    data = RefL1().read(path)
    lvl2 = RefL2(filename="")
    out = {}
    for name in NAMES:
        stage = getattr(ref_st, name)(**_kwargs(name))
        before = copy.copy(lvl2)
        before._data = dict(lvl2._data)
        before._attrs = {k: dict(v) for k, v in lvl2._attrs.items()}
        assert stage(data, lvl2)
        lvl2.update(stage)
        out[name] = (stage, before)
    data.close()
    return path, out, lvl2


def _port_l1(path):
    return PortL1().read(path)


@pytest.mark.parametrize("name", NAMES)
def test_stage_matches_reference(chain, name):
    path, out, _ = chain
    ref_stage, before = out[name]
    stage = resolve(name, **_kwargs(name))
    assert type(stage) is getattr(port_st, name)
    stage.device = "cpu"
    data = _port_l1(path)
    assert stage(data, level2_from_reference(before)) is True
    got, got_attrs = stage.save_data
    want, want_attrs = ref_stage.save_data
    assert sorted(got) == sorted(want)
    assert got_attrs == want_attrs
    if name == "AtmosphereRemoval":
        el = data.el
        for d in (got, want):
            d["atmosphere/fit_values"] = atmosphere_model(
                d["atmosphere/fit_values"], el, data.scan_edges)
    if name in ("Level2FitPowerSpectrum", "NoiseStatistics"):
        for d in (got, want):       # the fits' scan lengths
            d["averaged_tod/scan_edges"] = before["averaged_tod/scan_edges"]
    check_level2(got, want, name)
    data.close()


def test_whole_chain_level2_matches_reference(chain):
    """The port's stages chained on their own outputs (not the
    reference's) give the reference's Level-2 store."""
    path, _, ref_l2 = chain
    data = _port_l1(path)
    from comapreduce_tpu_torch.data.level import COMAPLevel2

    lvl2 = COMAPLevel2(filename="")
    for name in NAMES:
        stage = resolve(name, **_kwargs(name))
        stage.device = "cpu"
        assert stage(data, lvl2)
        lvl2.update(stage)
    data.close()
    check_level2(lvl2, ref_l2, "whole chain")


def test_level1_averaging_matches_reference(chain):
    path, out, _ = chain
    _, before = out["Level1AveragingGainCorrection"]   # vane is in
    ref_stage = ref_st.Level1Averaging(frequency_bin_size=8)
    data = RefL1().read(path)
    assert ref_stage(data, before)
    data.close()
    stage = port_st.Level1Averaging(frequency_bin_size=8, device="cpu")
    assert stage(_port_l1(path), level2_from_reference(before))
    got, want = stage.save_data[0], ref_stage.save_data[0]
    assert got["frequency_binned/tod"].shape == (2, 2, 4, 2700)
    check_level2(got, want, "Level1Averaging")


@pytest.mark.parametrize("name", ["AtmosphereRemoval",
                                  "Level1AveragingGainCorrection"])
def test_stage_under_a_campaign_bucket_matches_reference(chain, name):
    """T, S and L padded to a campaign bucket (NaN time tail, zero-length
    scans, the filter reflecting at the unpadded length)."""
    path, out, _ = chain
    _, before = out[name]
    buckets = {"t_quantum": 4096, "scan_quantum": 4, "l_quantum": 1024}
    kw = _kwargs(name)
    ref_stage = getattr(ref_st, name)(shape_buckets=buckets, **kw)
    data = RefL1().read(path)
    assert ref_stage(data, before)
    el, edges = data.el, data.scan_edges
    data.close()
    stage = getattr(port_st, name)(shape_buckets=buckets, device="cpu", **kw)
    assert stage(_port_l1(path), level2_from_reference(before))
    got, want = stage.save_data[0], ref_stage.save_data[0]
    if name == "AtmosphereRemoval":
        for d in (got, want):
            d["atmosphere/fit_values"] = atmosphere_model(
                d["atmosphere/fit_values"], el, edges)
    check_level2(got, want, f"{name} bucketed")


def test_reduce_feeds_matches_sharded_reference(chain):
    import jax
    import jax.numpy as jnp

    from comapreduce_tpu.ops.reduce import ReduceConfig
    from comapreduce_tpu.ops.reduce import scan_starts_lengths
    from comapreduce_tpu.parallel.mesh import feed_time_mesh
    from comapreduce_tpu.parallel.sharded import reduce_feeds_sharded
    from comapreduce_tpu_torch.ops.reduce import reduce_feeds

    path, out, _ = chain
    _, before = out["Level1AveragingGainCorrection"]
    data = RefL1().read(path)
    raw = np.stack([data.read_tod_feed(i).astype(np.float32)
                    for i in range(2)])
    raw[0, 1, 3, 400:410] = np.nan                # dropped samples
    am = np.asarray(data.airmass, np.float32)
    starts, lengths, L = scan_starts_lengths(data.scan_edges)
    freq = data.frequency.astype(np.float32)
    f0 = freq.mean(axis=1, keepdims=True)
    fs = ((freq - f0) / f0).astype(np.float32)
    tsys, gain = ref_st.mean_vane_tsys_gain(before)
    tsys, gain = tsys.astype(np.float32), gain.astype(np.float32)
    data.close()
    cfg = ReduceConfig(32, medfilt_window=301, scan_batch=2)
    mesh = feed_time_mesh(jax.local_devices()[:1], n_feed=1)
    want = reduce_feeds_sharded(mesh, jnp.asarray(raw), None, am,
                                starts.astype(np.int32),
                                lengths.astype(np.int32), tsys, gain, fs,
                                cfg, L=L, fold_len=L - 37)
    got = reduce_feeds(torch.as_tensor(raw), torch.as_tensor(am), starts,
                       lengths, torch.as_tensor(tsys),
                       torch.as_tensor(gain), torch.as_tensor(fs),
                       reduce_config_from_reference(cfg), L=L,
                       fold_len=L - 37)
    check_level2({f"averaged_tod/{k}": got[k].numpy()
                  for k in ("tod", "weights", "dg")},
                 {f"averaged_tod/{k}": np.asarray(want[k])
                  for k in ("tod", "weights", "dg")}, "reduce_feeds")


@pytest.mark.parametrize("quantum,cap", [(1, 0), (128, 0), (128, 2),
                                         (500, 16), (64, 3)])
def test_bucket_scan_lengths_match_reference(quantum, cap):
    rng = np.random.default_rng(quantum + cap)
    starts = np.cumsum(rng.integers(20, 60, 12))
    edges = np.stack([starts, starts + rng.integers(5, 900, 12)], axis=1)
    want = ref_st.bucket_scan_lengths(edges, quantum, cap)
    got = port_st.bucket_scan_lengths(edges, quantum, cap)
    assert got == want
    if want:
        assert port_st.first_fitted_scan(got, edges) == \
            ref_st.first_fitted_scan(want, edges)


def test_mean_vane_tsys_gain_matches_reference(chain):
    _, out, _ = chain
    _, before = out["AtmosphereRemoval"]
    for g, w in zip(port_st.mean_vane_tsys_gain(level2_from_reference(
            before)), ref_st.mean_vane_tsys_gain(before)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw,comment", [
    ({"min_duration_seconds": 1e6}, "synthetic observation"),
    ({"min_duration_seconds": 1.0}, "a sky dip at dawn"),
    ({"min_duration_seconds": 1.0}, "the latest field obs")])
def test_check_level1_file_gate_matches_reference(chain, kw, comment):
    path = chain[0]
    port, ref = _port_l1(path), RefL1().read(path)
    for d in (port, ref):
        d.set_attrs("comap", "comment", comment)
    assert port_st.CheckLevel1File(**kw)(port, None) == \
        ref_st.CheckLevel1File(**kw)(ref, None)
    ref.close()


def test_stages_without_their_inputs_return_falsy_state(chain):
    path = chain[0]
    from comapreduce_tpu_torch.data.level import COMAPLevel2

    data = _port_l1(path)
    empty = COMAPLevel2(filename="")
    for cls in (port_st.Level1AveragingGainCorrection,
                port_st.Level1Averaging):
        assert cls(device="cpu")(data, empty) is False
    data["spectrometer/features"] = np.zeros_like(
        data["spectrometer/features"])          # no vane, no scans
    assert port_st.MeasureSystemTemperature(device="cpu")(data, empty) \
        is False


@pytest.mark.parametrize("name,kw", [
    ("MeasureSystemTemperature", {"figure_dir": "figs"}),
    ("Level1AveragingGainCorrection", {"figure_dir": "figs"}),
    ("Level1AveragingGainCorrection", {"normalised_mask_db": "db.sqlite"}),
    ("Level1Averaging", {"normalised_mask_db": "db.sqlite"}),
    ("Level2FitPowerSpectrum", {"figure_dir": "figs"}),
    ("Spikes", {"backend": "numpy"}),
])
def test_unported_stage_options_raise(name, kw):
    with pytest.raises(NotImplementedError) as err:
        resolve(name, **kw)
    key, value = next(iter(kw.items()))
    assert (value if key == "backend" else key) in str(err.value)


def test_stage_on_the_default_device_needs_a_card(chain):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    stage = port_st.Spikes()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stage(_port_l1(chain[0]), None)
