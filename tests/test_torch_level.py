"""The port's Level-1 / Level-2 views, scan segmentation and synthetic
generator against the reference's: ``generate_level1_store`` and
``generate_level1_file`` bitwise (default knobs and the fault /
atmosphere extensions), every ``COMAPLevel1`` accessor on the same file
(field and calibrator observations), ``COMAPLevel2``'s resume contract
and ``tod_auto_rms``, ``decode_features``, ``find_level1_by_obsid``, the
scan-edge helpers, the converters that carry a reference store across
bitwise, and the loaders with the serial Level-1 stream.
"""

import numpy as np
import pytest

from comapreduce_tpu.data import level as ref_level
from comapreduce_tpu.data import scan_edges as ref_se
from comapreduce_tpu.data import synthetic as ref_syn
from comapreduce_tpu_torch.convert import (level1_from_reference,
                                           level2_from_reference)
from comapreduce_tpu_torch.data import level as port_level
from comapreduce_tpu_torch.data import scan_edges as port_se
from comapreduce_tpu_torch.data import synthetic as port_syn

SMALL = dict(n_feeds=2, n_bands=2, n_channels=8, n_scans=3,
             scan_samples=300, vane_samples=120, gap_samples=40, seed=11)
EXTRAS = dict(SMALL, t_atm_sigma=0.05, spike_rate=1e-4, nan_rate=1e-4,
              source_amplitude_k=0.5, el_sweep=2.0)


def _bitwise(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("knobs", [SMALL, EXTRAS], ids=["base", "extras"])
def test_generate_level1_store_is_bitwise(knobs):
    pp, ps = port_syn.generate_level1_store(port_syn.SyntheticObsParams(
        **knobs))
    rp, rs = ref_syn.generate_level1_store(ref_syn.SyntheticObsParams(
        **knobs))
    assert sorted(ps.keys()) == sorted(rs.keys())
    for k in rs.keys():
        _bitwise(ps[k], rs[k], k)
    assert {p: dict(v) for p, v in ps.attr_items()} == \
        {p: dict(v) for p, v in rs.attr_items()}
    assert pp.n_samples == rp.n_samples
    for k, v in rp.truth.items():
        if isinstance(v, np.ndarray):
            _bitwise(pp.truth[k], v, k)
        else:
            assert pp.truth[k] == v, k


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("level")
    out = {}
    for name, knobs in (("field", SMALL),
                        ("cal", dict(SMALL, source="TauA", obsid=42))):
        port_path = str(tmp / f"comap-{knobs.get('obsid', 1000001):07d}"
                        f"-{name}-port.hd5")
        ref_path = str(tmp / f"{name}-ref.hd5")
        port_syn.generate_level1_file(port_path, port_syn.SyntheticObsParams(
            **knobs))
        ref_syn.generate_level1_file(ref_path, ref_syn.SyntheticObsParams(
            **knobs))
        out[name] = (port_path, ref_path)
    return str(tmp), out


@pytest.mark.parametrize("kind", ["field", "cal"])
def test_level1_files_agree_across_packages(files, kind):
    port_path, ref_path = files[1][kind]
    # each package reads the other's file
    port = port_level.COMAPLevel1().read(ref_path)
    ref = ref_level.COMAPLevel1().read(port_path)
    for k in ref.keys():
        _bitwise(port[k][...], ref[k][...], k)
    for prop in ("obsid", "comment", "source_name", "is_calibrator",
                 "tod_shape", "vane_temperature"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    for prop in ("features", "vane_flag", "on_source", "mjd", "feeds",
                 "airmass", "frequency", "scan_edges"):
        _bitwise(getattr(port, prop), getattr(ref, prop), prop)
    _bitwise(port.read_tod_feed(1), ref.read_tod_feed(1), "feed 1")
    port.close()
    ref.close()


def test_level2_contract_matches_reference(tmp_path):
    rng = np.random.default_rng(3)

    class Stage:
        groups = ("averaged_tod",)
        save_data = ({"averaged_tod/tod": rng.normal(size=(2, 2, 40)).astype(
            np.float32), "averaged_tod/scan_edges": np.array([[2, 30]]),
            "averaged_tod/none": None},
            {"averaged_tod": {"unit": "K"}})

    out = {}
    for name, mod in (("port", port_level), ("ref", ref_level)):
        path = str(tmp_path / f"{name}.hd5")
        lvl2 = mod.COMAPLevel2(filename=path)
        assert not lvl2.contains(Stage())
        lvl2.update(Stage())
        assert lvl2.contains(Stage()) and "averaged_tod/none" not in lvl2
        lvl2.write(path, atomic=True)
        out[name] = mod.COMAPLevel2(filename=path)   # reads it back
    p, r = out["port"], out["ref"]
    assert p.contains(Stage()) and p.tod_shape == r.tod_shape == (2, 2, 40)
    assert p.nbands == r.nbands
    _bitwise(p.scan_edges, r.scan_edges)
    assert p.tod_auto_rms(1, 0) == r.tod_auto_rms(1, 0)
    assert p.attrs("averaged_tod", "unit") == "K"


def test_converters_carry_reference_stores_bitwise(files):
    _, ref_path = files[1]["field"]
    ref = ref_level.COMAPLevel1().read(ref_path)      # lazy TOD handle
    port = level1_from_reference(ref)
    assert isinstance(port, port_level.COMAPLevel1)
    for k in ref.keys():
        _bitwise(port[k], ref[k][...], k)
    assert port.obsid == ref.obsid and port.source_filename == \
        ref.source_filename
    _bitwise(port.scan_edges, ref.scan_edges)
    ref.close()
    lvl2 = ref_level.COMAPLevel2(filename="")
    lvl2["vane/system_gain"] = np.ones((1, 2, 2, 8), np.float32)
    lvl2.set_attrs("comap", "obsid", 9)
    lvl2.filename = "x.hd5"
    back = level2_from_reference(lvl2)
    assert back.filename == "x.hd5" and back.obsid == 9
    _bitwise(back["vane/system_gain"], lvl2["vane/system_gain"])


def test_decode_features_and_find_by_obsid(files):
    rng = np.random.default_rng(5)
    feats = np.where(rng.random(200) < 0.2, 0, 2 ** rng.integers(0, 16, 200))
    _bitwise(port_level.decode_features(feats),
             ref_level.decode_features(feats))
    tmp = files[0]
    for obsid in (1000001, 42, 7, 100):
        assert port_level.find_level1_by_obsid(tmp, obsid) == \
            ref_level.find_level1_by_obsid(tmp, obsid)


def test_scan_edge_helpers_match_reference():
    rng = np.random.default_rng(9)
    status = (rng.random(500) < 0.6).astype(np.int64)
    status[100:180] = 1
    _bitwise(port_se.edges_from_status(status),
             ref_se.edges_from_status(status))
    utc = np.sort(rng.random(80))
    mjd = np.linspace(-0.1, 1.1, 500)
    feats = np.where(np.arange(500) % 50 < 30, 9, 13)
    for st in (status[:80], np.zeros(80, np.int64)):
        _bitwise(port_se.scan_edges_source(st, utc, mjd, feats),
                 ref_se.scan_edges_source(st, utc, mjd, feats))
    on = rng.random(300) < 0.1
    _bitwise(port_se.scan_edges_calibrator(on),
             ref_se.scan_edges_calibrator(on))
    edges = port_se.edges_from_status(status)
    _bitwise(port_se.segment_ids_from_edges(edges, 500),
             ref_se.segment_ids_from_edges(edges, 500))


def test_loaders_match_reference(files, tmp_path):
    from comapreduce_tpu.ingest import loaders as ref_ld
    from comapreduce_tpu_torch.ingest import loaders as port_ld

    _, ref_path = files[1]["field"]
    got = port_ld.load_level1(ref_path)
    want = ref_ld.load_level1(ref_path)
    assert sorted(got["data"]) == sorted(want["data"])
    for k in want["data"]:
        _bitwise(got["data"][k], want["data"][k], k)
    lazy = port_ld.load_level1(ref_path, eager_tod=False)
    assert isinstance(lazy, port_level.COMAPLevel1)
    assert not isinstance(lazy["spectrometer/tod"], np.ndarray)
    lazy.close()
    l2 = str(tmp_path / "l2.hd5")
    store = ref_level.COMAPLevel2(filename="")
    store["averaged_tod/tod"] = np.ones((1, 2, 5), np.float32)
    store.set_attrs("comap", "obsid", 5)
    store.write(l2, atomic=True)
    got, want = port_ld.load_level2(l2), ref_ld.load_level2(l2)
    _bitwise(got["data"]["averaged_tod/tod"],
             want["data"]["averaged_tod/tod"])
    assert got["attrs"]["comap"]["obsid"] == 5
    with pytest.raises(NotImplementedError, match="synth"):
        port_ld.load_level1("synth://scenario/0")
    with pytest.raises(NotImplementedError, match="prefetch"):
        next(port_ld.level1_stream([ref_path], prefetch=2))
    items = list(port_ld.level1_stream([ref_path, str(tmp_path / "no.hd5")]))
    assert items[0].error is None and items[1].error is not None
    assert items[0].payload.obsid == 1000001
    items[0].payload.close()
