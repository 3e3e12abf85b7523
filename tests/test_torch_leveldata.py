"""The port's Level-2 reader (``comapreduce_tpu_torch/mapmaking/
leveldata.py``) against the reference's, on the CPU, on the same HDF5
files (``torch_level2_data.level2_store``: a planted source, per-feed
drifts and white noise, plus the case's optional products):

- ``read_comap_data`` (``device="cpu"``, so the 400-sample high-pass runs
  K2's plain version) against the reference's: every field of
  ``DestriperData`` bitwise — the vectors, ``n_groups``, ``npix``,
  ``files``, ``groups``, ``sky_pixels`` and the pixel space's dictionary —
  over the four TOD variants, a calibrator file (no high-pass), spike
  masks and calibration factors with one bad feed, ``feed_mask``,
  ``mask_turnarounds``, ``galactic``, ``sun_centric``, HEALPix with
  ``compact`` auto / true / false and a ``pixel_space`` override, a NaN
  burst, a band out of range, unreadable files and the filelist order;
- ``scan_speed_mask``, ``sun_centric_coords`` (several MJDs) and
  ``export_madam`` (the written datasets equal), bitwise;
- the knobs the port refuses raise ``NotImplementedError`` naming
  themselves, the reference's ``ValueError`` rules hold, and the default
  device needs a card.
"""

import os

import h5py
import numpy as np
import pytest
import torch

from comapreduce_tpu.mapmaking import leveldata as ref_ld
from comapreduce_tpu.mapmaking.pixel_space import PixelSpace as RefSpace
from comapreduce_tpu.mapmaking.wcs import WCS as RefWCS
from comapreduce_tpu_torch.mapmaking import leveldata as port_ld
from comapreduce_tpu_torch.mapmaking.pixel_space import PixelSpace
from comapreduce_tpu_torch.mapmaking.wcs import WCS
from torch_level2_data import level2_store

FIELD = ((170.0, 52.0), (1.0 / 30, 1.0 / 30), (240, 240))
GAL_FIELD = ((153.4, 59.5), (1.0 / 30, 1.0 / 30), (240, 240))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the whole module: its many small ops gain
    nothing from more on the CPU, and the suite's parallel workers
    oversubscribe the cores (the old count is restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Level-2 files: ``a`` spikes + calibration factors, ``b``
    frequency-binned products + a NaN burst, ``cal`` a calibrator (TauA),
    ``three`` three bands, ``garbage`` not HDF5."""
    tmp = tmp_path_factory.mktemp("leveldata")
    specs = {"a": dict(seed=1, spikes=True, calibration=True),
             "b": dict(seed=2, frequency_binned=True, nan_burst=True),
             "cal": dict(seed=3, source="TauA"),
             "three": dict(seed=4, n_bands=3, n_feeds=2)}
    out = {}
    for name, kw in specs.items():
        path = str(tmp / f"Level2_{name}.hd5")
        level2_store(**kw).write(path)
        out[name] = path
    out["garbage"] = str(tmp / "Level2_garbage.hd5")
    with open(out["garbage"], "wb") as fh:
        fh.write(b"not an HDF5 file" * 64)
    out["missing"] = str(tmp / "Level2_missing.hd5")
    return out


def _bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def assert_same_data(got, want):
    """Every field of two ``DestriperData``, bitwise."""
    for name in ("tod", "pixels", "weights", "ground_ids", "az"):
        assert _bits(getattr(got, name), getattr(want, name)), name
    assert got.n_groups == want.n_groups
    assert got.npix == want.npix
    assert got.nside == want.nside
    assert got.files == want.files
    assert got.groups == want.groups
    if want.sky_pixels is None:
        assert got.sky_pixels is None
    else:
        assert _bits(got.sky_pixels, want.sky_pixels)
    assert got.pixel_space.compacted == want.pixel_space.compacted
    assert got.pixel_space.npix_sky == want.pixel_space.npix_sky
    assert (got.wcs is None) == (want.wcs is None)


def _read_both(paths, geometry, **kw):
    if geometry == "healpix":
        geo_port = geo_ref = {"nside": 256}
    else:
        field = GAL_FIELD if geometry == "galactic" else FIELD
        geo_port = {"wcs": WCS.from_field(*field)}
        geo_ref = {"wcs": RefWCS.from_field(*field)}
    got = port_ld.read_comap_data(paths, device="cpu", **geo_port, **kw)
    want = ref_ld.read_comap_data(paths, **geo_ref, **kw)
    return got, want


# (files, geometry, keyword arguments)
CASES = {
    "auto": (("a", "b"), "wcs", {}),
    "gain_filtered": (("a", "b"), "wcs", {"tod_variant": "gain_filtered"}),
    "original": (("a", "b"), "wcs", {"tod_variant": "original"}),
    "frequency_binned": (("b",), "wcs",
                         {"tod_variant": "frequency_binned"}),
    "frequency_binned_missing": (("a", "b"), "wcs",
                                 {"tod_variant": "frequency_binned"}),
    "calibrator": (("cal", "a"), "wcs", {"band": 1}),
    "no_calibration": (("a",), "wcs", {"use_calibration": False}),
    "feed_mask": (("a", "b"), "wcs",
                  {"feed_mask": np.array([True, False, True])}),
    "mask_turnarounds": (("a", "b"), "wcs", {"mask_turnarounds": True}),
    "galactic": (("a",), "galactic", {"galactic": True}),
    "sun_centric": (("a",), "healpix", {"sun_centric": True}),
    "healpix_auto": (("a", "b"), "healpix", {}),
    "healpix_compact": (("a", "b"), "healpix", {"compact": True}),
    "healpix_dense": (("a", "b"), "healpix", {"compact": "false"}),
    "wcs_compact": (("a",), "wcs", {"compact": "true"}),
    "band_out_of_range": (("three", "a"), "wcs", {"band": 2}),
    "unreadable": (("garbage", "a", "missing"), "wcs", {}),
    "order": (("b", "a"), "wcs", {"band": 1}),
    "medfilt_window": (("a",), "wcs", {"medfilt_window": 101,
                                       "offset_length": 40}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_read_comap_data_matches_reference(files, case):
    names, geometry, kw = CASES[case]
    got, want = _read_both([files[n] for n in names], geometry, **kw)
    assert_same_data(got, want)


def test_pixel_space_override_matches_reference(files):
    from comapreduce_tpu_torch.mapmaking import healpix as hp

    paths = [files["a"]]
    seen = port_ld.read_comap_data(paths, nside=256, device="cpu")
    # a dictionary wider than this filelist's hits, as a campaign's union
    extra = np.arange(1000, 1100, dtype=np.int64)
    pix = np.union1d(seen.sky_pixels, extra)
    npix = hp.nside2npix(256)
    got = port_ld.read_comap_data(
        paths, nside=256, device="cpu",
        pixel_space=PixelSpace.from_dictionary(pix, npix))
    want = ref_ld.read_comap_data(
        paths, nside=256, pixel_space=RefSpace.from_dictionary(pix, npix))
    assert_same_data(got, want)
    assert got.npix == pix.size
    with pytest.raises(ValueError):
        port_ld.read_comap_data(paths, nside=128, device="cpu",
                                pixel_space=PixelSpace.from_dictionary(
                                    pix, npix))


def test_nan_burst_is_zero_weighted_before_the_high_pass(files, caplog):
    got, want = _read_both([files["b"]], "wcs")
    assert_same_data(got, want)
    assert np.isfinite(got.tod).all() and np.isfinite(got.weights).all()
    assert any("non-finite sample(s) zero-weighted" in r.getMessage()
               for r in caplog.records if r.name == "comapreduce_tpu_torch")


def test_no_usable_file_raises_as_the_reference(files):
    paths = [files["garbage"], files["missing"]]
    with pytest.raises(RuntimeError, match="no usable data"):
        port_ld.read_comap_data(paths, wcs=WCS.from_field(*FIELD),
                                device="cpu")
    with pytest.raises(RuntimeError, match="no usable data"):
        ref_ld.read_comap_data(paths, wcs=RefWCS.from_field(*FIELD))


def test_scan_speed_mask_matches_reference():
    rng = np.random.default_rng(3)
    t = np.arange(3000) / 50.0
    az = 359.0 + 2.0 * np.abs((t / 8.0) % 2 - 1.0) * 2 - 2   # wraps 0/360
    el = 55.0 + 1e-5 * rng.standard_normal((2, t.size))
    az = np.stack([az % 360.0, (az + 1.0) % 360.0])
    for kw in ({}, {"sample_rate": 25.0}, {"speed_range": (0.2, 0.3)}):
        got = port_ld.scan_speed_mask(az, el, **kw)
        want = ref_ld.scan_speed_mask(az, el, **kw)
        assert _bits(got, want)
        assert 0.2 < got.mean() < 1.0


@pytest.mark.parametrize("mjd0", [51544.5, 59620.0, 59800.25, 60310.9])
def test_sun_centric_coords_match_reference(mjd0):
    rng = np.random.default_rng(int(mjd0))
    ra = rng.uniform(0, 360, (3, 500))
    dec = rng.uniform(-80, 80, (3, 500))
    ra[0, :4] = np.nan
    got = port_ld.sun_centric_coords(ra, dec, mjd0)
    want = ref_ld.sun_centric_coords(ra, dec, mjd0)
    for g, w in zip(got, want):
        assert _bits(g, w)
    assert np.isnan(got[0][0, :4]).all()


def test_export_madam_writes_the_reference_file(files, tmp_path):
    got, want = _read_both([files["a"], files["b"]], "healpix",
                           mask_turnarounds=True)
    assert_same_data(got, want)
    port_path, ref_path = tmp_path / "port.h5", tmp_path / "ref.h5"
    port_ld.export_madam(got, str(port_path))
    ref_ld.export_madam(want, str(ref_path))
    with h5py.File(port_path) as p, h5py.File(ref_path) as r:
        assert sorted(p.keys()) == sorted(r.keys())
        for k in r.keys():
            assert _bits(p[k][...], r[k][...]), k
        assert dict(p.attrs) == dict(r.attrs)
    dense, _ = _read_both([files["a"]], "healpix", compact=False)
    port_ld.export_madam(dense, str(tmp_path / "dense.h5"))
    with pytest.raises(ValueError, match="HEALPix"):
        port_ld.export_madam(
            port_ld.read_comap_data([files["a"]], device="cpu",
                                    wcs=WCS.from_field(*FIELD)),
            str(tmp_path / "wcs.h5"))


@pytest.mark.parametrize("knob,value", [
    ("prefetch", 2), ("cache", object()), ("tod_dtype", "bf16")])
def test_unported_knobs_raise_naming_themselves(files, knob, value):
    """The ingest knobs run in both packages (they were refused before
    the ingest tier was ported): the reader's vectors under ``prefetch``,
    a ``cache`` (two reads, the second served from it) and ``tod_dtype =
    bf16`` (bit-equal narrowing, widened on the host) bitwise equal to
    the reference's under the same knob."""
    from comapreduce_tpu.ingest import BlockCache as RefCache
    from comapreduce_tpu_torch.ingest import BlockCache

    paths = [files["a"], files["b"]]
    reads = 2 if knob == "cache" else 1
    kw_port = {"cache": BlockCache(1 << 24)} if knob == "cache" else \
        {knob: value}
    kw_ref = {"cache": RefCache(1 << 24)} if knob == "cache" else \
        {knob: value}
    for _ in range(reads):
        got = port_ld.read_comap_data(paths, wcs=WCS.from_field(*FIELD),
                                      device="cpu", **kw_port)
        want = ref_ld.read_comap_data(paths,
                                      wcs=RefWCS.from_field(*FIELD),
                                      **kw_ref)
        assert_same_data(got, want)
        assert got.tod.dtype == np.float32
    if knob == "cache":
        assert kw_port["cache"].stats == kw_ref["cache"].stats
        assert kw_port["cache"].stats["hits"] == len(paths)


@pytest.mark.parametrize("case", ["both_geometries", "no_geometry",
                                  "tod_variant", "compact"])
def test_argument_errors_match_reference(files, case):
    def kwargs(wcs_cls):
        wcs = wcs_cls.from_field(*FIELD)
        return {"both_geometries": {"wcs": wcs, "nside": 64},
                "no_geometry": {},
                "tod_variant": {"wcs": wcs, "tod_variant": "raw"},
                "compact": {"wcs": wcs, "compact": "maybe"}}[case]

    with pytest.raises(ValueError) as want:
        ref_ld.read_comap_data([files["a"]], **kwargs(RefWCS))
    with pytest.raises(ValueError) as got:
        port_ld.read_comap_data([files["a"]], device="cpu", **kwargs(WCS))
    assert str(got.value) == str(want.value)


def test_reader_defaults_to_the_card(files):
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_ld.read_comap_data([files["a"]], wcs=WCS.from_field(*FIELD))
    assert os.path.exists(files["a"])


# read_comap_data(resilience=): (ledger pre-state, [Resilience] knobs)
RESILIENCE_CASES = {
    # a quarantined file is skipped without a read; garbage and missing
    # files are read errors (transient: retried, then quarantined); the
    # NaN burst of b is scrubbed with masked events
    "ledger": (None, {}),
    "readmit": ("a", {"retry_quarantined": True}),
    "skip": ("a", {}),
    # chaos on the Level-2 read: a read error, a first-read flake and a
    # NaN burst poured into a's averaged TOD
    "chaos": (None, {"inject": "read_error@three:1,flaky@cal:1,"
                               "nan_burst@_a:1", "inject_seed": 5}),
}


@pytest.mark.parametrize("case", list(RESILIENCE_CASES))
@pytest.mark.parametrize("variant", ["auto", "frequency_binned"])
def test_read_comap_data_resilience_matches_reference(files, tmp_path, case,
                                                       variant):
    """The same data, kept files and ledger dispositions (by file, feed,
    band, disposition, class, retries and stage; the masked events'
    counts too) as the reference's, each package with its own ledger."""
    from comapreduce_tpu.resilience.config import \
        ResilienceConfig as RefConfig
    from comapreduce_tpu_torch.resilience.config import ResilienceConfig

    pre, knobs = RESILIENCE_CASES[case]
    names = ["a", "b", "cal", "three", "garbage", "missing"]
    if variant == "frequency_binned":
        names = ["b", "a", "garbage"]
    paths = [files[n] for n in names]
    out = {}
    for pkg, cls in (("port", ResilienceConfig), ("ref", RefConfig)):
        d = tmp_path / pkg
        cfg = cls.coerce(dict(quarantine="auto", retry_base_s=0.0,
                              heartbeat_s=0, **knobs))
        if pre:
            led = cfg.make_runtime(str(d)).ledger
            led.record(files[pre], error=OSError("earlier"),
                       failure_class="transient", stage="ingest.read")
        res = cfg.make_runtime(str(d))
        kw = dict(resilience=res, band=0, tod_variant=variant)
        try:
            if pkg == "port":
                data = port_ld.read_comap_data(
                    paths, device="cpu", wcs=WCS.from_field(*FIELD), **kw)
            else:
                data = ref_ld.read_comap_data(
                    paths, wcs=RefWCS.from_field(*FIELD), **kw)
            result = data
        except RuntimeError as exc:     # every file skipped or bad
            result = str(exc)
        events = sorted((os.path.basename(e.unit["file"]), e.unit["feed"],
                         e.unit["band"], e.disposition, e.failure_class,
                         e.retries, e.stage, e.message
                         if e.disposition == "masked" else "")
                        for e in res.ledger.entries)
        out[pkg] = (result, events)
    got, want = out["port"][0], out["ref"][0]
    if isinstance(want, str):
        assert got == want
    else:
        assert_same_data(got, want)
    assert out["port"][1] == out["ref"][1]
    masked = [e for e in out["port"][1] if e[3] == "masked"]
    if variant == "auto" and case != "skip":
        assert masked, "the NaN burst of b must be ledgered"
