"""The port's map-maker entry point ``run_destriper.main`` against the
reference's on its routes and run options, on the CPU (the second half
of ``tests/test_torch_run_destriper_cli.py``, whose files, helpers and
tolerances it shares; split so each file's tests stay on one worker's
share of the suite's time).

- The end-to-end case: Level-1 files (``tests/test_cli.py``'s
  ``field_dataset`` geometry, a 5 K source) through the port's
  ``run_average`` and ``run_destriper.main`` and the reference's, each
  package on its own Level-2 files; the destriped maps held to
  ``TOD_RTOL`` of scale and the weight maps to ``NAIVE_ATOL`` of their
  maximum (the two chains' Level-2 TOD differ by up to 1.2e-4 of scale,
  the gain solve's conditioning), naive maps and hits as the first half
  holds them.
- ``main`` on the shipped ``parameters.ini`` as shipped (ledger,
  retries, heartbeats, elastic leases) on four-band stores, ``[Slo]
  exclude_flagged``, ``--retry-quarantined``, the banded route over
  ledgers of 1/f fits (subnormal and huge priors included) and over
  ``run_average``'s ledger, and the ingest knobs.
"""

import os

import numpy as np
import pytest
import torch

import comapreduce_tpu.cli.run_destriper as ref_rd
from chip_smoke import TOD_RTOL, shipped_chain_config
import comapreduce_tpu_torch.cli.run_destriper as port_rd
from comapreduce_tpu_torch.mapmaking.filelist import write_filelist
from test_torch_run_destriper_cli import (  # noqa: F401 (a fixture)
    _assert_maps_match, _read_maps, _write_ini, l2files)
from torch_level2_data import level2_store


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the whole module: its many small ops gain
    nothing from more on the CPU, and the suite's parallel workers
    oversubscribe the cores (the old count is restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _average_config(path, filelist, out):
    """``tests/test_cli.py``'s reduction chain with the shipped
    ``[resilience]`` table (and the reference's default ``[quality]``),
    as TOML."""
    res = shipped_chain_config()["resilience"]
    with open(path, "w") as fh:
        fh.write(f'''[Global]
processes = ["CheckLevel1File", "AssignLevel1Data",
             "MeasureSystemTemperature", "Level1AveragingGainCorrection",
             "Spikes", "Level2FitPowerSpectrum"]
filelist = "{filelist}"
output_dir = "{out}/level2"
log_dir = "{out}/logs"

[CheckLevel1File]
min_duration_seconds = 1.0

[Level1AveragingGainCorrection]
medfilt_window = 501

[Spikes]
window = 101
pad = 10

[Level2FitPowerSpectrum]
nbins = 12

[resilience]
quarantine = "{res["quarantine"]}"
max_retries = {res["max_retries"]}
retry_base_s = {res["retry_base_s"]}
''')
    return str(path)


def test_level1_to_maps_end_to_end(tmp_path):
    """Level-1 -> ``run_average`` -> ``run_destriper.main`` in each
    package, on the CPU; the source lands at the field centre."""
    from comapreduce_tpu.cli import run_average as ref_ra
    from comapreduce_tpu.data.synthetic import (SyntheticObsParams,
                                                generate_level1_file)
    from comapreduce_tpu_torch.cli import run_average as port_ra

    files = []
    for i in range(2):
        path = str(tmp_path / f"comap-{2_000_000 + i}.hd5")
        generate_level1_file(path, SyntheticObsParams(
            obsid=2_000_000 + i, source="co2", n_feeds=2, n_bands=2,
            n_channels=32, n_scans=4, scan_samples=1200, vane_samples=250,
            seed=100 + i, source_amplitude_k=5.0, source_fwhm_deg=0.15,
            az_throw=2.0, fknee=1.0))
        files.append(path)
    l1list = str(tmp_path / "l1.txt")
    write_filelist(l1list, files)
    for pkg, ra, rd in (("port", port_ra, port_rd), ("ref", ref_ra, ref_rd)):
        out = tmp_path / pkg
        cpu = ["--device=cpu"] if pkg == "port" else []
        assert ra.main([_average_config(tmp_path / f"{pkg}.toml", l1list,
                                        out)] + cpu) == 0
        l2list = str(tmp_path / f"{pkg}_l2.txt")
        write_filelist(l2list, [
            str(out / "level2" / f"Level2_{os.path.basename(f)}")
            for f in files])
        ini = _write_ini(
            tmp_path / f"{pkg}.ini", l2list, str(out / "maps"),
            "niter : 80\nground : false",
            pixel="type : wcs\ncrval : 170.0, 52.0\n"
                  "cdelt : 0.0333333, 0.0333333\nshape : 240, 240")
        assert rd.main([ini] + cpu) == 0
    for band in (0, 1):
        name = f"co2_band{band}.fits"
        got = _read_maps(str(tmp_path / "port" / "maps" / name))
        want = _read_maps(str(tmp_path / "ref" / "maps" / name))
        _assert_maps_match(got, want, destriped_atol=TOD_RTOL,
                           weights_of_max=True)
        hits, m = got["HITS"], got["DESTRIPED"]
        assert hits.shape == (240, 240) and hits[110:130, 110:130].sum() > 0
        iy, ix = np.unravel_index(
            np.nanargmax(np.where(hits > 0, m, -np.inf)), m.shape)
        assert abs(iy - 120) < 8 and abs(ix - 120) < 8, (iy, ix)


@pytest.fixture(scope="module")
def l2files4(tmp_path_factory):
    """Two raster observations of four bands (the shipped INI maps bands
    0-3), the second turned by 90 degrees."""
    tmp = tmp_path_factory.mktemp("destriper_cli4")
    paths = []
    for seed, turn in ((31, 0.0), (32, 90.0)):
        path = str(tmp / f"Level2_{seed}.hd5")
        level2_store(seed, n_bands=4, raster=True,
                     rotate_deg=turn).write(path)
        paths.append(path)
    filelist = str(tmp / "l2list.txt")
    write_filelist(filelist, paths)
    return tmp, paths, filelist


def _shipped(tmp_path, pkg, filelist, sections=None, **inputs):
    """The shipped INI with only its paths set (and ``sections`` merged
    in); the state directory is ``<pkg>/logs``."""
    from chip_smoke import shipped_destriper_ini

    out = tmp_path / pkg
    return shipped_destriper_ini(filelist, str(out / "maps"),
                                 str(tmp_path / f"{pkg}.ini"),
                                 log_dir=str(out / "logs"),
                                 sections=sections, **inputs)


def _run_main(pkg, ini, *flags):
    if pkg == "port":
        return port_rd.main([ini, "--device=cpu", *flags])
    return ref_rd.main([ini, *flags])


def _ledger_events(path):
    from comapreduce_tpu_torch.resilience.ledger import QuarantineLedger

    return sorted((os.path.basename(e.unit["file"]), e.disposition,
                   e.failure_class, e.stage)
                  for e in QuarantineLedger(path).entries)


def test_main_on_the_shipped_ini_as_shipped(l2files4, tmp_path, capsys):
    """``examples/configs/parameters.ini`` with its ``[Resilience]`` as
    shipped (the quarantine ledger, retries, heartbeats and elastic lease
    claiming): the maps match the reference's, the ledger stays empty,
    the heartbeat ends ``run_destriper.done`` and every file's lease
    under ``<log_dir>/destriper`` is committed, in both packages."""
    from comapreduce_tpu_torch.resilience.heartbeat import read_heartbeats
    from comapreduce_tpu_torch.resilience.lease import LeaseBoard

    _, paths, filelist = l2files4
    for pkg in ("port", "ref"):
        assert _run_main(pkg, _shipped(tmp_path, pkg, filelist)) == 0
    out = capsys.readouterr().out
    assert out.count(" CG iters, residual ") == 8
    for band in range(4):
        name = f"field_band{band}.fits"
        _assert_maps_match(_read_maps(str(tmp_path / "port" / "maps" /
                                          name)),
                           _read_maps(str(tmp_path / "ref" / "maps" /
                                          name)))
    for pkg in ("port", "ref"):
        logs = tmp_path / pkg / "logs"
        assert read_heartbeats(str(logs))[0]["stage"] == \
            "run_destriper.done"
        board = LeaseBoard(str(logs / "destriper"))
        assert all(board.is_done(p) for p in paths)
        assert not os.path.exists(tmp_path / pkg / "maps" /
                                  "quarantine.jsonl")


def _flag(state_dir, flagged: set, files, q):
    """A quality ledger in ``state_dir`` (as run_average writes it): one
    record per (file, feed, band), ``flagged`` files' flagged."""
    recs = []
    for f in files:
        base = os.path.basename(f)
        for feed in range(3):
            for band in range(2):
                flags = ["tsys_high"] if base in flagged else []
                recs.append({"schema": 1, "file": base, "feed": feed,
                             "band": band, "t": "2026-01-01T00:00:00Z",
                             "flags": flags, "flagged": bool(flags)})
    q.append_quality(q.quality_path(str(state_dir), 0), recs)


@pytest.mark.parametrize("exclude", [True, False])
def test_slo_exclude_flagged_drops_the_same_files(l2files, tmp_path,
                                                  capsys, exclude):
    from comapreduce_tpu_torch.telemetry import quality as q

    _, paths, filelist = l2files
    for pkg in ("port", "ref"):
        logs = tmp_path / pkg / "logs"
        _flag(logs, {os.path.basename(paths[1])}, paths, q)
        ini = _write_ini(tmp_path / f"{pkg}.ini", filelist,
                         str(tmp_path / pkg), f"log_dir : {logs}",
                         f"[Slo]\nexclude_flagged : {exclude}\n")
        assert _run_main(pkg, ini) == 0
    out = capsys.readouterr().out
    n = 1 if exclude else 2
    assert out.count(f": {n} files, ") == 4
    for band in (0, 1):
        name = f"co2_band{band}.fits"
        _assert_maps_match(_read_maps(str(tmp_path / "port" / name)),
                           _read_maps(str(tmp_path / "ref" / name)))


@pytest.fixture(scope="module")
def l2files_1f(tmp_path_factory):
    """Two raster observations whose TOD is 1/f noise of planted knees
    (``torch_level2_data.ONE_OVER_F``), and the quality ledger the
    reduction would write for them, the fits by the port's stages."""
    from comapreduce_tpu_torch.pipeline import stages
    from comapreduce_tpu_torch.telemetry import quality as q
    from torch_level2_data import with_noise_fits

    tmp = tmp_path_factory.mktemp("destriper_1f")
    paths, records = [], []
    for seed, turn in ((41, 0.0), (42, 90.0)):
        path = str(tmp / f"Level2_{seed}.hd5")
        store = level2_store(seed, raster=True, rotate_deg=turn,
                             noise="1/f")
        store.write(path)
        paths.append(path)
        recs = q.assemble_quality_records(with_noise_fits(store, stages),
                                          path)
        for r in recs:
            r["flags"] = q.evaluate_record(r, q.SloConfig())
            r["flagged"] = bool(r["flags"])
        records += recs
    filelist = str(tmp / "l2list.txt")
    write_filelist(filelist, paths)
    return tmp, paths, filelist, records


@pytest.mark.parametrize("route", ["joint", "per_band"])
def test_banded_route_matches_reference_on_1f_data(l2files_1f, tmp_path,
                                                   caplog, route):
    """``[Destriper] noise_weight = banded`` over a quality ledger in the
    state directory: every group is weighted from its measured fit (none
    falls back), and the maps match the reference's within the joint
    route's tolerances (measured on the CPU: 1.5e-8 of scale)."""
    from comapreduce_tpu_torch.telemetry import quality as q

    _, paths, filelist, records = l2files_1f
    for pkg in ("port", "ref"):
        logs = tmp_path / pkg / "logs"
        q.append_quality(q.quality_path(str(logs), 0), records)
        ini = _write_ini(tmp_path / f"{pkg}.ini", filelist,
                         str(tmp_path / pkg),
                         f"log_dir : {logs}" + ("\njoint : false"
                                                if route == "per_band"
                                                else ""),
                         "[Destriper]\nnoise_weight : banded\n")
        with caplog.at_level("INFO"):
            assert _run_main(pkg, ini) == 0
    banded = [r.getMessage() for r in caplog.records
              if "group(s) weighted from measured fits" in r.getMessage()]
    # two bands, in each package
    assert len(banded) == 4 and all(" 6/6 " in m for m in banded), banded
    assert not [r for r in caplog.records if "kept white" in
                r.getMessage()]
    for band in (0, 1):
        name = f"co2_band{band}.fits"
        _assert_maps_match(_read_maps(str(tmp_path / "port" / name)),
                           _read_maps(str(tmp_path / "ref" / name)))


# a degenerate knee fit of white TOD (a full-width synthetic store's feed
# 1, bands 0 and 1): the knee far above the band, the slope steep
DEGENERATE_FITS = {0: (0.05787159118493273, 73.20665934276477,
                       -6.161368960887193),
                   1: (0.0577240841305514, 76102.41432821516,
                       -8.922548465430737)}


def test_banded_route_with_a_subnormal_prior_matches_reference(
        l2files, tmp_path, caplog):
    """Feed 0's band-1 fit makes a prior diagonal of 1.7e-45, an f32
    subnormal, which the reference's arithmetic reads as zero. Kept, it
    made the port's Jacobi inverse infinite on zero-weight offsets and
    the preconditioned residual NaN: band 1's CG stopped at its start
    (residual 1.0) and its map differed by 8.6% of scale, while the
    reference's converged. Both converge, the maps within the joint
    route's tolerances."""
    from comapreduce_tpu_torch.telemetry import quality as q

    _, paths, filelist = l2files
    recs = [{"schema": 1, "file": os.path.basename(p), "feed": 0,
             "band": band, "t": "2026-01-01T00:00:00Z",
             "white_sigma": sig, "fknee_hz": fk, "alpha": al,
             "flags": [], "flagged": False}
            for p in paths for band, (sig, fk, al) in DEGENERATE_FITS.items()]
    for pkg in ("port", "ref"):
        logs = tmp_path / pkg / "logs"
        q.append_quality(q.quality_path(str(logs), 0), recs)
        ini = _write_ini(tmp_path / f"{pkg}.ini", filelist,
                         str(tmp_path / pkg), f"log_dir : {logs}",
                         "[Destriper]\nnoise_weight : banded\n")
        with caplog.at_level("INFO"):
            assert _run_main(pkg, ini) == 0
    assert not [r for r in caplog.records
                if "did NOT reach threshold" in r.getMessage()]
    for band in (0, 1):
        name = f"co2_band{band}.fits"
        _assert_maps_match(_read_maps(str(tmp_path / "port" / name)),
                           _read_maps(str(tmp_path / "ref" / name)))


# degenerate knee fits of white TOD in the shape of the full-width
# Level-2-keyed banded route's (a knee just above the lowest offset-rate
# frequency, a steep slope): priors from 1.3e24 down to 8.5e18 on the
# diagonal, against data weights of 2e4 an offset (400 a sample, 50
# samples an offset)
HUGE_PRIOR_FITS = ((0.05, 0.002, -9.4), (0.05, 0.003, -8.0),
                   (0.05, 0.0025, -7.5))


@pytest.mark.parametrize("route", ["joint", "per_band"])
def test_banded_route_with_huge_priors_stops_like_the_reference(
        l2files, tmp_path, caplog, route):
    """Priors near 1e24 against data weights near 1e4: neither package's
    CG reaches the threshold, and both stop alike (the same iterations
    and residuals, the maps within the joint tolerances: measured 1.9e-9
    of scale joint, bitwise per band). A property of the reference, not a
    port fault."""
    from comapreduce_tpu_torch.mapmaking.noise_weight import \
        _band_coefficients
    from comapreduce_tpu_torch.telemetry import quality as q

    assert _band_coefficients(*HUGE_PRIOR_FITS[0], 1.0, 512, 4,
                              1.0)[0] > 1e24
    _, paths, filelist = l2files
    recs = [{"schema": 1, "file": os.path.basename(p), "feed": f,
             "band": band, "t": "2026-01-01T00:00:00Z",
             "white_sigma": sig, "fknee_hz": fk, "alpha": al,
             "flags": [], "flagged": False}
            for p in paths for f, (sig, fk, al) in enumerate(HUGE_PRIOR_FITS)
            for band in (0, 1)]
    stops = {}
    for pkg in ("port", "ref"):
        logs = tmp_path / pkg / "logs"
        q.append_quality(q.quality_path(str(logs), 0), recs)
        ini = _write_ini(tmp_path / f"{pkg}.ini", filelist,
                         str(tmp_path / pkg), f"log_dir : {logs}" + (
                             "\njoint : false" if route == "per_band"
                             else ""),
                         "[Destriper]\nnoise_weight : banded\n")
        caplog.clear()
        with caplog.at_level("INFO"):
            assert _run_main(pkg, ini) == 0
        stops[pkg] = [m.split(" — ")[0] for m in caplog.messages
                      if "did NOT reach threshold" in m]
        assert sum(" 6/6 group(s) weighted" in m
                   for m in caplog.messages) == 2, pkg
    assert len(stops["ref"]) == 2 and stops["port"] == stops["ref"], stops
    for band in (0, 1):
        name = f"co2_band{band}.fits"
        _assert_maps_match(_read_maps(str(tmp_path / "port" / name)),
                           _read_maps(str(tmp_path / "ref" / name)))


def test_banded_route_over_run_averages_ledger_keeps_white(l2files,
                                                           tmp_path,
                                                           caplog):
    """The quality ledger ``run_average`` writes names each record by its
    Level-1 file; the map-maker's groups carry the Level-2 file's name
    (``Level2_`` + it). So over that ledger every group falls back to
    white (``absent``) in the reference, and the port does the same."""
    from comapreduce_tpu_torch.telemetry import quality as q

    _, paths, filelist = l2files
    level1 = [os.path.basename(p)[len("Level2_"):] for p in paths]
    for pkg in ("port", "ref"):
        logs = tmp_path / pkg / "logs"
        _flag(logs, set(), level1, q)
        ini = _write_ini(tmp_path / f"{pkg}.ini", filelist,
                         str(tmp_path / pkg), f"log_dir : {logs}",
                         "[Destriper]\nnoise_weight : banded\n")
        with caplog.at_level("INFO"):
            assert _run_main(pkg, ini) == 0
    for name in ("comapreduce_tpu_torch", "comapreduce_tpu"):
        logs = [r.getMessage() for r in caplog.records if r.name == name]
        assert len([m for m in logs if "every group fell back to white"
                    in m]) == 2, name
        kept = [m for m in logs if "kept white" in m]
        assert len(kept) == 2 and all(m.count(":absent") == 6
                                      for m in kept), name
    for band in (0, 1):
        name = f"co2_band{band}.fits"
        _assert_maps_match(_read_maps(str(tmp_path / "port" / name)),
                           _read_maps(str(tmp_path / "ref" / name)))


def test_retry_quarantined_readmits_like_the_reference(l2files, tmp_path):
    """A file quarantined by an earlier run is skipped (the other file
    maps alone); ``--retry-quarantined`` re-admits it (a ``readmitted``
    ledger event) and both files map, in both packages alike."""
    from comapreduce_tpu_torch.resilience.ledger import QuarantineLedger

    _, paths, filelist = l2files
    events = {}
    for pkg in ("port", "ref"):
        out = tmp_path / pkg
        QuarantineLedger(str(out / "quarantine.jsonl")).record(
            paths[0], error=OSError("earlier"), failure_class="transient",
            stage="destriper.read")
        for i, flags in enumerate(((), ("--retry-quarantined",))):
            ini = _write_ini(tmp_path / f"{pkg}{i}.ini", filelist,
                             str(out), f"log_dir : {out}/logs{i}",
                             resilience="quarantine : auto\n"
                                        "max_retries : 2")
            assert _run_main(pkg, ini, *flags) == 0
            hits = _read_maps(str(out / "co2_band0.fits"))["HITS"]
            events[(pkg, i)] = (int(hits.sum()), _ledger_events(
                str(out / "quarantine.jsonl")))
    assert events[("port", 0)] == events[("ref", 0)]
    assert events[("port", 1)] == events[("ref", 1)]
    assert events[("port", 1)][0] > events[("port", 0)][0]
    assert ("Level2_11.hd5", "readmitted", "", "readmit") in \
        events[("port", 1)][1]


def test_main_ingest_spill_and_eager_knobs_match_reference(l2files,
                                                          tmp_path, capsys):
    """``[Inputs] prefetch``, ``cache_mb`` under one file's size (every
    entry spills), ``spill_dir``, ``eager_tod`` and ``writeback``
    together: ``main`` in both packages, the port's maps held to the
    reference's as ``test_main_matches_reference`` holds them, and the
    spill written."""
    _, _, filelist = l2files
    for pkg in ("port", "ref"):
        spill = tmp_path / f"spill_{pkg}"
        inputs = (f"prefetch : 2\ncache_mb : 0.001\nspill_dir : {spill}\n"
                  "eager_tod : false\nwriteback : 1")
        ini = _write_ini(tmp_path / f"{pkg}.ini", filelist,
                         str(tmp_path / pkg), inputs)
        assert (port_rd.main([ini, "--device=cpu"]) if pkg == "port"
                else ref_rd.main([ini])) == 0
        assert any(f.endswith(".ingest.pkl") for f in os.listdir(spill))
    assert capsys.readouterr().out.count(" CG iters, residual ") == 4
    for band in (0, 1):
        name = f"co2_band{band}.fits"
        _assert_maps_match(_read_maps(str(tmp_path / "port" / name)),
                           _read_maps(str(tmp_path / "ref" / name)))
