"""The port's map-maker entry points (``comapreduce_tpu_torch/cli/
run_destriper.py``: ``parse_destriper_section``, ``make_band_map``,
``make_band_maps_joint`` and ``main``) against the reference's, on the
CPU, on the same Level-2 HDF5 files.

The files (``torch_level2_data.level2_store`` with ``raster=True``): two
observations of three feeds and two bands, a dense raster over a 12 x 12
field of 0.2-degree pixels, the second turned by 90 degrees, spike masks
set. On this geometry every route converges, the ground template's too:
on the sparse CES pointing of ``tests/test_cli.py`` the ground solve
stalls near a residual of 1e-2 in both packages (measured, CPU), and two
unconverged iterates that far apart differ by several per cent of the map.

Tolerances are ``tests/test_torch_joint.py``'s, the reference's joint
route contract: destriped maps within ``DESTRIPED_ATOL`` of ``max(nanstd,
1)``, naive and weight maps within ``NAIVE_ATOL`` of it, hit maps equal.
Measured here: at most 4e-7 of scale (CPU).

``main`` runs the reference's ``[Resilience]`` runtime (leases off
here, the quarantine ledger off). Its shipped-INI, SLO, retry and banded
routes, the ingest knobs and the end-to-end case from Level-1 files are
in ``tests/test_torch_run_destriper_routes.py``, which shares these
files, helpers and tolerances.
"""

import os

import numpy as np
import pytest
import torch

import comapreduce_tpu.cli.run_destriper as ref_rd
from comapreduce_tpu.mapmaking.wcs import WCS as RefWCS
import comapreduce_tpu_torch.cli.run_destriper as port_rd
from comapreduce_tpu_torch.mapmaking import fits_io
from comapreduce_tpu_torch.mapmaking.filelist import write_filelist
from comapreduce_tpu_torch.mapmaking.wcs import WCS
from torch_level2_data import level2_store

DESTRIPED_ATOL = 5e-4
NAIVE_ATOL = 1e-4
FIELD = ((170.0, 52.0), (0.2, 0.2), (12, 12))


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
def l2files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("destriper_cli")
    paths = []
    for seed, turn in ((11, 0.0), (12, 90.0)):
        path = str(tmp / f"Level2_{seed}.hd5")
        level2_store(seed, spikes=True, raster=True,
                     rotate_deg=turn).write(path)
        paths.append(path)
    filelist = str(tmp / "l2list.txt")
    write_filelist(filelist, paths)
    return tmp, paths, filelist


def _write_ini(path, filelist, out_dir, inputs="", sections="",
               pixel=None, resilience="quarantine : off\nlease_ttl_s : 0"):
    pixel = pixel or ("type : wcs\ncrval : 170.0, 52.0\n"
                      "cdelt : 0.2, 0.2\nshape : 12, 12")
    text = (f"[Inputs]\nfilelist : {filelist}\noutput_dir : {out_dir}\n"
            "prefix : co2\nbands : 0, 1\noffset_length : 50\n"
            f"niter : 300\nthreshold : 1e-6\n{inputs}\n\n"
            f"[Pixelization]\n{pixel}\n\n")
    if resilience is not None:
        text += f"[Resilience]\n{resilience}\n\n"
    with open(path, "w") as fh:
        fh.write(text + sections)
    return str(path)


def _read_maps(path):
    """name -> array of a band's FITS file (WCS image or HEALPix)."""
    hdus = fits_io.read_fits_image(path)
    maps = {name: data for name, _, data in hdus}
    if "PIXELS" in maps:
        maps, pixels, _, _ = fits_io.read_healpix_map(path)
        maps = dict(maps, PIXELS=pixels)
    return maps


def _assert_maps_match(got, want, destriped_atol=DESTRIPED_ATOL,
                       weights_of_max=False):
    assert sorted(got) == sorted(want)
    scale = max(float(np.nanstd(want["DESTRIPED"])), 1.0)
    for name in want:
        if name in ("HITS", "PIXELS"):
            np.testing.assert_array_equal(got[name], want[name], name)
            continue
        if name == "WEIGHTS" and weights_of_max:
            atol = NAIVE_ATOL * float(np.abs(want[name]).max())
        else:
            atol = {"DESTRIPED": destriped_atol}.get(name, NAIVE_ATOL) * \
                scale
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=atol, err_msg=name)
    assert (want["HITS"] > 0).any()


# parse_destriper_section: the same tuple, or the same exception type
PARSE_CASES = [
    ({}, 0), ({}, 8), ({"preconditioner": "none"}, 8),
    ({"preconditioner": "jacobi"}, 8), ({"preconditioner": "twolevel"}, 0),
    ({"preconditioner": "twolevel", "coarse_block": 16}, 0),
    ({"preconditioner": "multigrid"}, 8),
    ({"preconditioner": "multigrid", "mg_levels": 3, "mg_smooth": 2,
      "mg_block": 4}, 0),
    ({"pair_batch": 4}, 0), ({"pair_batch": "auto"}, 0),
    ({"kernels": "xla"}, 0), ({"kernels": "PALLAS"}, 0),
    ({"noise_weight": "banded"}, 0),
    ({"noise_weight": "banded", "noise_bandwidth": 2}, 0),
    ({"noise_weight": "white"}, 0), ({"checkpoint_every": 10}, 8),
    ({"preconditioner": "cholesky"}, 0),
    ({"coarse_block": 8}, 0),
    ({"preconditioner": "jacobi", "mg_levels": 2}, 0),
    ({"preconditioner": "multigrid", "mg_block": 1}, 0),
    ({"preconditioner": "twolevel", "coarse_block": 0}, 0),
    ({"pair_batch": 0}, 0), ({"checkpoint_every": -1}, 0),
    ({"kernels": "cuda"}, 0), ({"noise_weight": "pink"}, 0),
    ({"noise_bandwidth": 4}, 0),
    ({"noise_weight": "banded", "noise_bandwidth": 0}, 0),
]


@pytest.mark.parametrize("destr,default", PARSE_CASES,
                         ids=[str(i) for i in range(len(PARSE_CASES))])
def test_parse_destriper_section_matches_reference(destr, default):
    try:
        want = ref_rd.parse_destriper_section(dict(destr), default)
    except Exception as exc:  # noqa: BLE001 - the type is compared
        with pytest.raises(type(exc)):
            port_rd.parse_destriper_section(dict(destr), default)
        return
    assert port_rd.parse_destriper_section(dict(destr), default) == want


@pytest.mark.parametrize("band", [0, 1])
@pytest.mark.parametrize("ground", [False, True], ids=["offsets", "ground"])
def test_make_band_map_matches_reference(l2files, band, ground):
    _, paths, _ = l2files
    kw = dict(offset_length=50, n_iter=300, threshold=1e-6,
              use_ground=ground, coarse_block=8)
    data, got = port_rd.make_band_map(paths, band, wcs=WCS.from_field(
        *FIELD), device="cpu", **kw)
    ref_data, want = ref_rd.make_band_map(paths, band, wcs=RefWCS.from_field(
        *FIELD), **kw)
    assert data.tod.tobytes() == np.asarray(ref_data.tod).tobytes()
    assert float(got.residual) <= 1e-6 and float(want.residual) <= 1e-6

    def maps(r):
        return {"DESTRIPED": np.asarray(r.destriped_map),
                "NAIVE": np.asarray(r.naive_map),
                "WEIGHTS": np.asarray(r.weight_map),
                "HITS": np.asarray(r.hit_map)}

    _assert_maps_match(maps(got), maps(want))


def test_make_band_maps_joint_matches_reference(l2files):
    _, paths, _ = l2files
    kw = dict(offset_length=50, n_iter=300, threshold=1e-6, coarse_block=8)
    datas, got = port_rd.make_band_maps_joint(
        paths, [0, 1], wcs=WCS.from_field(*FIELD), device="cpu", **kw)
    ref_datas, want = ref_rd.make_band_maps_joint(
        paths, [0, 1], wcs=RefWCS.from_field(*FIELD), **kw)
    assert len(datas) == len(got) == len(want) == 2
    for d, rd, g, w in zip(datas, ref_datas, got, want):
        assert d.tod.tobytes() == np.asarray(rd.tod).tobytes()
        scale = max(float(np.nanstd(np.asarray(w.destriped_map))), 1.0)
        np.testing.assert_allclose(g.destriped_map,
                                   np.asarray(w.destriped_map), rtol=0,
                                   atol=DESTRIPED_ATOL * scale)
        np.testing.assert_allclose(g.naive_map, np.asarray(w.naive_map),
                                   rtol=0, atol=NAIVE_ATOL * scale)
        np.testing.assert_array_equal(g.hit_map, np.asarray(w.hit_map))


def test_make_band_maps_joint_unequal_streams_give_none(l2files, tmp_path):
    """A feed dead in band 1 only: the bands' sample streams differ, and
    both packages return ``(datas, None)`` with the reads done."""
    store = level2_store(13, raster=True)
    w = np.array(store["averaged_tod/weights"])
    w[0, 1] = 0.0
    store["averaged_tod/weights"] = w
    path = str(tmp_path / "Level2_13.hd5")
    store.write(path)
    datas, got = port_rd.make_band_maps_joint(
        [path], [0, 1], wcs=WCS.from_field(*FIELD), device="cpu",
        coarse_block=8)
    ref_datas, want = ref_rd.make_band_maps_joint(
        [path], [0, 1], wcs=RefWCS.from_field(*FIELD), coarse_block=8)
    assert got is None and want is None
    assert [d.tod.size for d in datas] == [d.tod.size for d in ref_datas]
    assert datas[0].tod.size != datas[1].tod.size


# main: (extra [Inputs] lines, extra sections, [Pixelization])
MAIN_CASES = {
    "joint": ("", "", None),
    "per_band": ("joint : false", "", None),
    "ground": ("ground : true", "", None),
    "checkpoint": ("", "[Destriper]\ncheckpoint_every : 5\n", None),
    "calibrator": ("calibrator : true", "", None),
    "healpix": ("", "", "type : healpix\nnside : 256"),
}


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_main_matches_reference(l2files, tmp_path, case, capsys):
    _, _, filelist = l2files
    inputs, sections, pixel = MAIN_CASES[case]
    out = {}
    for pkg in ("port", "ref"):
        ini = _write_ini(tmp_path / f"{pkg}.ini", filelist,
                         str(tmp_path / pkg), inputs, sections, pixel)
        if pkg == "port":
            assert port_rd.main([ini, "--device=cpu"]) == 0
        else:
            assert ref_rd.main([ini]) == 0
        out[pkg] = capsys.readouterr().out
    for band in (0, 1):
        name = f"co2_band{band}.fits"
        _assert_maps_match(_read_maps(str(tmp_path / "port" / name)),
                           _read_maps(str(tmp_path / "ref" / name)))
    assert out["port"].count(" CG iters, residual ") == 2
    if case == "checkpoint":
        # each band's snapshot is deleted once it completes, in both
        # packages (its integrity sidecar stays, as in the reference)
        for pkg in ("port", "ref"):
            assert not [f for f in os.listdir(tmp_path / pkg / "logs")
                        if f.endswith(".npz")]


UNPORTED = {
    "--live-port": ({"argv": ["--live-port=0"]}),
    "COMAP_NRANKS": ({"env": "2"}),
    "[Inputs] sharded": ({"inputs": "sharded : true"}),
    "[Inputs] prefetch": ({"inputs": "prefetch : 2"}),
    "[Inputs] cache_mb": ({"inputs": "cache_mb : 512"}),
    "[Inputs] writeback": ({"inputs": "writeback : 1"}),
    "[Inputs] compile_cache_dir": ({"inputs": "compile_cache_dir : cc"}),
    "[Telemetry] enabled": ({"sections": "[Telemetry]\nenabled : true\n"}),
    "[Tuning] enabled": ({"sections": "[Tuning]\nenabled : true\n"}),
    "[Control] solver_policy": ({"sections": "[Control]\n"
                                             "solver_policy : true\n"}),
    "kernels = xla": ({"sections": "[Destriper]\nkernels : xla\n"}),
    "tod_dtype = bf16": ({"sections": "[Precision]\ntod_dtype : bf16\n"}),
}


# the knobs of UNPORTED that the ingest tier, bf16 streaming, the
# telemetry plane and the control plane now run
RUNS = ("[Inputs] prefetch", "[Inputs] cache_mb", "[Inputs] writeback",
        "tod_dtype = bf16", "--live-port", "[Telemetry] enabled",
        "[Control] solver_policy")


@pytest.mark.parametrize("knob", list(UNPORTED))
def test_main_refuses_unported_knobs(l2files, tmp_path, monkeypatch, knob,
                                     capsys):
    """Each knob whose machinery is not ported raises naming itself
    (``compile_cache_dir`` naming XLA) before any map is written. The
    knobs of ``RUNS`` were refused until the ingest tier (and, for
    ``--live-port`` and ``[Telemetry]``, the telemetry plane, for
    ``[Control]`` the control plane) was ported; each now runs ``main``
    in both packages, the port's maps held
    to the reference's as ``test_main_matches_reference`` holds them
    (bf16: the same narrowed bits in both), each package's telemetry
    stream closed after."""
    _, _, filelist = l2files
    spec = UNPORTED[knob]
    res = spec.get("resilience", "quarantine : off\nlease_ttl_s : 0")
    if knob in RUNS:
        for pkg in ("port", "ref"):
            ini = _write_ini(tmp_path / f"{pkg}.ini", filelist,
                             str(tmp_path / pkg), spec.get("inputs", ""),
                             spec.get("sections", ""), resilience=res)
            argv = [ini] + spec.get("argv", [])
            try:
                assert (port_rd.main(argv + ["--device=cpu"])
                        if pkg == "port" else ref_rd.main(argv)) == 0
            finally:
                from comapreduce_tpu.telemetry import TELEMETRY as ref_t
                from comapreduce_tpu_torch.telemetry import TELEMETRY

                TELEMETRY.close()
                ref_t.close()
        assert capsys.readouterr().out.count(" CG iters, residual ") == 4
        for band in (0, 1):
            name = f"co2_band{band}.fits"
            _assert_maps_match(_read_maps(str(tmp_path / "port" / name)),
                               _read_maps(str(tmp_path / "ref" / name)))
        return
    ini = _write_ini(tmp_path / "p.ini", filelist, str(tmp_path / "out"),
                     spec.get("inputs", ""), spec.get("sections", ""),
                     resilience=res)
    if "env" in spec:
        monkeypatch.setenv("COMAP_NRANKS", spec["env"])
    with pytest.raises(NotImplementedError) as err:
        port_rd.main([ini, "--device=cpu"] + spec.get("argv", []))
    assert knob in str(err.value)
    if "compile_cache_dir" in knob:
        assert "XLA" in str(err.value)
    assert not os.path.exists(tmp_path / "out" / "co2_band0.fits")


def test_main_needs_a_card_unless_asked_for_the_cpu(l2files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    _, _, filelist = l2files
    ini = _write_ini(tmp_path / "p.ini", filelist, str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_rd.main([ini])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_rd.make_band_map([l2files[1][0]], 0,
                              wcs=WCS.from_field(*FIELD))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_rd.make_band_maps_joint([l2files[1][0]], [0, 1],
                                     wcs=WCS.from_field(*FIELD))
