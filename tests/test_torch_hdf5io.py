"""The port's HDF5 store (``comapreduce_tpu_torch/data/hdf5io.py``) against
the reference's (``comapreduce_tpu/data/hdf5io.py``): a file written by
one package reads back in the other bitwise, datasets and attributes;
lazy datasets stay lazy and are refused by ``export_payload`` until
materialised; the atomic write commits a sidecar both packages verify,
rewrites a mirrored file whole and appends to a foreign one. Beside
them: no module of the port imports ``h5py``, ``jax`` or the JAX
package at import.
"""

import ast
import os
import pathlib

import h5py
import numpy as np
import pytest

from comapreduce_tpu.data.hdf5io import HDF5Store as RefStore
from comapreduce_tpu.resilience.integrity import verify_file as ref_verify
from comapreduce_tpu_torch.data.hdf5io import (HDF5Store, LazyDataset,
                                               is_lazy, safe_hdf5_open)
from comapreduce_tpu_torch.resilience.integrity import (sidecar_path,
                                                        verify_file)

PORT = pathlib.Path(__file__).resolve().parents[1] / "comapreduce_tpu_torch"


def _fill(store, seed=0):
    rng = np.random.default_rng(seed)
    store["spectrometer/tod"] = rng.normal(size=(2, 3, 4, 50)).astype(
        np.float32)
    store["spectrometer/MJD"] = 59620.0 + np.arange(50) / 4.32e6
    store["spectrometer/features"] = rng.integers(0, 2**14, 50)
    store["hk/flag"] = np.array([1, 0, 1], dtype=np.uint8)
    store.set_attrs("comap", "obsid", 123)
    store.set_attrs("comap", "source", "co2,sky")
    store.set_attrs("", "root_attr", 2.5)
    store.set_attrs("spectrometer/tod", "unit", "counts")
    return store


def _same_store(a, b):
    assert sorted(a.keys()) == sorted(b.keys())
    for k in a.keys():
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k
    attrs_a = {p: dict(kv) for p, kv in a.attr_items() if kv}
    attrs_b = {p: dict(kv) for p, kv in b.attr_items() if kv}
    assert attrs_a.keys() == attrs_b.keys()
    for p in attrs_a:
        for key, v in attrs_a[p].items():
            assert np.array_equal(np.asarray(v), np.asarray(attrs_b[p][key]))


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("atomic", [False, True])
def test_file_written_by_one_package_reads_in_the_other(tmp_path, writer,
                                                        atomic):
    path = str(tmp_path / "f.hd5")
    src = _fill(HDF5Store() if writer == "port" else RefStore())
    src.write(path, atomic=atomic)
    if atomic:
        assert os.path.exists(sidecar_path(path))
        assert verify_file(path, kind="checkpoint") is True
        assert ref_verify(path, kind="checkpoint") is True
    port = HDF5Store().read(path)
    ref = RefStore().read(path)
    _same_store(port, ref)
    _same_store(port, src)


def test_lazy_paths_stay_lazy_until_materialised(tmp_path):
    path = str(tmp_path / "f.hd5")
    _fill(RefStore()).write(path)
    port = HDF5Store(lazy_paths=("spectrometer/tod",)).read(path)
    lazy = port["spectrometer/tod"]
    assert is_lazy(lazy) and isinstance(lazy, h5py.Dataset)
    with pytest.raises(ValueError, match="lazy"):
        port.export_payload()
    ref = RefStore(lazy_paths=("spectrometer/tod",)).read(path)
    np.testing.assert_array_equal(lazy[1, :, :, 3:9],
                                  ref["spectrometer/tod"][1, :, :, 3:9])
    full = port.materialise("spectrometer/tod")
    assert isinstance(full, np.ndarray) and not is_lazy(full)
    payload = port.export_payload()
    again = HDF5Store().adopt_payload(payload)
    _same_store(again, port)
    again["extra"] = np.zeros(1)
    assert "extra" not in port           # adoption copies the dict
    port.close()
    ref.close()


def test_lazy_dataset_marker_is_skipped_by_write(tmp_path):
    class Lazy(LazyDataset):
        shape = (2, 2)

        def __getitem__(self, key):
            return np.ones(self.shape, np.float32)[key]

    store = _fill(HDF5Store())
    store["spectrometer/tod"] = Lazy()
    assert is_lazy(store["spectrometer/tod"])
    assert not is_lazy(np.zeros(2))
    with pytest.raises(ValueError, match="lazy"):
        store.export_payload()
    path = str(tmp_path / "f.hd5")
    store.write(path, atomic=True)
    back = RefStore().read(path)
    assert "spectrometer/tod" not in back
    assert "spectrometer/MJD" in back
    np.testing.assert_array_equal(store.materialise("spectrometer/tod"),
                                  np.ones((2, 2), np.float32))


@pytest.mark.parametrize("atomic", [False, True])
def test_append_keeps_datasets_the_store_does_not_hold(tmp_path, atomic):
    path = str(tmp_path / "f.hd5")
    _fill(RefStore()).write(path, atomic=True)
    extra = HDF5Store()
    extra["vane/system_gain"] = np.arange(6, dtype=np.float32)
    extra.set_attrs("vane", "events", 2)
    extra.write(path, atomic=atomic)
    # the sidecar still verifies after an append (re-sealed in place or
    # committed anew)
    assert ref_verify(path, kind="checkpoint") is True
    back = RefStore().read(path)
    assert "spectrometer/tod" in back and "vane/system_gain" in back
    assert back.attrs("vane", "events") == 2
    # a store that read the file and changed it rewrites it whole
    port = HDF5Store().read(path)
    port["vane/system_gain"] = np.zeros(3, np.float32)
    port.write(path, atomic=True)
    assert RefStore().read(path)["vane/system_gain"].shape == (3,)
    assert port.source_filename == os.path.abspath(path)


def test_corrupt_checkpoint_raises_on_read(tmp_path):
    from comapreduce_tpu_torch.resilience.integrity import \
        CorruptArtifactError

    path = str(tmp_path / "f.hd5")
    _fill(HDF5Store()).write(path, atomic=True)
    with open(path, "r+b") as fh:
        fh.seek(-8, os.SEEK_END)
        fh.write(b"\xff" * 8)
    with pytest.raises(CorruptArtifactError):
        HDF5Store().read(path)


def test_groups_and_contains_match_reference():
    port, ref = _fill(HDF5Store()), _fill(RefStore())
    assert port.groups == ref.groups
    for groups in (["spectrometer"], ["hk", "spectrometer/tod"],
                   ["vane"], []):
        assert port.contains_groups(groups) == ref.contains_groups(groups)


def test_safe_open_raises_at_once_on_a_missing_file(tmp_path):
    with pytest.raises(OSError):
        safe_hdf5_open(str(tmp_path / "missing.hd5"), "r", retries=3,
                       delay=10.0)


def _module_level_imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_no_h5py_jax_or_reference_at_import():
    bad = {}
    for path in sorted(PORT.rglob("*.py")):
        hit = _module_level_imports(path) & {"h5py", "jax",
                                             "comapreduce_tpu"}
        if hit:
            bad[str(path.relative_to(PORT))] = hit
        text = path.read_text()
        for banned in ("import jax", "from jax", "import comapreduce_tpu.",
                       "from comapreduce_tpu.", "from comapreduce_tpu "):
            assert banned not in text, (path, banned)
    assert not bad, bad
