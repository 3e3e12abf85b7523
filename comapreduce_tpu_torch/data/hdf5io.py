"""Dict-backed HDF5 store with lazy large datasets (port of
``comapreduce_tpu/data/hdf5io.py``).

A store mirrors one HDF5 file as ``{path: array}`` plus per-path
attributes; datasets named in ``lazy_paths`` (the raw TOD) stay lazy:
sliceable handles that are read only where sliced. ``write`` appends or
overwrites datasets and attributes in an existing file, which makes the
Level-2 file the pipeline's checkpoint; ``write(atomic=True)`` stages
the update in a temporary copy and commits it with its sha256 sidecar
(``resilience.integrity.committed_replace``).

``h5py`` is imported inside the functions that open a file, never at
import: the store, and everything above it, runs without ``h5py``, and
only a file read or write then raises ``ImportError``.

A lazy dataset is an open h5py dataset or any :class:`LazyDataset` (an
object that slices like one and reads on demand). Lazy datasets belong
to their source: ``write`` skips them and ``export_payload`` refuses
them until they are materialised.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Iterable, Iterator

import numpy as np

__all__ = ["HDF5Store", "LazyDataset", "safe_hdf5_open", "is_lazy"]

logger = logging.getLogger("comapreduce_tpu_torch")


class LazyDataset:
    """Marker base of read-on-demand datasets: subclasses provide
    ``shape``, ``dtype`` and ``__getitem__`` returning numpy arrays."""

    shape: tuple = ()
    dtype = np.float32

    def __getitem__(self, key):  # pragma: no cover - interface
        raise NotImplementedError


def is_lazy(value) -> bool:
    """True for a :class:`LazyDataset` or an open h5py dataset."""
    if isinstance(value, LazyDataset):
        return True
    t = type(value)
    return t.__module__.split(".")[0] == "h5py" and t.__name__ == "Dataset"


def safe_hdf5_open(filename: str, mode: str = "r", retries: int = 10,
                   delay: float = 1.0, backoff: float = 1.5):
    """Open an HDF5 file, retrying while another writer holds its lock
    (``hdf5io.py:36``): ``BlockingIOError``/lock ``OSError`` retry with
    exponential backoff, any other error raises at once."""
    import h5py

    attempt = 0
    while True:
        try:
            return h5py.File(filename, mode)
        except (BlockingIOError, OSError) as err:
            msg = str(err).lower()
            locked = (isinstance(err, BlockingIOError)
                      or "lock" in msg
                      or "resource temporarily unavailable" in msg)
            if not locked or not os.path.exists(filename):
                raise
            attempt += 1
            if attempt > retries:
                raise
            logger.warning("safe_hdf5_open: %s locked, retry %d/%d in "
                           "%.1f s", filename, attempt, retries, delay)
            time.sleep(delay)
            delay *= backoff


@dataclass
class HDF5Store:
    """In-memory mirror of an HDF5 file: ``{path: ndarray | lazy}``."""

    name: str = "HDF5Store"
    lazy_paths: tuple = ()
    _data: dict = field(default_factory=dict)
    _attrs: dict = field(default_factory=dict)
    _file: object = field(default=None, repr=False)
    # abspath of the file this store mirrors: gates the atomic write's
    # rewrite-instead-of-copy fast path
    _mirrors: str = field(default="", repr=False)

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, path: str):
        return self._data[path]

    def __setitem__(self, path: str, value) -> None:
        self._data[path] = value

    def __contains__(self, path: str) -> bool:
        return path in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def get(self, path: str, default=None):
        return self._data.get(path, default)

    # -- attributes ---------------------------------------------------------
    def attrs(self, path: str, key: str | None = None):
        """Attributes dict of ``path``, or a single attribute if ``key``."""
        if key is None:
            return self._attrs.get(path, {})
        return self._attrs[path][key]

    def set_attrs(self, path: str, key: str, value) -> None:
        self._attrs.setdefault(path, {})[key] = value

    def attr_items(self):
        return self._attrs.items()

    @property
    def groups(self) -> list[str]:
        """Unique top-level group names present in the store."""
        return sorted({p.split("/")[0] for p in self._data})

    def contains_groups(self, groups: Iterable[str]) -> bool:
        """True if every top-level group in ``groups`` is present (the
        runner's resume test)."""
        have = set(self.groups)
        return all(g.split("/")[0] in have for g in groups)

    # -- file I/O -----------------------------------------------------------
    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            finally:
                self._file = None

    def __del__(self):  # pragma: no cover - GC timing dependent
        try:
            self.close()
        except Exception:
            pass

    @property
    def source_filename(self) -> str:
        """Absolute path this store mirrors: the file last ``read``, or
        the last full ``write`` target ('' before either)."""
        return self._mirrors

    def read(self, filename: str) -> "HDF5Store":
        """Read every dataset and attribute of ``filename`` (resetting the
        store); a file committed with an integrity sidecar is verified
        first and raises ``CorruptArtifactError`` on a mismatch."""
        import h5py

        from comapreduce_tpu_torch.resilience.integrity import verify_file

        self.close()
        self._data = {}
        self._attrs = {}
        self._mirrors = os.path.abspath(filename)
        verify_file(filename, kind="checkpoint")
        f = safe_hdf5_open(filename, "r")
        self._file = f
        for k, v in f.attrs.items():
            self.set_attrs("", k, v)

        keep_open = False

        def visit(name: str, node) -> None:
            nonlocal keep_open
            for k, v in node.attrs.items():
                self.set_attrs(name, k, v)
            if isinstance(node, h5py.Dataset):
                if name in self.lazy_paths:
                    self._data[name] = node
                    keep_open = True
                else:
                    self._data[name] = node[...]

        f.visititems(visit)
        if not keep_open:
            # hold no read lock when nothing stayed lazy: the runner's
            # checkpoint must be able to append to this file
            f.close()
            self._file = None
        return self

    def write(self, filename: str, atomic: bool = False,
              durable: bool = True) -> None:
        """Append/overwrite the store's datasets + attrs into ``filename``
        (lazy datasets are skipped). ``atomic=True`` stages the update in
        a temporary copy and commits it sidecar-first, so a kill mid-write
        never leaves a partial checkpoint; ``durable`` fsyncs before the
        rename (``hdf5io.py:177``)."""
        if self._file is not None and os.path.abspath(
                getattr(self._file, "filename", "")) == \
                os.path.abspath(filename):
            self.close()

        if atomic:
            import shutil
            import tempfile

            from comapreduce_tpu_torch.resilience.integrity import \
                committed_replace

            d = os.path.dirname(os.path.abspath(filename))
            fd, tmp = tempfile.mkstemp(suffix=".hd5.tmp", dir=d)
            os.close(fd)
            # a store that mirrors the target (or a target not on disk)
            # and holds no lazy handle rewrites it whole; otherwise
            # copy + append, never deleting datasets it does not hold
            target = os.path.abspath(filename)
            fresh = (not any(is_lazy(v) for v in self._data.values())
                     and (not os.path.exists(filename)
                          or self._mirrors == target))
            try:
                if os.path.exists(filename) and not fresh:
                    shutil.copy2(filename, tmp)
                    self._write_into(tmp, "a")
                else:
                    self._write_into(tmp, "w")
                    self._mirrors = target
                committed_replace(tmp, filename, kind="checkpoint",
                                  durable=durable)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
            return

        mode = "a" if os.path.exists(filename) else "w"
        self._write_into(filename, mode)
        from comapreduce_tpu_torch.resilience.integrity import \
            refresh_sidecar

        refresh_sidecar(filename, kind="checkpoint", durable=durable)

    def _write_into(self, filename: str, mode: str) -> None:
        with safe_hdf5_open(filename, mode) as out:
            for path, value in self._data.items():
                if is_lazy(value):
                    continue
                if path in out:
                    del out[path]
                out.create_dataset(path, data=np.asarray(value))
            for path, kv in self._attrs.items():
                if path == "":
                    target = out
                elif path in out:
                    target = out[path]
                elif is_lazy(self._data.get(path)):
                    # attrs of a still-lazy source dataset: a group at a
                    # dataset path would corrupt the schema
                    continue
                else:
                    target = out.require_group(path)
                for k, v in kv.items():
                    target.attrs[k] = v

    # -- ingest payloads ----------------------------------------------------
    def export_payload(self) -> dict:
        """Decoded-content snapshot ``{'data', 'attrs', 'source'}`` with
        the dict structure copied and the arrays shared; a lazy dataset
        must be materialised first."""
        for path, v in self._data.items():
            if is_lazy(v):
                raise ValueError(
                    f"export_payload: {path!r} is still a lazy handle; "
                    "materialise it first")
        return {"data": dict(self._data),
                "attrs": {k: dict(v) for k, v in self._attrs.items()},
                "source": self._mirrors}

    def adopt_payload(self, payload: dict) -> "HDF5Store":
        """Rebuild this store from an :meth:`export_payload` snapshot
        (dict structure copied again, arrays shared read-only)."""
        self.close()
        self._data = dict(payload["data"])
        self._attrs = {k: dict(v) for k, v in payload["attrs"].items()}
        self._mirrors = payload.get("source", "")
        return self

    def materialise(self, path: str) -> np.ndarray:
        """Force a lazy dataset into memory and return it."""
        v = self._data[path]
        if is_lazy(v):
            v = v[...]
            self._data[path] = v
        return v
