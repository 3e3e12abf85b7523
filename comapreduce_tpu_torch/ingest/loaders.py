"""File loaders and the serial Level-1 stream (port of the serial path of
``comapreduce_tpu/ingest/loaders.py`` and ``ingest/prefetcher.py``).

:func:`level1_stream` yields one :class:`PrefetchItem` per file, read at
``next()``: a read that raises is captured into its item (the runner's
per-file BAD-FILE slot) and the stream moves on. Only the serial path is
ported: ``prefetch >= 1`` (the background reader), a cache and the
reference's retry, chaos and watchdog hooks raise
``NotImplementedError``, as do ``synth://`` virtual files and a TOD
dtype other than f32.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Iterator

from comapreduce_tpu_torch.data.level import COMAPLevel1, COMAPLevel2

__all__ = ["PrefetchItem", "load_level1", "load_level2", "level1_stream"]


@dataclass
class PrefetchItem:
    """One file's ingest result: exactly one of ``payload``/``error``."""

    index: int
    filename: str
    payload: Any = None
    error: BaseException | None = None
    read_s: float = 0.0
    cached: bool = False
    retries: int = 0
    fatal: bool = False

    def result(self):
        """Payload, re-raising the captured per-file error."""
        if self.error is not None:
            raise self.error
        return self.payload


def _refuse_tod_dtype(tod_dtype: str) -> None:
    if str(tod_dtype).lower() not in ("f32", "float32"):
        raise NotImplementedError(
            f"tod_dtype={tod_dtype!r}: the precision policy "
            "(ops/precision.PrecisionPolicy) is not ported")


def load_level1(filename: str, eager_tod: bool = True,
                tod_dtype: str = "f32"):
    """Read a Level-1 file (``loaders.py:29``). ``eager_tod=True``
    materialises ``spectrometer/tod``, closes the file and returns the
    decoded payload dict; ``False`` returns the store with the TOD a
    lazy handle on the open file."""
    _refuse_tod_dtype(tod_dtype)
    if filename.startswith("synth://"):
        raise NotImplementedError(
            f"{filename}: synth:// virtual files need synthetic/memsource, "
            "which is not ported")
    data = COMAPLevel1()
    data.read(filename)
    if not eager_tod:
        return data
    for path in data.lazy_paths:
        if path in data:
            data.materialise(path)
    data.close()
    return data.export_payload()


def load_level2(filename: str, tod_dtype: str = "f32"):
    """Read a Level-2 file into a decoded payload dict
    (``loaders.py:67``)."""
    _refuse_tod_dtype(tod_dtype)
    lvl2 = COMAPLevel2(filename=filename)
    return lvl2.export_payload()


def _rebuild(cls, payload, **kwargs):
    """Payload dict -> fresh store wrapper; live stores pass through."""
    if isinstance(payload, dict) and "data" in payload and \
            "attrs" in payload:
        store = cls(**kwargs)
        store.adopt_payload(payload)
        return store
    return payload


def level1_stream(filenames, prefetch: int = 0, cache=None,
                  eager_tod: bool = True, eager_for=None,
                  retry=None, chaos=None, watchdog=None,
                  on_hang=None,
                  tod_dtype: str = "f32") -> Iterator[PrefetchItem]:
    """Ordered :class:`PrefetchItem`s of :class:`COMAPLevel1` views, read
    serially with the TOD lazy (``loaders.py:140``; without a cache or
    prefetching the reference keeps it lazy too)."""
    unported = {"prefetch": prefetch >= 1, "cache": cache is not None,
                "retry": retry is not None, "chaos": chaos is not None,
                "watchdog": watchdog is not None,
                "on_hang": on_hang is not None}
    for knob, on in unported.items():
        if on:
            raise NotImplementedError(
                f"level1_stream: {knob} is not ported (serial path only)")
    _refuse_tod_dtype(tod_dtype)
    del eager_tod, eager_for        # the serial cache-less path is lazy
    for i, fname in enumerate(filenames):
        t0 = time.perf_counter()
        try:
            payload = load_level1(fname, eager_tod=False)
        except Exception as exc:  # noqa: BLE001 - per-file fault tolerance
            yield PrefetchItem(i, fname, error=exc,
                               read_s=time.perf_counter() - t0)
            continue
        yield PrefetchItem(i, fname,
                           payload=_rebuild(COMAPLevel1, payload),
                           read_s=time.perf_counter() - t0)
