"""Ingest configuration: the ``[ingest]`` / ``[Inputs]`` knobs (port of
``comapreduce_tpu/ingest/config.py``).

One value object shared by every ingest consumer (the Runner's TOML
``[ingest]`` table, the map-maker's INI ``[Inputs]`` keys), so the knob
names cannot drift between entry points:

- ``prefetch``: read-ahead queue depth; 0 reads serially on the
  consumer's thread, ``>= 1`` starts the background reader;
- ``cache_mb``: the in-memory :class:`~.cache.BlockCache` budget in MiB
  (0: no cache);
- ``spill_dir``: where evicted cache entries are pickled ('' : dropped);
- ``eager_tod``: a prefetched or cached Level-1 read materialises the
  TOD on the reader's thread (the read being overlapped);
- ``compile_cache_dir``: where the kernel libraries are kept, built or
  found by a later process (``pipeline.campaign.enable_compile_cache``;
  the reference's is XLA's persistent compilation cache);
- ``writeback``: the asynchronous Level-2 checkpoint queue depth
  (``data/writeback.py``); 0 writes synchronously.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["IngestConfig"]


@dataclass(frozen=True)
class IngestConfig:
    """Knobs of the ingest tier (module docstring). ``None`` means
    disabled and negative values clamp to disabled, as in the
    reference."""

    prefetch: int = 0
    cache_mb: float = 0.0
    spill_dir: str = ""
    eager_tod: bool = True
    compile_cache_dir: str = ""
    writeback: int = 0

    def __post_init__(self):
        object.__setattr__(self, "prefetch",
                           max(int(self.prefetch or 0), 0))
        object.__setattr__(self, "cache_mb",
                           max(float(self.cache_mb or 0.0), 0.0))
        object.__setattr__(self, "spill_dir", str(self.spill_dir or ""))
        object.__setattr__(self, "eager_tod",
                           True if self.eager_tod is None
                           else bool(self.eager_tod))
        object.__setattr__(self, "compile_cache_dir",
                           str(self.compile_cache_dir or ""))
        object.__setattr__(self, "writeback",
                           max(int(self.writeback or 0), 0))

    KNOBS = ("prefetch", "cache_mb", "spill_dir", "eager_tod",
             "compile_cache_dir", "writeback")

    @classmethod
    def from_mapping(cls, mapping) -> "IngestConfig":
        """Pick the ingest knobs out of a wider mapping (an INI
        ``[Inputs]`` section), ignoring unrelated keys."""
        return cls(**{k: mapping[k] for k in cls.KNOBS if k in mapping})

    @classmethod
    def coerce(cls, value) -> "IngestConfig":
        """None / dict / IngestConfig -> IngestConfig; an unknown key
        raises ``ValueError``."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            known = {k: value[k] for k in cls.KNOBS if k in value}
            unknown = set(value) - set(known)
            if unknown:
                raise ValueError(f"unknown ingest keys: {sorted(unknown)}")
            return cls(**known)
        raise TypeError(f"cannot build IngestConfig from {type(value)}")

    def make_cache(self):
        """A configured BlockCache, or None when caching is off."""
        if self.cache_mb <= 0:
            return None
        from comapreduce_tpu_torch.ingest.cache import BlockCache

        return BlockCache(max_bytes=int(self.cache_mb * (1 << 20)),
                          spill_dir=self.spill_dir)
