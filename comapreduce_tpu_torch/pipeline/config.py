"""Configuration loading: TOML and the legacy INI format (a copy of
``comapreduce_tpu/pipeline/config.py``).

TOML drives the pipeline (``[Global] processes`` plus one table per
stage); the INI parser keeps the legacy coercion rules (``:``/``=``
delimiters, bool/int/float/list values) and ``Module.Class(variant)``
section names. Both feed the stage registry (:mod:`registry`).
"""

from __future__ import annotations

import re

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: tomli is the same parser
    try:
        import tomli as tomllib
    except ModuleNotFoundError:  # neither: gate to load_toml call time
        tomllib = None

__all__ = ["load_toml", "IniConfig", "parse_stage_name", "coerce",
           "read_filelist"]


def read_filelist(path: str) -> list[str]:
    """Paths from a filelist text file: one per line, blank lines and
    ``#`` comments (leading whitespace allowed) skipped. The single
    shared parser for every filelist consumer."""
    with open(path) as f:
        return [ln.strip() for ln in f
                if ln.strip() and not ln.strip().startswith("#")]

_STAGE_NAME_RE = re.compile(
    r"^(?:(?P<module>[A-Za-z_]\w*)\.)?(?P<cls>[A-Za-z_]\w*)"
    r"(?:\((?P<variant>[^)]*)\))?$")


def load_toml(path: str) -> dict:
    """Load a TOML pipeline configuration (``run_average.py:104``)."""
    if tomllib is None:  # pragma: no cover - env without tomllib/tomli
        raise ModuleNotFoundError(
            "TOML configs need tomllib (Python >= 3.11) or tomli")
    with open(path, "rb") as f:
        return tomllib.load(f)


def parse_stage_name(name: str):
    """Split ``"Module.Class(variant)"`` into ``(module, cls, variant)``.

    ``module`` and ``variant`` may be ``None``; bare class names are allowed
    (the TOML path uses bare names, ``run_average.py:44-46``). Raises
    ``ValueError`` on malformed names — the reference's ``getClass`` would
    crash opaquely instead (``Tools/Parser.py:26-41``).
    """
    m = _STAGE_NAME_RE.match(name.strip())
    if not m:
        raise ValueError(f"malformed stage name: {name!r}")
    return m.group("module"), m.group("cls"), m.group("variant")


def coerce(value: str):
    """Coerce an INI value string the way ``ParserClass.ReadLines`` does:
    bools, ints, floats, comma lists (recursively coerced), else str."""
    s = value.strip()
    if "," in s:
        items = [coerce(v) for v in s.split(",") if v.strip() != ""]
        return items
    low = s.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("none", ""):
        return None
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


class IniConfig(dict):
    """Nested-dict INI parser with the legacy coercion rules.

    ``IniConfig(filename)`` or ``IniConfig.from_text(text)``. Sections map to
    dicts; ``key : value`` and ``key = value`` are both accepted; ``#`` and
    ``;`` start comments. Unlike the reference parser this one keeps the
    raw section-name string as the key (including ``Class(variant)``),
    which :func:`parse_stage_name` decodes.
    """

    def __init__(self, filename: str | None = None):
        super().__init__()
        if filename is not None:
            with open(filename) as f:
                self._parse(f.read())

    @classmethod
    def from_text(cls, text: str) -> "IniConfig":
        cfg = cls()
        cfg._parse(text)
        return cfg

    def _parse(self, text: str) -> None:
        section = None
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].split(";", 1)[0].strip()
            if not line:
                continue
            if line.startswith("[") and line.endswith("]"):
                section = line[1:-1].strip()
                self.setdefault(section, {})
                continue
            # first delimiter by position, so '=' values containing ':'
            # (paths, times) split at the right place
            positions = [(line.index(d), d) for d in (":", "=") if d in line]
            if not positions:
                continue
            _, delim = min(positions)
            key, value = line.split(delim, 1)
            target = self.setdefault(section, {}) if section else self
            target[key.strip()] = coerce(value)

    def pipeline_jobs(self) -> list[tuple[str, dict]]:
        """Legacy job list: the ``[Inputs] pipeline`` stage names, each with
        its own section's kwargs (``Tools/Parser.py:44-96``)."""
        inputs = self.get("Inputs", {})
        pipeline = inputs.get("pipeline", [])
        if isinstance(pipeline, str):
            pipeline = [pipeline]
        jobs = []
        for name in pipeline:
            kwargs = dict(self.get(name, {}))
            jobs.append((name, kwargs))
        return jobs
