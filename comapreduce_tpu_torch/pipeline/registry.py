"""Name-based pipeline-stage registry (port of
``comapreduce_tpu/pipeline/registry.py``).

Stages register under their class name, per backend: ``device`` (the
PyTorch path, on the device the runner gives it) or ``any`` (host-only
stages). A config's ``backend = "tpu"`` names the reference's device
path and resolves to ``device``. The reference's ``numpy`` host-oracle
backend (``comapreduce_tpu/backends/``) is not ported: asking for it
raises ``NotImplementedError``, never a silent fallback.
"""

from __future__ import annotations

from comapreduce_tpu_torch.pipeline.config import parse_stage_name

__all__ = ["register", "resolve", "available_stages", "DEFAULT_BACKEND",
           "KNOWN_BACKENDS"]

DEFAULT_BACKEND = "device"
KNOWN_BACKENDS = ("device", "numpy")
_ALIASES = {"tpu": "device"}

# {class_name: {backend: stage_class}}
_REGISTRY: dict[str, dict[str, type]] = {}


def register(name: str | None = None, backend: str = DEFAULT_BACKEND):
    """Class decorator: ``@register()`` or ``@register("Name", "any")``."""

    def wrap(cls):
        _REGISTRY.setdefault(name or cls.__name__, {})[backend] = cls
        return cls

    return wrap


def resolve(name: str, backend: str | None = None, **kwargs):
    """Instantiate stage ``name`` (may be ``Module.Class(variant)``) with
    ``kwargs``; ``backend`` comes from the call, from a ``backend`` key
    of ``kwargs`` (the stage's config table), or defaults to
    ``device``."""
    _, cls_name, variant = parse_stage_name(name)
    impls = _REGISTRY.get(cls_name)
    if not impls:
        raise KeyError(f"unknown pipeline stage: {name!r} "
                       f"(known: {sorted(_REGISTRY)})")
    backend = kwargs.pop("backend", None) if backend is None else backend
    backend = _ALIASES.get(backend, backend) or DEFAULT_BACKEND
    if backend not in KNOWN_BACKENDS:
        raise ValueError(f"unknown backend {backend!r} for stage {name!r} "
                         f"(known: {KNOWN_BACKENDS})")
    if backend == "numpy":
        raise NotImplementedError(
            f"stage {name!r}: backend = 'numpy' (the host oracle of "
            "comapreduce_tpu/backends/) is not ported")
    cls = impls.get(backend) or impls.get("any")
    if cls is None:
        raise KeyError(f"stage {name!r} has no {backend!r} backend "
                       f"(registered: {sorted(impls)})")
    if variant is not None:
        try:
            return cls(variant=variant, **kwargs)
        except TypeError:
            pass
    return cls(**kwargs)


def available_stages() -> dict[str, list[str]]:
    """Registered stage names -> list of backends."""
    return {k: sorted(v) for k, v in sorted(_REGISTRY.items())}
