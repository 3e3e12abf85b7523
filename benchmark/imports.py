"""The check that nothing of JAX, nor the JAX package, was loaded: by
each module's top-level name (the part before the first dot), compared
whole, so ``comapreduce_tpu_torch`` is not ``comapreduce_tpu``."""

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "comapreduce_tpu"})


def forbidden_modules(modules) -> set[str]:
    """The names in ``modules`` (e.g. ``sys.modules``) whose top-level
    name is forbidden."""
    return {name for name in modules
            if name.split(".", 1)[0] in FORBIDDEN}
