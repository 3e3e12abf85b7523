"""Per-call shape records of a program function, for a kernel's
roofline in the traced run: the function is wrapped, by identity, in
every module of the program that holds it (not in its own module, whose
launch counters name it), and restored after the window."""

from __future__ import annotations

import importlib
import sys

PROGRAM = "comapreduce_tpu_torch"


class CallShapes:
    """Record ``shape_of(*args, **kwargs)`` for each call of
    ``module.attr`` made while installed (``None`` records nothing)."""

    def __init__(self, module: str, attr: str, shape_of):
        self.module, self.attr, self.shape_of = module, attr, shape_of
        self.calls: list = []
        self._patched: list = []

    def install(self) -> bool:
        try:
            orig = getattr(importlib.import_module(self.module), self.attr)
        except (ImportError, AttributeError):
            return False
        calls, shape_of = self.calls, self.shape_of

        def wrapper(*args, **kwargs):
            rec = shape_of(*args, **kwargs)
            if rec is not None:
                calls.append(rec)
            return orig(*args, **kwargs)

        for name, mod in list(sys.modules.items()):
            if (mod is None or name == self.module
                    or not (name == PROGRAM
                            or name.startswith(PROGRAM + "."))):
                continue
            for key, val in list(vars(mod).items()):
                if val is orig:
                    setattr(mod, key, wrapper)
                    self._patched.append((mod, key, orig))
        return bool(self._patched)

    def uninstall(self) -> None:
        for mod, key, orig in self._patched:
            setattr(mod, key, orig)
        self._patched.clear()
