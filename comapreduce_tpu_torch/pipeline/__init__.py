"""Pipeline runtime: config, stage registry and the per-file runner
(port of ``comapreduce_tpu/pipeline/``; the elastic scheduler, the
campaign warm-up and the calibration and numpy-backend stages are not
ported).

- :mod:`config` — TOML loading and the legacy INI parser;
- :mod:`registry` — the name-based stage registry;
- :mod:`stages` — the Level-1 -> Level-2 stages;
- :mod:`runner` — the ``Runner``: per-file loop, resume against the
  Level-2 checkpoint, falsy-``STATE`` abort, per-stage timings.
"""

from comapreduce_tpu_torch.pipeline.config import (IniConfig, load_toml,
                                                   parse_stage_name)
from comapreduce_tpu_torch.pipeline.registry import (available_stages,
                                                     register, resolve)
from comapreduce_tpu_torch.pipeline.runner import Runner, set_logging
from comapreduce_tpu_torch.pipeline import stages  # noqa: F401 (registers)

__all__ = ["IniConfig", "load_toml", "parse_stage_name", "register",
           "resolve", "available_stages", "Runner", "set_logging",
           "stages"]
