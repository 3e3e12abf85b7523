"""Shape-bucket autotuning: measurement-driven knob selection, memoised
into the campaign plan (port of ``comapreduce_tpu/tuning/``).

- :mod:`~comapreduce_tpu_torch.tuning.space` — the declarative knob space,
  with validity rules reusing the pipeline's own validators so a
  sweep can never propose an invalid combo;
- :mod:`~comapreduce_tpu_torch.tuning.tuner` — per-(platform, device
  kind, shape bucket, precision) sweeps over the actual programs,
  pruned by the program-registry cost prior and bounded by successive
  halving;
- :mod:`~comapreduce_tpu_torch.tuning.cache` — the durable ``tuning.jsonl``
  winners ledger (sealed lines, torn-line-safe appends, content-hash
  keys) plus the process-wide :data:`TUNING` lookup the integration
  points consult behind the strict ``[tuning]`` config table.

Absent ``[tuning]`` table = TUNING disabled = byte-identical pipeline.
"""

from comapreduce_tpu_torch.tuning.cache import (TUNING, TuningCache,
                                                TuningConfig, content_key,
                                                read_tuning, tuning_path)
from comapreduce_tpu_torch.tuning.space import (SPACE_VERSION,
                                                SpaceContext,
                                                enumerate_group,
                                                plan_bucket, solver_bucket,
                                                stage_bucket,
                                                validate_combo)
from comapreduce_tpu_torch.tuning.tuner import Tuner, registry_prior

__all__ = ["SPACE_VERSION", "SpaceContext", "TUNING", "Tuner",
           "TuningCache", "TuningConfig", "content_key",
           "enumerate_group", "plan_bucket", "read_tuning",
           "registry_prior", "solver_bucket", "stage_bucket",
           "tuning_path", "validate_combo"]
