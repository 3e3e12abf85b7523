"""Batch launcher: run the TOD pipeline as N processes (port of
``comapreduce_tpu/cli/batchrun.py``)::

    python -m comapreduce_tpu_torch.cli.batchrun -n 4 configuration.toml \
        [run_average args...]

spawns N ``comapreduce_tpu_torch.cli.run_average`` workers, each with
``COMAP_RANK`` / ``COMAP_NRANKS`` set, which ``run_average`` reads
(``pipeline.stages.rank_info``): the workers take their share of the
filelist — the elastic lease queue, or the static ``rank::n`` shard with
``[resilience] lease_ttl_s = 0`` — as an ``mpiexec`` launch would. Every
worker computes on the device ``run_average`` is given (``--device``;
default the card, which the workers share). Returns the first non-zero
exit code of the workers, else 0.
"""

from __future__ import annotations

import os
import subprocess
import sys

__all__ = ["main", "worker_commands"]


def _usage() -> int:
    print("usage: python -m comapreduce_tpu_torch.cli.batchrun "
          "[-n N] configuration.toml [run_average args...]",
          file=sys.stderr)
    return 2


def _parse(argv):
    """``(n_procs, run_average argv)``, or None on a malformed line."""
    n_procs = 2
    rest = []
    it = iter(argv)
    for a in it:
        if a in ("-n", "--n-procs"):
            try:
                n_procs = int(next(it))
            except (StopIteration, ValueError):
                return None
        elif a.startswith("--n-procs="):
            try:
                n_procs = int(a.split("=", 1)[1])
            except ValueError:
                return None
        else:
            rest.append(a)
    if len(rest) < 1 or n_procs < 1:
        return None
    return n_procs, rest


def worker_commands(argv) -> list[tuple[list[str], dict]]:
    """The ``(command, environment)`` of each worker ``main`` would
    spawn for ``argv`` (``ValueError`` on a malformed line)."""
    parsed = _parse(list(argv))
    if parsed is None:
        raise ValueError(f"malformed batchrun arguments {list(argv)}")
    n_procs, rest = parsed
    out = []
    for rank in range(n_procs):
        env = dict(os.environ)
        # the stage chain is embarrassingly parallel over files: ranks
        # never talk during the TOD loop
        env["COMAP_RANK"] = str(rank)
        env["COMAP_NRANKS"] = str(n_procs)
        out.append(([sys.executable, "-m",
                     "comapreduce_tpu_torch.cli.run_average", *rest], env))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        commands = worker_commands(argv)
    except ValueError:
        return _usage()
    procs = [subprocess.Popen(cmd, env=env) for cmd, env in commands]
    rcs = [p.wait() for p in procs]
    return next((r for r in rcs if r), 0)


if __name__ == "__main__":
    raise SystemExit(main())
