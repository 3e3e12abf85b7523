"""Synthetic campaign driver (port of ``comapreduce_tpu/cli/
run_synthetic.py``): ``python -m comapreduce_tpu_torch.cli.run_synthetic
<command>``::

    # stream a scenario's Level-1 files to disk (+ its ground truth)
    run_synthetic generate scenario.toml --out-dir level1/

    # end-to-end transfer-function closure: generate -> inject ->
    # reduce -> destripe -> map -> compare vs the injected truth
    run_synthetic transfer --workdir xfer/ --seed 0 [--check] \\
        [--device cpu]

``generate`` runs on the host and writes byte-identical files for
identical ``([scenario], seed)``, the reference's bytes. ``transfer``
runs the stages, the reader and the solve on ``--device`` (the card
unless ``--device cpu``) and writes the ``transfer.json`` artifact; with
``--check`` it also runs the machine-independent closure gate (non-zero
exit on a broken criterion). ``drill`` runs the synthetic scale drill
(:func:`~comapreduce_tpu_torch.synthetic.loadgen.run_synthetic_drill`:
three elastic worker processes, a rank killed and rejoined, a map
server and a live sidecar under load) on ``--device`` and prints its
evidence as one JSON line::

    run_synthetic drill --workdir drill/ --n-files 200 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["main"]


def _cmd_generate(args) -> int:
    from comapreduce_tpu_torch.synthetic.generator import (campaign_truth,
                                                           write_campaign)
    from comapreduce_tpu_torch.synthetic.scenario import load_scenario

    cfg = load_scenario(args.scenario)
    paths = write_campaign(cfg, args.out_dir)
    truth_path = os.path.join(args.out_dir, "campaign_truth.json")
    with open(truth_path, "w", encoding="utf-8") as f:
        json.dump(campaign_truth(cfg), f, indent=1, sort_keys=True)
    print(json.dumps({"scenario": cfg.name, "seed": cfg.seed,
                      "n_files": len(paths), "out_dir": args.out_dir,
                      "truth": truth_path}))
    return 0


def _cmd_transfer(args) -> int:
    from comapreduce_tpu_torch.synthetic.transfer import (check_transfer,
                                                          run_transfer)

    artifact = run_transfer(args.workdir, seed=args.seed,
                            n_bins=args.n_bins, device=args.device)
    summary = {
        "artifact": os.path.join(args.workdir, "transfer.json"),
        "seed": args.seed,
        "map_gain": [b.get("map_gain") for b in artifact["bands"]],
        "low_k_transfer": [list(b.get("transfer", [])[:2])
                           for b in artifact["bands"]],
        "quality": artifact.get("quality"),
    }
    if args.check:
        try:
            check_transfer(artifact)
        except AssertionError as exc:
            print(json.dumps({"ok": False, "criterion": str(exc),
                              **summary}))
            return 1
        summary["ok"] = True
    print(json.dumps(summary))
    return 0


def _cmd_drill(args) -> int:
    from comapreduce_tpu_torch.synthetic.loadgen import run_synthetic_drill

    try:
        evidence = run_synthetic_drill(args.workdir, seed=args.seed,
                                       n_files=args.n_files,
                                       ttl_s=args.ttl, device=args.device)
    except AssertionError as exc:
        print(json.dumps({"ok": False, "criterion": str(exc)}))
        return 1
    print(json.dumps({"ok": True, **evidence}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_synthetic",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate",
                       help="stream a scenario's Level-1 files to disk")
    g.add_argument("scenario", help="[scenario] TOML path")
    g.add_argument("--out-dir", required=True)
    g.set_defaults(fn=_cmd_generate)

    t = sub.add_parser("transfer",
                       help="end-to-end transfer-function closure")
    t.add_argument("--workdir", required=True)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--n-bins", type=int, default=6)
    t.add_argument("--check", action="store_true",
                   help="also run the closure gate (non-zero exit on "
                        "a broken criterion)")
    t.add_argument("--device", default=None,
                   help="torch device of the stages, reader and solve "
                        "(default: the card; 'cpu' runs the plain "
                        "versions)")
    t.set_defaults(fn=_cmd_transfer)

    d = sub.add_parser("drill", help="the synthetic scale drill")
    d.add_argument("--workdir", required=True)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--n-files", type=int, default=200)
    d.add_argument("--ttl", type=float, default=2.0,
                   help="lease TTL (s) for the elastic ranks")
    d.add_argument("--device", default=None,
                   help="torch device of the workers' stages and the map "
                        "server (default: the card; 'cpu' runs the plain "
                        "versions)")
    d.set_defaults(fn=_cmd_drill)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
