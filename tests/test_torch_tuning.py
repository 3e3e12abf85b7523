"""The port's autotuner (``comapreduce_tpu_torch/tuning/``,
``cli/tune_report``) against the reference's (``comapreduce_tpu/tuning/``,
``tools/tune_report.py``) on the CPU:

- ``content_key`` byte for byte; the winners ledger read and written
  across packages (sealed lines; torn and tampered lines dropped);
- ``TuningConfig`` coercion; ``TUNING.configure`` installs the declared
  device memory;
- ``enumerate_group`` / ``validate_combo`` equal to the reference's but
  for the stated port differences (``pair_batch`` by the port's kernel
  limits, not the MXU budget; ``kernels`` ``auto`` only);
- successive halving and the paired confirmation on a fake clock: the
  same sweep records, measurement counts and winners in both packages, a
  warm second tuner taking 0 measurements;
- a reference-written ``tuning.jsonl`` consulted by both packages'
  ``plan_stage_feed_batch`` (the same feed batches) and by both
  ``run_destriper.main`` with ``[Tuning]`` (the same applied winners,
  maps within the CLI tests' tolerances); a ``kernels = xla`` winner the
  port logs and skips without raising;
- a ``plan`` winner under this process's identity sets the auto
  ``pair_batch``; one under another identity, an explicit ``pair_batch``
  or ``COMAP_PAIR_BATCH``, or no ``[tuning]`` leaves the plan as it is;
- ``control.policy``'s ``mg_block`` winner, as the reference decides;
- ``tune_report``'s summary and rendering equal to the reference tool's,
  and its selftest.

The CPU identity of both packages is ``("cpu", "cpu")``, so one
``tuning.jsonl`` keys the same winners in both.
"""

import json
import logging
import os
import sys

import pytest
import torch

import comapreduce_tpu.cli.run_destriper as ref_rd
import comapreduce_tpu.tuning as ref_tuning
import comapreduce_tpu.tuning.tuner as ref_tuner_mod
import comapreduce_tpu_torch.cli.run_destriper as port_rd
import comapreduce_tpu_torch.tuning as tuning
import comapreduce_tpu_torch.tuning.tuner as tuner_mod
from comapreduce_tpu_torch.cli import tune_report
from chip_smoke import same_plan
from test_torch_run_destriper_cli import (  # noqa: F401 (a fixture)
    _assert_maps_match, _read_maps, _write_ini, l2files)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import tune_report as ref_report  # noqa: E402

BUCKETS = [
    {"group": "plan", "N": 36864, "L": 50},
    {"L": 50, "group": "solver"},
    {"group": "stage", "F": 19, "B": 4, "C": 1024, "T": 135700,
     "n_arrays": 1},
    (1, 2, 3), 7, "b",
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def both_tuning():
    """Both packages' ``TUNING`` closed after the test."""
    yield
    tuning.TUNING.close()
    ref_tuning.TUNING.close()


def _winner(group, bucket, winner, default, **extra):
    """A winner record keyed by the CPU identity."""
    key = ref_tuning.content_key("cpu", "cpu", bucket, "",
                                 ref_tuning.SPACE_VERSION, group)
    return dict({"key": key, "group": group, "platform": "cpu",
                 "device_kind": "cpu", "bucket": bucket,
                 "space_version": ref_tuning.SPACE_VERSION,
                 "winner": winner, "default": default, "best_ms": 1.0,
                 "default_ms": 2.0, "candidates": 2, "measurements": 4},
                **extra)


def test_content_key_and_identity_match_the_reference():
    for b in BUCKETS:
        for prec, ver, group in (("", 1, ""), ("tod=f32|cgdot=f32", 1,
                                               "plan"), ("", 2, "solver")):
            assert tuning.content_key("gpu", "H100", b, prec, ver, group) \
                == ref_tuning.content_key("gpu", "H100", b, prec, ver, group)
    # insertion order of a bucket dict does not move the key
    assert tuning.content_key("cpu", "cpu", {"a": 1, "b": 2}) == \
        tuning.content_key("cpu", "cpu", {"b": 2, "a": 1})
    assert tuning.SPACE_VERSION == ref_tuning.SPACE_VERSION
    assert tuning.TUNING.identity() == ref_tuning.TUNING.identity() == \
        ("cpu", "cpu")


def test_winners_ledger_across_packages(tmp_path):
    """Records sealed by either package read back in both; a torn tail,
    a tampered line and another kind are dropped; latest wins per key."""
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    rec_a = _winner("plan", BUCKETS[0], {"pair_batch": 1},
                    {"pair_batch": 1})
    rec_b = _winner("solver", BUCKETS[1], {"mg_block": 16, "mg_smooth": 1},
                    {"mg_block": 8, "mg_smooth": 1})
    for d, mod in ((port_dir, tuning), (ref_dir, ref_tuning)):
        cache = mod.TuningCache(mod.tuning_path(str(d)))
        cache.put(dict(rec_a, winner={"pair_batch": 2}))
        cache.put(rec_a)
        cache.put(rec_b)
        with open(mod.tuning_path(str(d)), "a", encoding="utf-8") as f:
            f.write(json.dumps({"kind": "other", "key": "x"}) + "\n")
            line = json.loads(json.dumps(rec_b))
            f.write(json.dumps(dict(line, _sha256="0" * 64)) + "\n")
            f.write('{"kind": "tuning", "key": "torn')
    for d in (port_dir, ref_dir):
        got = tuning.read_tuning(str(d))
        want = ref_tuning.read_tuning(str(d))
        assert got == want and set(got) == {rec_a["key"], rec_b["key"]}
        assert got[rec_a["key"]]["winner"] == {"pair_batch": 1}
    strip = ("t", "_sha256")
    p, r = (tuning.read_tuning(str(port_dir)),
            tuning.read_tuning(str(ref_dir)))
    assert {k: {f: v for f, v in p[k].items() if f not in strip}
            for k in p} == {k: {f: v for f, v in r[k].items()
                                if f not in strip} for k in r}
    cache = tuning.TuningCache(tuning.tuning_path(str(ref_dir)))
    assert cache.get(rec_b["key"])["winner"]["mg_block"] == 16
    assert cache.get("nope") is None and (cache.hits, cache.misses) == (1, 1)


def test_tuning_config_like_the_reference(both_tuning, tmp_path):
    from comapreduce_tpu_torch.ops.reduce import device_hbm_bytes

    for value in (None, {}, {"enabled": "true"}, {"device_hbm_mb": 1024},
                  {"enabled": False, "repeats": 2, "max_candidates": 6,
                   "min_improvement": 0.1}):
        got = tuning.TuningConfig.coerce(value)
        want = ref_tuning.TuningConfig.coerce(value)
        assert {k: getattr(got, k) for k in got.KNOBS} == \
            {k: getattr(want, k) for k in want.KNOBS}
    for bad in ({"enabld": True}, {"repeats": 0}, {"device_hbm_mb": -1},
                {"min_improvement": 1.0}, {"max_candidates": 0}):
        for mod in (tuning, ref_tuning):
            with pytest.raises(ValueError):
                mod.TuningConfig.coerce(bad)
    tuning.TUNING.configure(str(tmp_path), {"device_hbm_mb": 1024})
    assert tuning.TUNING.enabled and device_hbm_bytes() == 1 << 30
    tuning.TUNING.close()
    assert not tuning.TUNING.enabled and tuning.TUNING.winner(
        "plan", BUCKETS[0]) is None


CTXS = {
    "stage_full": dict(F=19, B=4, C=1024, T=135700, S=10, L=13568,
                       hbm_bytes=80 << 30),
    "stage_small_hbm": dict(F=19, B=4, C=1024, T=135700, S=10, L=13568,
                            hbm_bytes=24 << 30),
    "solver": dict(n_samples=200_000, offset_length=50),
    "solver_short": dict(n_samples=1_000, offset_length=50),
    "plan": dict(n_samples=10_307_200, offset_length=50,
                 hbm_bytes=80 << 30),
    "plan_unconstrained": dict(),
    "plan_not_a_multiple": dict(n_samples=10_307_201, offset_length=50),
    "plan_k3_drops_8": dict(n_samples=2**31 - 16_384, offset_length=64),
    "plan_k3_drops_4": dict(n_samples=2**31 - 8_192, offset_length=64),
    "plan_k3_drops_all": dict(n_samples=2**31 - 4_096, offset_length=64),
}

#: the ``pair_batch`` values the port keeps at each plan context, and why
#: (``tuning/space.py::_valid_pair_batch``; K3's one-pass body takes
#: ``M < 2**31 - 4 096``, K4 ``M <= 2**31 - 1``)
PLAN_KEPT = {
    # the full field's band 0: every merged plan is far inside both
    # kernels' limits (the reference's 80 GiB MXU budget drops 8)
    "plan": [1, 2, 4, 8],
    # no bucket geometry: nothing to judge against
    "plan_unconstrained": [1, 2, 4, 8],
    # L does not divide N: no plan builds
    "plan_not_a_multiple": [],
    # pairs padded to 32 768 x 8 reach 2**31
    "plan_k3_drops_8": [1, 2, 4],
    # pairs padded to 16 384 x 4 reach 2**31
    "plan_k3_drops_4": [1, 2],
    # N itself is K3's limit at every site, the pair sums' padded
    # samples (8 192 a chunk) reach 2**31
    "plan_k3_drops_all": [],
}


@pytest.mark.parametrize("name", list(CTXS))
def test_enumerate_group_like_the_reference(name):
    """The same combos and filtered counts, but for the stated port
    difference: the plan group keeps the ``pair_batch`` values whose
    merged plan builds and whose layouts K3 and K4 take
    (:data:`PLAN_KEPT`), where the reference keeps those whose one-hot
    block fits its MXU budget."""
    group = name.split("_")[0]
    got = tuning.enumerate_group(group, tuning.SpaceContext(**CTXS[name]))
    want = ref_tuning.enumerate_group(
        group, ref_tuning.SpaceContext(**CTXS[name]))
    if group == "plan":
        assert got.combos == [{"pair_batch": pb} for pb in PLAN_KEPT[name]]
        assert got.invalid_filtered == 4 - len(PLAN_KEPT[name])
        for pb in (1, 2, 4, 8):
            assert tuning.validate_combo(
                "plan", {"pair_batch": pb},
                tuning.SpaceContext(**CTXS[name])) == (pb in PLAN_KEPT[name])
        if name == "plan":
            assert want.combos == [{"pair_batch": pb} for pb in (1, 2, 4)]
    else:
        assert got.combos == want.combos
        assert got.invalid_filtered == want.invalid_filtered
    if name == "stage_small_hbm":
        assert got.invalid_filtered > 0
    if name == "solver_short":
        assert got.invalid_filtered > 0


def test_kernels_values_are_the_ports():
    ctx = tuning.SpaceContext(n_samples=200_000, offset_length=50)
    ok = {"mg_block": 8, "mg_smooth": 1}
    assert tuning.validate_combo("solver", dict(ok, kernels="auto"), ctx)
    for k in ("xla", "pallas", "interpret"):
        assert not tuning.validate_combo("solver", dict(ok, kernels=k),
                                         ctx)
    # the reference, off the TPU, takes xla
    assert ref_tuning.validate_combo(
        "solver", dict(ok, kernels="xla"),
        ref_tuning.SpaceContext(n_samples=200_000, offset_length=50,
                                platform="cpu"))


class _FakeClock:
    """``time.perf_counter`` of a tuner module, advanced by the thunks."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def _sweep(mod, tuner_module, cache_dir, monkeypatch, candidates,
           costs, max_candidates=8, repeats=3):
    clock = _FakeClock()
    monkeypatch.setattr(tuner_module, "time", clock)
    # at most 2% of scheduling noise a run: inside the 5% floor
    noise = iter([0.0, 0.01, 0.02, 0.0, 0.015, 0.005] * 50)

    def build(combo):
        cost = costs[combo["mg_block"], combo["mg_smooth"]]

        def thunk():
            clock.now += cost * (1.0 + next(noise))
        return thunk

    t = mod.Tuner(mod.TuningCache(mod.tuning_path(str(cache_dir))),
                  platform="cpu", device_kind="cpu",
                  max_candidates=max_candidates, repeats=repeats)
    rec = t.tune("solver", {"group": "solver", "L": 50},
                 mod.SpaceContext(n_samples=200_000, offset_length=50),
                 build, default={"mg_block": 8, "mg_smooth": 1},
                 candidates=candidates)
    return t, rec


@pytest.mark.parametrize("case", ["winner", "noise_floor", "capped"])
def test_successive_halving_like_the_reference(tmp_path, monkeypatch,
                                               case):
    """The same grid, costs and clock noise through both tuners: the
    same record (winner, walls, candidates, measurements), and a warm
    second tuner on the same cache answers with 0 measurements. An
    invalid proposal (``mg_block`` 1) is never measured."""
    grid = [{"mg_block": b, "mg_smooth": s} for b in (8, 16, 32)
            for s in (1, 2)] + [{"mg_block": 1, "mg_smooth": 1}]
    costs = {(8, 1): 10.0, (8, 2): 12.0, (16, 1): 7.0, (16, 2): 9.0,
             (32, 1): 11.0, (32, 2): 13.0, (1, 1): 1.0}
    if case == "noise_floor":
        # the best inside the 5% floor of the default's 10.0
        costs[(16, 1)], costs[(16, 2)] = 9.9, 10.4
    kw = {"max_candidates": 3} if case == "capped" else {}
    recs = {}
    for name, mod, tm in (("port", tuning, tuner_mod),
                          ("ref", ref_tuning, ref_tuner_mod)):
        t, rec = _sweep(mod, tm, tmp_path / name, monkeypatch, grid,
                        costs, **kw)
        assert t.invalid_proposed == 1 and t.cache_misses == 1
        recs[name] = ({k: v for k, v in rec.items() if k != "t"},
                      t.measurements, t.pruned)
        warm, _ = _sweep(mod, tm, tmp_path / name, monkeypatch, grid, costs,
                         **kw)
        assert warm.measurements == 0 and warm.cache_hits == 1
        assert warm.invalid_proposed == 0
    assert recs["port"] == recs["ref"]
    rec = recs["port"][0]
    want = {"winner": {"mg_block": 16, "mg_smooth": 1},
            "noise_floor": {"mg_block": 8, "mg_smooth": 1},
            "capped": {"mg_block": 16, "mg_smooth": 1}}[case]
    assert rec["winner"] == want
    # the cap keeps the grid's first three (the default among them)
    assert rec["candidates"] == (3 if case == "capped" else 6)
    assert "mg_block=1|mg_smooth=1" not in rec["walls_ms"]


def test_reference_stage_winner_sizes_both_planners(tmp_path, both_tuning):
    """A reference-written ``stage`` winner bounds both packages'
    auto-sized feed batch (an explicit request still wins, and the
    memory fit still caps it)."""
    from comapreduce_tpu.ops.reduce import \
        plan_stage_feed_batch as ref_plan
    from comapreduce_tpu_torch.ops.reduce import plan_stage_feed_batch

    bucket = ref_tuning.stage_bucket(19, 4, 1024, 16384, 1)
    ref_tuning.TuningCache(ref_tuning.tuning_path(str(tmp_path))).put(
        _winner("stage", bucket, {"feed_batch": 4}, {"feed_batch": 19}))
    hbm = 80 << 30
    before = (plan_stage_feed_batch(19, 4, 1024, 16384, hbm_bytes=hbm),
              ref_plan(19, 4, 1024, 16384, hbm_bytes=hbm))
    tuning.TUNING.configure(str(tmp_path), {"enabled": True})
    ref_tuning.TUNING.configure(str(tmp_path), {"enabled": True})
    for args, kw in (((19, 4, 1024, 16384), {}),
                     ((19, 4, 1024, 16384), {"requested": 2}),
                     ((19, 4, 1024, 16384), {"hbm_bytes": 2 << 30}),
                     ((19, 4, 1024, 8192), {})):
        kw = dict({"hbm_bytes": hbm}, **kw)
        assert plan_stage_feed_batch(*args, **kw) == ref_plan(*args, **kw)
    assert before[0] == before[1] == 19
    assert plan_stage_feed_batch(19, 4, 1024, 16384, hbm_bytes=hbm) == 4
    assert plan_stage_feed_batch(19, 4, 1024, 16384, requested=2,
                                 hbm_bytes=hbm) == 2


def _plan_pixels():
    import numpy as np

    return np.arange(5000) % 97


def test_plan_winner_above_one_is_applied(tmp_path, both_tuning):
    """A ``plan`` winner of ``pair_batch = 4`` keyed by this process's
    identity (``("cpu", "cpu")`` here, the card's name on the card) sets
    the auto value, as the reference applies it
    (``pointing_plan.py:287-300``): the plan is the ``pair_batch = 4``
    plan byte for byte, in both packages."""
    from comapreduce_tpu.mapmaking.pointing_plan import \
        build_pointing_plan as ref_build
    from comapreduce_tpu_torch.mapmaking.pointing_plan import \
        build_pointing_plan

    pixels = _plan_pixels()
    ref_tuning.TuningCache(ref_tuning.tuning_path(str(tmp_path))).put(
        _winner("plan", ref_tuning.plan_bucket(5000, 50),
                {"pair_batch": 4}, {"pair_batch": 1}))
    tuning.TUNING.configure(str(tmp_path), {"enabled": True})
    ref_tuning.TUNING.configure(str(tmp_path), {"enabled": True})
    plan = build_pointing_plan(pixels, 97, 50)
    assert plan.pair_batch == 4
    assert same_plan(plan, build_pointing_plan(pixels, 97, 50,
                                                pair_batch=4))
    assert ref_build(pixels, 97, 50).pair_batch == 4


def test_plan_winner_of_another_identity_is_not_applied(tmp_path,
                                                        both_tuning):
    """A winner keyed by another device (the reference's TPU identity, or
    another card) never matches: the plan is the untuned one."""
    from comapreduce_tpu_torch.mapmaking.pointing_plan import \
        build_pointing_plan

    pixels = _plan_pixels()
    untuned = build_pointing_plan(pixels, 97, 50)
    cache = tuning.TuningCache(tuning.tuning_path(str(tmp_path)))
    bucket = tuning.plan_bucket(5000, 50)
    for platform, kind in (("tpu", "TPU v5 lite"),
                           ("gpu", "NVIDIA H100 80GB HBM3")):
        key = tuning.content_key(platform, kind, bucket, "",
                                 tuning.SPACE_VERSION, "plan")
        cache.put(_winner("plan", bucket, {"pair_batch": 8},
                          {"pair_batch": 1}, key=key, platform=platform,
                          device_kind=kind))
    tuning.TUNING.configure(str(tmp_path), {"enabled": True})
    assert tuning.TUNING.winner("plan", bucket) is None
    plan = build_pointing_plan(pixels, 97, 50)
    assert plan.pair_batch == 1 and same_plan(plan, untuned)


@pytest.mark.parametrize("pin", ["argument", "environment"])
def test_explicit_pair_batch_pins_over_a_plan_winner(tmp_path, both_tuning,
                                                     monkeypatch, pin):
    """``pair_batch=1`` or ``COMAP_PAIR_BATCH=1`` keeps the unmerged plan
    over a ``pair_batch = 4`` winner, as in the reference."""
    from comapreduce_tpu_torch.mapmaking.pointing_plan import \
        build_pointing_plan

    pixels = _plan_pixels()
    untuned = build_pointing_plan(pixels, 97, 50)
    tuning.TuningCache(tuning.tuning_path(str(tmp_path))).put(
        _winner("plan", tuning.plan_bucket(5000, 50), {"pair_batch": 4},
                {"pair_batch": 1}))
    tuning.TUNING.configure(str(tmp_path), {"enabled": True})
    if pin == "argument":
        plan = build_pointing_plan(pixels, 97, 50, pair_batch=1)
    else:
        monkeypatch.setenv("COMAP_PAIR_BATCH", "1")
        plan = build_pointing_plan(pixels, 97, 50)
    assert plan.pair_batch == 1 and same_plan(plan, untuned)


def test_plan_without_tuning_is_the_untuned_plan(tmp_path, both_tuning):
    """With a winners file present but no ``[tuning]`` table, the auto
    plan is byte for byte the ``pair_batch = 1`` plan, and no lookup is
    made."""
    from comapreduce_tpu_torch.mapmaking.pointing_plan import \
        build_pointing_plan

    pixels = _plan_pixels()
    cache = tuning.TuningCache(tuning.tuning_path(str(tmp_path)))
    cache.put(_winner("plan", tuning.plan_bucket(5000, 50),
                      {"pair_batch": 4}, {"pair_batch": 1}))
    tuning.TUNING.configure(str(tmp_path), {"enabled": False})
    plan = build_pointing_plan(pixels, 97, 50)
    assert plan.pair_batch == 1
    assert same_plan(plan, build_pointing_plan(pixels, 97, 50,
                                                pair_batch=1))
    assert tuning.TUNING.cache.hits == tuning.TUNING.cache.misses == 0


MG_INI = "[Destriper]\npreconditioner : multigrid\n"


@pytest.mark.parametrize("kernels", ["", "xla"])
def test_main_applies_a_reference_solver_winner(l2files, tmp_path,
                                                both_tuning, caplog,
                                                capsys, kernels):
    """``[Tuning] enabled`` over a reference-written ``solver`` winner
    (``mg_block`` 16, ``mg_smooth`` 2): both packages apply the same
    knobs and their maps agree within the CLI tests' tolerances. A
    winner that also names ``kernels = xla`` runs in the port too: the
    value is logged and skipped (the reference applies it)."""
    _, _, filelist = l2files
    win = {"mg_block": 16, "mg_smooth": 2}
    if kernels:
        win["kernels"] = kernels
    for pkg in ("port", "ref"):
        out = tmp_path / pkg
        logs = out / "logs"
        ref_tuning.TuningCache(ref_tuning.tuning_path(str(logs))).put(
            _winner("solver", ref_tuning.solver_bucket(50), win,
                    {"mg_block": 8, "mg_smooth": 1}))
        ini = _write_ini(tmp_path / f"{pkg}.ini", filelist, str(out), "",
                         MG_INI + "[Tuning]\nenabled : true\n")
        with caplog.at_level(logging.WARNING):
            assert (port_rd.main([ini, "--device=cpu"]) if pkg == "port"
                    else ref_rd.main([ini])) == 0
        tuning.TUNING.close()
        ref_tuning.TUNING.close()
    text = caplog.text
    assert text.count("applying measured winners for bucket L=50: "
                      "mg_block=16, mg_smooth=2") == 2
    if kernels:
        assert "winner kernels=xla for bucket L=50 skipped" in text
    capsys.readouterr()
    for band in (0, 1):
        name = f"co2_band{band}.fits"
        _assert_maps_match(_read_maps(str(tmp_path / "port" / name)),
                           _read_maps(str(tmp_path / "ref" / name)))


def test_policy_takes_the_mg_block_winner_like_the_reference(tmp_path,
                                                             both_tuning):
    """A registry delta escalates ``twolevel`` into multigrid with no
    ``mg_block`` configured: both policies take the cached ``solver``
    winner's block (16), not the default 8."""
    from test_torch_control import REF, PORT, _solves, _write_trace

    ref_tuning.TuningCache(ref_tuning.tuning_path(str(tmp_path))).put(
        _winner("solver", ref_tuning.solver_bucket(50),
                {"mg_block": 16, "mg_smooth": 1},
                {"mg_block": 8, "mg_smooth": 1}))
    tuning.TUNING.configure(str(tmp_path), {"enabled": True})
    ref_tuning.TUNING.configure(str(tmp_path), {"enabled": True})
    outs = []
    for m, d in ((PORT, tmp_path / "p"), (REF, tmp_path / "r")):
        d.mkdir()
        _write_trace(d, _solves("twolevel", 2, 60))
        reg = str(d / "runs.jsonl")
        with open(reg, "w", encoding="utf-8") as f:
            for _ in range(5):
                f.write(json.dumps({"kind": "perf", "metrics": {
                    "destriper_cg_iters": 20}}) + "\n")
        outs.append(m.policy.choose_solver(
            str(d), static={"preconditioner": "twolevel",
                            "offset_length": 50},
            registry_path=reg, record=False))
    assert outs[0] == outs[1]
    assert outs[0]["preconditioner"] == "multigrid"
    assert outs[0]["mg_block"] == 16


def test_tune_report_like_the_reference(tmp_path, capsys):
    """The report of one winners file equals the reference tool's, and
    the port's selftest passes."""
    cache = tuning.TuningCache(tuning.tuning_path(str(tmp_path)))
    cache.put(_winner("plan", BUCKETS[0], {"pair_batch": 1},
                      {"pair_batch": 1}))
    cache.put(_winner("solver", BUCKETS[1], {"mg_block": 16,
                                             "mg_smooth": 1},
                      {"mg_block": 8, "mg_smooth": 1}))
    records = tuning.read_tuning(str(tmp_path))
    got = tune_report.summarize_tuning(records)
    assert got == ref_report.summarize_tuning(records)
    assert tune_report.render(got) == ref_report.render(got)
    assert got["n_winners"] == 2 and got["n_tuned"] == 1
    assert tune_report.main([str(tmp_path)]) == 0
    assert tune_report.main([str(tmp_path / "none")]) == 1
    assert tune_report.main(["--selftest"]) == 0
    assert "selftest: OK" in capsys.readouterr().out


def test_chip_phase_n_rehearses_on_the_cpu(tmp_path, monkeypatch,
                                          both_tuning):
    """``chip_smoke``'s phase N on the CPU at FIELD_SMALL: N.1 on
    ``("cpu", "cpu")`` (the same bits) and the reference's hard polarized
    problem (the test module's own, under 5e-3 after 300 iterations), N.2
    twice bitwise, N.3's sweeps (the plan group over pair_batch 1, 2, 4
    and 8 at band 0's bucket, the auto plan under ``[tuning]`` the
    winner's layout, every candidate's solve the untuned one's bits; a
    warm second tuner measuring nothing) and the map-maker's
    ``[Tuning]`` consult on the pipeline test's Level-2 store."""
    import chip_smoke as cs
    from comapreduce_tpu_torch.data.synthetic import generate_level1_store
    from comapreduce_tpu_torch.fieldrun import (FIELD_SMALL, OFFSET_LENGTH,
                                                field_geometry,
                                                make_field_band)
    from comapreduce_tpu_torch.mapmaking.pointing_plan import \
        build_pointing_plan

    import numpy as np
    from test_torch_polarization import hard_problem

    monkeypatch.setattr(cs, "POL_DIR", str(tmp_path / "pol_tuning"))
    for got, want in zip(cs.pol_hard_problem(), hard_problem()):
        np.testing.assert_array_equal(got, want)
    small = cs.phase_pol_small(devices=("cpu", "cpu"))
    assert small["planned"]["iqu_destriped"] == 0.0
    assert small["hard"]["n_iter"] == 300
    assert small["hard"]["residual"] < cs.POL_HARD_BOUND == 5e-3
    geo = field_geometry(FIELD_SMALL)
    plan = build_pointing_plan(geo[0], FIELD_SMALL.nx * FIELD_SMALL.ny,
                               OFFSET_LENGTH)
    full, launches = cs.phase_pol_full(plan, geo, device="cpu")
    assert full["bitwise_rerun"] and full["n_solvable"] > 0
    band0, _ = make_field_band(FIELD_SMALL, geo, 0)
    _, store = generate_level1_store(cs.pipeline_test_params())
    runner = cs.memory_runner("cpu", run_dir=str(tmp_path / "chain"))
    lvl2 = runner._run_file("comap-0000007.hd5",
                            data=cs.level1_view(store))
    stage_log = cs.StageLog()
    port_log = logging.getLogger("comapreduce_tpu_torch")
    port_log.addHandler(stage_log)
    try:
        line = cs.phase_tuning(band0, plan, lvl2, stage_log, device="cpu",
                               n_feeds=2, n_bands=2, n_channels=32)
    finally:
        port_log.removeHandler(stage_log)
    assert line["warm"]["measurements"] == 0
    assert line["cold"]["invalid_proposed"] == 0
    assert line["warm"]["cache_hits"] == 3
    sweep = line["plan"]
    assert sorted(sweep["P_pad"]) == ["1", "2", "4", "8"]
    assert len(sweep["candidates_ms"]) == 4
    assert sweep["tuned_layout_equal"]
    assert sweep["tuned_pair_batch"] == sweep["winner"]
    assert all(sweep["solve_bits_equal"].values())
    assert line["consult"]["tuned"]["applied"]
    assert line["map_gap_of_scale"] <= line["gap_limit"]
