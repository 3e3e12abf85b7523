"""The HBM planner half of the port's ``ops/reduce.py`` against the
reference's (``comapreduce_tpu/ops/reduce.py:168-485``): the same inputs
and the same declared capacity give the same answer — the estimate, the
scan streaming ``plan_reduce_memory`` picks (or the ``ValueError`` it
raises, message included), the stage feed batches, ``ShapeBuckets`` and
the two pad helpers — over a grid of shapes and capacities. Beside them,
``device_hbm_bytes``' precedence (``COMAP_HBM_BYTES``, the declared
override, the warned CPU default) in both packages.
"""

import itertools
import logging

import numpy as np
import pytest

from comapreduce_tpu.ops import reduce as ref
from comapreduce_tpu_torch.convert import shape_buckets_from_reference
from comapreduce_tpu_torch.ops import reduce as port

GiB = 1 << 30
SHAPES = [  # (B, C, T, n_scans, L): production, a short obs, tests
    (4, 1024, 136_216, 10, 13_568), (4, 1024, 60_000, 4, 13_568),
    (4, 512, 50_000, 7, 6_400), (2, 32, 2_700, 3, 640),
]
CAPACITIES = [2 * GiB, 16 * GiB, 40 * GiB, 80 * GiB]


def _same_outcome(f_port, f_ref):
    try:
        want = f_ref()
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            f_port()
        assert str(got.value).split(" (stage option")[0] == \
            str(err).split(" (stage option")[0]
        return None
    assert f_port() == want
    return want


@pytest.mark.parametrize("shape", SHAPES)
def test_estimate_and_plan_match_reference(shape):
    B, C, T, S, L = shape
    outcomes = 0
    for fb, sb, dense, hbm in itertools.product(
            (1, 2, 4, 19), (None, 1, 3, 5, 10), (False, True), CAPACITIES):
        assert port.estimate_reduce_hbm(fb, B, C, T, S, L, sb, dense) == \
            ref.estimate_reduce_hbm(fb, B, C, T, S, L, sb, dense)
        for scale in (1, 4):
            outcomes += _same_outcome(
                lambda: port.plan_reduce_memory(
                    fb, B, C, T, S, L, sb, hbm_bytes=hbm, dense_mask=dense,
                    suggest_scale=scale),
                lambda: ref.plan_reduce_memory(
                    fb, B, C, T, S, L, sb, hbm_bytes=hbm, dense_mask=dense,
                    suggest_scale=scale)) is None
    assert outcomes < 2 * 4 * 5 * 2 * 4      # not every case raises


@pytest.mark.parametrize("shape", SHAPES)
def test_stage_feed_batches_match_reference(shape):
    B, C, T, _, _ = shape
    for F, req, n_arrays, hbm in itertools.product(
            (1, 2, 19), (0, 1, 2, 5, 40), (1, 2), CAPACITIES):
        assert port.plan_stage_feed_batch(
            F, B, C, T, requested=req, n_arrays=n_arrays, hbm_bytes=hbm) == \
            ref.plan_stage_feed_batch(F, B, C, T, requested=req,
                                      n_arrays=n_arrays, hbm_bytes=hbm)
        assert port.stage_feed_batches(F, B, C, T, req, n_arrays, hbm) == \
            ref.stage_feed_batches(F, B, C, T, req, n_arrays, hbm)


@pytest.mark.parametrize("quanta", [(0, 0, 0), (4096, 0, 0), (0, 4, 0),
                                    (0, 0, 1024), (1000, 3, 256)])
def test_shape_buckets_match_reference(quanta):
    rb = ref.ShapeBuckets(*quanta)
    pb = port.ShapeBuckets(*quanta)
    assert shape_buckets_from_reference(rb) == pb
    assert pb.enabled == rb.enabled and repr(pb) == repr(rb)
    assert hash(pb) == hash(port.ShapeBuckets(*quanta))
    for T, S, L in ((136_216, 10, 13_568), (2_700, 3, 640), (1, 1, 1),
                    (0, 0, 0), (4096, 4, 1024)):
        assert pb.canonical(T, S, L) == rb.canonical(T, S, L)
        assert pb.overhead_bound(T, S, L) == rb.overhead_bound(T, S, L)
    d = dict(zip(("t_quantum", "scan_quantum", "l_quantum"), quanta))
    assert port.ShapeBuckets.coerce(d) == pb
    assert port.ShapeBuckets.coerce(None) == port.ShapeBuckets()
    with pytest.raises(ValueError):
        port.ShapeBuckets.coerce({"t_quanta": 1})
    with pytest.raises(TypeError):
        port.ShapeBuckets.coerce(3)


def test_pad_helpers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 17)).astype(np.float32)
    for n_to, fill in itertools.product((10, 17, 20, 33),
                                        ("nan", "edge", "zero")):
        got = port.pad_time_axis(x, n_to, fill)
        want = ref.pad_time_axis(x, n_to, fill)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    starts = np.array([5, 40, 90], np.int64)
    lengths = np.array([30, 30, 25], np.int32)
    for n_to in (2, 3, 5):
        for g, w in zip(port.pad_scan_geometry(starts, lengths, n_to),
                        ref.pad_scan_geometry(starts, lengths, n_to)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_device_hbm_bytes_precedence(monkeypatch, caplog):
    monkeypatch.delenv("COMAP_HBM_BYTES", raising=False)
    for mod in (port, ref):
        mod.set_device_hbm_override(0)
    # the CPU reports no memory: the warned 16 GiB default
    monkeypatch.setattr(port, "_HBM_DEFAULT_WARNED", False)
    with caplog.at_level(logging.WARNING, logger="comapreduce_tpu_torch"):
        assert port.device_hbm_bytes(device="cpu") == 16 * GiB
        assert port.device_hbm_bytes(device="cpu") == 16 * GiB
    assert sum("16 GiB" in r.getMessage() for r in caplog.records) == 1
    assert ref.device_hbm_bytes() == 16 * GiB
    try:
        for mod in (port, ref):
            mod.set_device_hbm_override(3 * GiB)
        assert port.device_hbm_bytes(device="cpu") == \
            ref.device_hbm_bytes() == 3 * GiB
        monkeypatch.setenv("COMAP_HBM_BYTES", str(5 * GiB))
        assert port.device_hbm_bytes(device="cpu") == \
            ref.device_hbm_bytes() == 5 * GiB
        # the planners read the same capacity when none is passed
        args = (2, 4, 1024, 136_216, 10, 13_568, None)
        assert _same_outcome(lambda: port.plan_reduce_memory(*args),
                             lambda: ref.plan_reduce_memory(*args)) is None
    finally:
        for mod in (port, ref):
            mod.set_device_hbm_override(0)
