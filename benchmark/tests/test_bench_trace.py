"""The idle share as the complement of the union of device intervals,
on synthetic events."""

import pytest

from benchmark import trace as tr

MS = 1_000_000        # ns


def test_union_of_overlapping_and_gapped_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (22, 25), (40, 41)]
    assert tr.union_length(iv) == 15 + 10 + 1
    assert tr.union_length([]) == 0


def test_idle_gaps_inside_a_window():
    iv = [(5, 15), (10, 12), (20, 30)]
    assert tr.idle_gaps(iv, 0, 40) == [(0, 5), (15, 20), (30, 40)]
    assert tr.idle_gaps(iv, 6, 25) == [(15, 20)]
    assert tr.idle_gaps([], 0, 3) == [(0, 3)]


def test_analyse_clips_to_the_window_and_names_gaps():
    spans = [("window", 0, 100 * MS), ("observation", 0, 60 * MS),
             ("observation", 60 * MS, 100 * MS)]
    device = [("k1", -5 * MS, 10 * MS),       # clipped at the window
              ("k2", 5 * MS, 20 * MS),        # overlaps k1
              ("k1", 40 * MS, 50 * MS),
              ("Memcpy HtoD", 70 * MS, 90 * MS),
              ("late", 120 * MS, 130 * MS)]   # outside: dropped
    a = tr.analyse(device, spans)
    assert a.window_s == pytest.approx(0.1)
    assert a.busy_s == pytest.approx(0.050)
    assert a.idle_share == pytest.approx(0.5)
    assert a.kernel_seconds(("k1",)) == (2, pytest.approx(0.020))
    assert a.n_device_ops() == 4
    # gaps 20-40, 50-70 (named by the unit around its middle) and 90-100
    assert a.idle_by_span["observation"][0] == 3
    assert a.idle_by_span["observation"][1] == pytest.approx(0.050)
    b = a.breakdown()
    assert b["device_ops"][0][0] == "k1"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_analyse_needs_the_window_and_a_device_operation():
    with pytest.raises(RuntimeError):
        tr.analyse([("k", 0, 1)], [("observation", 0, 2)])
    with pytest.raises(RuntimeError):
        tr.analyse([("k", 5, 6)], [("window", 0, 2)])
