"""CPU tests of the readers of the program's ranges (``portbench.spans``) on
small recorded traces: which ranges count, the idle that no range covers, and
the reading with no range of the program in the trace."""
from __future__ import annotations

import pytest

from portbench import catalog, devtrace, spans

KERNEL = "void (anonymous namespace)::walk_tile<4, ((anonymous namespace)::Walk)0, true>(...)"
COPY = "Memcpy HtoD (Pageable -> Device)"


def recorded(host=()):
    """The card busy at 100-700, 1100-1400 and 2100-2700 us of a 3,000 us
    window, so idle at 0-100, 700-1100, 1400-2100 and 2700-3000 (1,500 us);
    ``host`` adds ``(name, start_us, dur_us)`` annotations."""
    chrome = [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW, "ts": 0.0, "dur": 3000.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": COPY, "ts": 100.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": KERNEL, "ts": 300.0, "dur": 400.0},
        {"ph": "X", "cat": "kernel", "name": KERNEL, "ts": 1100.0, "dur": 300.0},
        {"ph": "X", "cat": "kernel", "name": KERNEL, "ts": 2100.0, "dur": 600.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::argmax", "ts": 800.0, "dur": 250.0},
    ]
    chrome += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s, "dur": d}
               for n, s, d in host]
    dev, host_events = devtrace.split_events(chrome)
    return {"device_events": dev, "host_events": host_events, "trace_window": (0.0, 3000.0),
            "t0": 10.0, "t1": 10.003, "batches": [65536, 20, 65536], "stuck": 0,
            "requests": [(10.0, 10.001, 65536, True), (10.001, 10.0015, 20, True),
                         (10.002, 10.003, 65536, True)]}


def unspanned(rec):
    return catalog.reader("device.idle_unspanned").read(rec, {})


def test_ranges_keep_the_programs_own_inside_the_window():
    rec = recorded([("gateway.cache_probe", 750.0, 100.0), ("plan.shard", -50.0, 100.0),
                    ("backend.keys", 2900.0, 500.0), ("custom.stage", 10.0, 5.0),
                    ("batcher.scatter", 3100.0, 5.0)])
    assert [r[0] for r in spans.ranges(rec)] == ["gateway.cache_probe", "backend.keys"]
    assert spans.ranges({"trace_window": (0.0, 1.0)}) == []


@pytest.mark.parametrize("intervals,want", [
    ([], []),
    ([(5, 6), (1, 2)], [(1, 2), (5, 6)]),
    ([(1, 4), (2, 3)], [(1, 4)]),
    ([(1, 3), (2, 5), (5, 7), (8, 9)], [(1, 7), (8, 9)]),
])
def test_union_merges_overlapping_intervals(intervals, want):
    assert spans.union(intervals) == want


def test_idle_unspanned_reads_the_idle_no_range_covers():
    # 100 us of the gap at 700-1100 under the probe; the stitch on one thread
    # (1300-1600) and the backend's copy on another (1500-1800) overlap each
    # other and the gap at 1400-2100 only in part: 400 us of it covered
    rec = recorded([("gateway.cache_probe", 750.0, 100.0), ("gateway.stitch", 1300.0, 300.0),
                    ("backend.rows_in", 1500.0, 300.0)])
    assert unspanned(rec) == pytest.approx(100 * (1500 - 100 - 400) / 3000)


@pytest.mark.parametrize("host,idle_us", [
    ([("plan.shard", 0.0, 3000.0)], 0.0),  # a range open over the whole window
    ([("engine.pad", 300.0, 300.0)], 1500.0),  # open only while the card is busy
    ([("batcher.assemble", 50.0, 2000.0), ("batcher.scatter", 60.0, 10.0)], 400.0),
    ([("gateway.batch", 2750.0, 1000.0)], 1250.0),  # past the window's end
])
def test_idle_unspanned_cases(host, idle_us):
    assert unspanned(recorded(host)) == pytest.approx(100 * idle_us / 3000)


def test_idle_unspanned_with_no_program_range_reads_as_device_idle():
    rec = recorded([("aten::copy_", 750.0, 100.0)])
    assert unspanned(rec) == pytest.approx(100 * 1500 / 3000)
    assert unspanned(rec) == pytest.approx(catalog.reader("device.idle").read(rec, {}))


def test_idle_unspanned_with_nothing_on_the_card_is_the_window_less_the_ranges():
    rec = recorded([("gateway.stitch", 750.0, 100.0)])
    rec["device_events"] = []
    assert unspanned(rec) == pytest.approx(100 * (3000 - 100) / 3000)


def test_idle_unspanned_without_a_trace_reads_nothing():
    assert unspanned({"requests": [], "t0": 0.0, "t1": 1.0}) is None
