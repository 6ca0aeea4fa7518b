"""chip_smoke.py's device timing on host-made profiler events: the union
of kernel intervals (busy_us) and the census that keeps a profiler window
only when it holds every kernel of the call (complete_windows), so a
window whose events the profiler dropped is never read as a faster call.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def event(name, start, end):
    return SimpleNamespace(name=name,
                           time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("spans, busy", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (20, 25)], 15.0),
    ([(0, 10), (5, 12)], 12.0),            # overlap counted once
    ([(5, 12), (0, 10), (1, 3)], 12.0),    # unsorted, nested
])
def test_busy_us_is_the_union_of_intervals(spans, busy):
    assert chip_smoke.busy_us(spans) == busy


def test_complete_windows_drop_windows_short_of_the_census():
    windows = [(0, 100), (200, 300), (400, 500), (600, 700)]
    events = [
        event("split", 10, 20), event("combine", 21, 25),     # complete
        event("split", 210, 222),                              # combine lost
        # window 3 lost every event
        event("combine", 630, 634), event("split", 610, 628),  # complete
        event("split", 150, 160),                              # no window
    ]
    kept = chip_smoke.complete_windows(events, windows)
    assert [sorted(ev.name for ev in evs) for evs in kept] == \
        [["combine", "split"]] * 2
    assert [chip_smoke.busy_us((ev.time_range.start, ev.time_range.end)
                               for ev in evs) for evs in kept] == [14, 22]


def test_complete_windows_count_repeated_kernels():
    """A call that launches one kernel twice is complete only with both."""
    windows = [(0, 100), (200, 300)]
    events = [event("gemm", 10, 20), event("gemm", 30, 40),
              event("gemm", 210, 220)]
    kept = chip_smoke.complete_windows(events, windows)
    assert len(kept) == 1 and len(kept[0]) == 2
