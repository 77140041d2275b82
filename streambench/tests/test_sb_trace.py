"""The traced window's attribution and busy time on hand-made events."""
import tiny  # noqa: F401
from harness.trace import SPAN, Event, TraceData


def ev(name, cpu, start, end, corr=0, linked=0, thread=1):
    return Event(name, cpu, float(start), float(end), corr, linked, thread)


def test_activities_follow_their_launching_op():
    events = [
        ev(SPAN, True, 0, 100, corr=1), ev(SPAN, True, 100, 300, corr=2),
        ev("aten::add", True, 10, 20, corr=3),
        ev("aten::item", True, 150, 290, corr=4),
        # A kernel launched in iteration 0 runs while iteration 1 waits.
        ev("add_kernel", False, 120, 180, corr=90, linked=3),
        # A library's launch with no host op around it: found by its
        # runtime call, which shares its correlation id: iteration 1.
        ev("cudaLaunchKernel", True, 160, 161, corr=91),
        ev("fold_claim", False, 200, 210, corr=91, linked=0),
        ev("Memcpy DtoH", False, 280, 285, corr=92, linked=4),
        ev(SPAN, False, 100, 300),            # the span's range on the card
        ev("ProfilerStep#2", False, 0, 300),
        ev("orphan", False, 5, 6, corr=93, linked=77),
    ]
    t = TraceData.from_events(events, ["ingest", "emission"], [7, 8],
                              [None, 1])
    ingest, emission = t.iterations
    assert [e[0] for e in ingest.events] == ["add_kernel"]
    assert [e[0] for e in emission.events] == ["fold_claim", "Memcpy DtoH"]
    assert t.unattributed == 1
    assert t.window_us == 300 and t.busy_us == 60 + 10 + 5
    busy, wall = t.busy_in(t.select("emission"))
    assert (busy, wall) == (75, 200)
    assert t.launches(t.select("emission"), ("fold_",)) == 1
    assert t.device_us(t.select("emission"), ("Memcpy",)) == 5
    assert dict(t.device_ops)["add_kernel"] == 60e-6
    gaps = dict(t.idle_gaps)
    # 0-120 idle: the first 20 us in iteration 0, 120 us in all.
    assert abs(sum(gaps.values()) - (300 - 75) / 1e6) < 1e-12
    assert any(k.startswith("emission: aten::item") for k in gaps)
