"""The closed loop's send times, the window opened by the warm-up's end,
its close and the wait for first tokens, on a fake clock."""

import pytest

from bench.loop import ClosedLoop, EndCall, RanDry


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def make(max_new, clients=2, warm=2, seconds=10.0):
    clock = Clock()
    events = []
    loop = ClosedLoop(max_new, clients, warm, seconds, clock=clock,
                      on_open=lambda t: events.append(("open", t)),
                      on_close=lambda t: events.append(("close", t)))
    loop.start(0.0)
    return loop, clock, events


def test_send_times_follow_completions():
    loop, clock, _ = make([2, 1, 1, 1, 5])
    assert loop.send == [0.0, 0.0, None, None, None]
    clock.t = 1.0
    loop(1, 7)                   # request 1 completes: request 2 is sent
    assert loop.send[2] == 1.0 and loop.done[1] == 1.0
    clock.t = 2.0
    loop(0, 3)
    assert loop.send[3] is None  # request 0 has 2 tokens to go
    clock.t = 3.0
    loop(0, 4)                   # the second completion sends request 3
    assert loop.send[3] == 3.0 and loop.completions == 2
    clock.t = 4.0
    loop(2, 1)
    assert loop.send[4] == 4.0
    assert loop.tokens[0] == [(2.0, 3), (3.0, 4)]


def test_preemption_drops_the_tokens_counted():
    loop, clock, _ = make([3, 3, 3])
    loop(0, 1)
    loop(0, None)
    assert loop.tokens[0] == [] and loop.preemptions == 1
    loop(0, 1)
    loop(0, 2)
    loop(0, 3)
    assert loop.send[2] == 0.0


def test_window_opens_at_the_warm_ups_end_and_waits_for_first_tokens():
    loop, clock, events = make([1, 2, 1, 1, 1, 1, 1, 1], seconds=10)
    clock.t = 4.0
    loop(0, 1)                   # one warm-up request left: still closed
    assert events == [] and loop.window_sent() == []
    clock.t = 5.0
    loop(1, 1)
    clock.t = 11.0
    loop(1, 1)                   # the last warm-up completes: it opens
    assert events == [("open", 11.0)]
    assert (loop.t_open, loop.t_close) == (11.0, 21.0)
    assert loop.window_sent() == [3]   # sent by this completion
    clock.t = 12.0
    loop(2, 1)                   # sends request 4 inside the window
    clock.t = 21.5
    loop(4, 1)                   # closed, but request 3 has no token yet
    assert events[-1] == ("close", 21.5) and loop.closed
    assert loop.window_sent() == [3, 4]
    clock.t = 22.0
    with pytest.raises(EndCall):
        loop(3, 5)               # its first token ends the call
    assert loop.window_sent() == [3, 4]


def test_running_dry_before_the_window_closes_fails():
    loop, clock, _ = make([1, 1, 1])
    clock.t = 2.0
    loop(0, 1)
    with pytest.raises(RanDry):
        loop(1, 1)


def test_pinned_peak_counts_requests_in_flight():
    from bench.harness import pinned_peak

    loop, clock, _ = make([1, 1, 1, 1])
    loop.done[0], loop.send[2] = 1.0, 1.0       # 2 takes 0's slot at 1.0
    loop.done[1], loop.send[3] = 2.0, 2.0
    assert pinned_peak(loop, [3, 5, 7, 2]) == 12     # 5 + 7 over [1, 2)
