"""The clients' side of a closed loop over one ``generate`` call.

The engine serves one fixed request list per call and admits FIFO into
freed slots, so a closed loop of ``clients`` clients is one call over the
whole list: the first ``clients`` requests are sent when the call starts,
and request ``k >= clients`` is sent when the ``(k - clients + 1)``-th
request completes, the moment its client gets its last token and the slot
it held frees.  ``ClosedLoop`` is the call's ``on_token`` callback: it
stamps every token on the host clock and keeps the send times.  The
window opens when the first ``warm`` requests have all completed -- a
point of the engine's schedule, which the sizes alone fix, so every run
opens it at the same stage of the loop whatever the host's speed -- and
closes ``seconds`` later.  Once it has closed and every request sent
inside it has its first token, the callback ends the call by raising
``EndCall``.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional, Tuple


class EndCall(Exception):
    """Raised from the callback to end the call once the window is done."""


class RanDry(RuntimeError):
    """The request list ran out before the window closed."""


class ClosedLoop:
    """``on_token(i, tok)`` of one call over ``max_new`` requests (the
    output length of each, in submission order).

    The window opens when requests ``0 .. warm - 1`` have all completed and
    lasts ``seconds`` on ``clock``; ``on_open`` is called with the opening
    time from that callback, ``on_close`` from the first callback at or
    after the close.  ``tok is None`` is a recompute preemption: the
    request's tokens so far are dropped (they will be delivered again) and
    counted in ``preemptions``."""

    def __init__(self, max_new: List[int], clients: int, warm: int,
                 seconds: float, clock: Callable[[], float] = time.monotonic,
                 on_open: Optional[Callable[[float], None]] = None,
                 on_close: Optional[Callable[[float], None]] = None):
        self.max_new = [int(m) for m in max_new]
        self.clients, self.warm = int(clients), int(warm)
        self.seconds = float(seconds)
        self.t_open = self.t_close = math.inf
        self.warm_left = self.warm
        self.clock = clock
        self.on_open, self.on_close = on_open, on_close
        n = len(self.max_new)
        self.send: List[Optional[float]] = [None] * n
        self.tokens: List[List[Tuple[float, int]]] = [[] for _ in range(n)]
        self.done: List[Optional[float]] = [None] * n
        self.completions = 0
        self.preemptions = 0
        self.opened = self.closed = False

    def start(self, t0: float) -> None:
        """The call starts at ``t0``: the first ``clients`` are sent."""
        for i in range(min(self.clients, len(self.send))):
            self.send[i] = t0

    def window_sent(self) -> List[int]:
        """The requests sent inside the window."""
        return [i for i, t in enumerate(self.send)
                if t is not None and self.t_open <= t < self.t_close]

    def __call__(self, i: int, tok: Optional[int]) -> None:
        now = self.clock()
        if tok is None:
            self.tokens[i].clear()
            self.preemptions += 1
        else:
            self.tokens[i].append((now, int(tok)))
            if len(self.tokens[i]) == self.max_new[i]:
                self.done[i] = now
                self.completions += 1
                k = self.completions + self.clients - 1
                if k < len(self.send):
                    self.send[k] = now
                elif now < self.t_close:
                    raise RanDry(f"all {len(self.send)} requests were sent "
                                 f"before the window closed")
                if i < self.warm:
                    self.warm_left -= 1
        if not self.opened and self.warm_left == 0:
            self.opened = True
            self.t_open, self.t_close = now, now + self.seconds
            if self.on_open is not None:
                self.on_open(now)
        if now >= self.t_close:
            if not self.closed:
                self.closed = True
                if self.on_close is not None:
                    self.on_close(now)
            if all(self.tokens[j] for j in self.window_sent()):
                raise EndCall
