"""One run of one cell: set-up, the closed loop's window, the check, the
metrics.

Set-up draws the weights on the device from the seed, builds the engine
and the seed's request list, and starts one ``generate`` call; the window
opens when the warm-up requests (the first ``clients``) have all
completed, so every shape the cell uses has run and the slots hold the
mix's own requests at staggered stages, and lasts ``seconds``.
``setup_s`` is the process's start to the window's opening.
After the window the call runs on until every request sent inside it has
its first token, and then ends from the callback.  The engine is freed,
the peak memory read, and the sample checked against the reference.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from bench import check, port, spec, stats, traffic, weights
from bench.devtrace import DeviceTrace, busy_seconds, device_ops, \
    gap_breakdown, idle_gaps
from bench.loop import ClosedLoop, EndCall, RanDry


class NoChip(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def require_cards(n: int) -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoChip(f"the cell needs {n} CUDA card(s); this machine has "
                     f"{have}")


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        t_process: float, device: str = "cuda", control: bool = False,
        bench: Path = spec.BENCH,
        clock: Callable[[], float] = time.monotonic) -> dict:
    """One run; returns the result line's object (its ``checks`` last) and,
    under ``"_gaps"``, the check's readings (the control's too when
    ``control``) and under ``"_loop"`` the clients' record with the call's
    start.  ``clock`` stamps the clients' sends and tokens (a test gives a
    clock that ticks once a token, so the window holds the same requests
    whatever the host's speed)."""
    cell = spec.load_cell(cell_name, bench)
    cfg, mix = cell["config"], cell["mix"]
    if device == "cuda":
        require_cards(int(cell["workload"]["chips"]))
        torch.cuda.set_device(0)
    ref = spec.reference(cfg["family"], bench)
    params = weights.make(port.param_specs(cfg), seed, device)
    engine = port.Engine(cfg, mix, params, device)
    reqs = traffic.requests(mix, seed, cfg["vocab_size"], engine.chunk_tokens)
    prompts = [p for p, _ in reqs]
    max_new = [m for _, m in reqs]

    dt = DeviceTrace() if trace else None
    counted = {}

    def on_open(now):
        counted["open"] = (now, engine.counters())
        if dt is not None:
            dt.start()

    def on_close(now):
        counted["close"] = (now, engine.counters())

    if dt is not None:
        dt.arm()
    t_start = clock()
    loop = ClosedLoop(max_new, mix["clients"], mix["clients"], seconds,
                      clock=clock, on_open=on_open, on_close=on_close)
    loop.start(t_start)
    try:
        engine.generate(prompts, max_new, loop)
    except EndCall:
        pass
    else:
        raise RanDry("the call served every request before its window "
                     "closed")
    t_open, t_close = loop.t_open, loop.t_close
    if dt is not None:
        dt.stop(t_close)
    spans = engine.spans()
    pool = {"pool_pages": engine.pool_pages,
            "pool_pages_pinned_peak": pinned_peak(
                loop, [engine.engine.page.pages_for(len(p) + m + 1)
                       for p, m in reqs]),
            "page_bytes": engine.page_bytes}
    del engine
    gc.collect()
    peak = 0
    if device == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
        torch.cuda.empty_cache()

    e2e = stats.end_to_end(loop, t_open, t_close)
    pick = check.sample(loop, [len(p) for p in prompts], t_open,
                        int(mix["check_requests"]), seed)
    t_check = time.monotonic()
    gaps = check.logit_gaps(ref, params, cfg, [prompts[i] for i in pick],
                            [[t for _, t in loop.tokens[i]] for i in pick],
                            control=control)
    t_check = time.monotonic() - t_check
    checks = judge(cell["limits"], gaps["program"], gaps["mean"])
    correct = passes(checks)
    sent = loop.window_sent()

    result = {"correct": bool(correct), "attempted": len(sent),
              "failed": sum(1 for i in sent if not loop.tokens[i])}
    if trace:
        record = {
            "config": cfg, "mix": mix, "reference": ref,
            "window": (t_open, t_close), "counted": counted,
            "trace": {"t0": dt.t0, "t1": dt.t1, "events": dt.events},
            "spans": spans, "tokens": loop.tokens, "loop": loop,
            "prompt_lens": [len(p) for p in prompts], "e2e": e2e,
        }
        result["metrics"] = spec.read_metrics(cell["per_layer"], record,
                                              bench)
    else:
        result["metrics"] = {
            m["name"]: {"value": (float(t_open - t_process)
                                  if m["name"] == "setup_s"
                                  else float(e2e[m["name"]])),
                        "unit": m["unit"]}
            for m in cell["end_to_end"]}
    result["device"] = device_line(device, peak, dt)
    if dt is not None:
        result["breakdown"] = {
            "device_ops": device_ops(dt.events, dt.t0, dt.t1),
            "idle_gaps": gap_breakdown(idle_gaps(dt.events, dt.t0, dt.t1),
                                       spans)}
    result["counts"] = {k: e2e[k] for k in ("n_tokens", "n_ttft", "n_tbt")}
    result["counts"].update(preemptions=loop.preemptions,
                            compared_tokens=gaps["tokens"],
                            differ=gaps["differ"], sampled=len(pick),
                            check_s=t_check, **pool)
    if control:
        result["control_correct"] = passes(
            judge(cell["limits"], gaps["control"], gaps["control_mean"]))
    result["checks"] = checks
    result["_gaps"] = gaps
    result["_loop"] = (loop, t_start)
    return result


def judge(limits: Optional[dict], widest: float, mean: float) -> dict:
    """Each of the cell's limits beside the reading it holds: the widest
    ``logit_gap`` or the mean one (``logit_gap_mean``)."""
    readings = {"logit_gap": widest, "logit_gap_mean": mean}
    return {name: {"value": readings[name], "limit": lim["limit"]}
            for name, lim in (limits or {}).items()}


def passes(checks: dict) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"]
                                for c in checks.values())


def pinned_peak(loop, pages: list) -> int:
    """The most pages the requests in flight (sent, not yet completed) pin
    at once at their full lengths: the most the pool has to hold."""
    events = []
    for i, t in enumerate(loop.send):
        if t is not None:
            events.append((t, pages[i]))
            if loop.done[i] is not None:
                events.append((loop.done[i], -pages[i]))
    held = peak = 0
    for _, d in sorted(events, key=lambda e: (e[0], e[1])):
        held += d
        peak = max(peak, held)
    return peak


def device_line(device: str, peak: int, dt: Optional[DeviceTrace]) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": peak}
    if dt is not None:
        out["busy_s"] = busy_seconds(dt.events, dt.t0, dt.t1)
        out["window_s"] = dt.t1 - dt.t0
    return out
