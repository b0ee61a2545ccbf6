"""``ttft_p90_s.traced``: the 90th percentile of time to first token over
the requests sent inside the traced run's window.  A cell's window holds
too few requests (some tens) for a 90th percentile to stand as an
end-to-end metric with a bound, so it is read here, without one.  The
profiler slows the host, so it reads higher than an untraced run would.
Layer: the clients; moves ``output_tok_s`` (in a closed loop a client's
next request waits for its last one)."""

from bench.stats import percentile


def read(record):
    loop = record["loop"]
    ttft = [loop.tokens[i][0][0] - loop.send[i] for i in loop.window_sent()
            if loop.tokens[i]]
    return percentile(ttft, 90) if ttft else None
