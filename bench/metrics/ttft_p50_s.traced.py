"""``ttft_p50_s.traced``: the median time to first token over the requests
sent inside the traced run's window.  Between processes the host's speed
differs by some tenths, and the median of some tens of requests swings
further than any bound allows, so it is read here, without one.  The
profiler slows the host, so it reads higher than an untraced run would.
Layer: the clients; moves ``output_tok_s`` (in a closed loop a client's
next request waits for its last one)."""

from bench.stats import percentile


def read(record):
    loop = record["loop"]
    ttft = [loop.tokens[i][0][0] - loop.send[i] for i in loop.window_sent()
            if loop.tokens[i]]
    return percentile(ttft, 50) if ttft else None
