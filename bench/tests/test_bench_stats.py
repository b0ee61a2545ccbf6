"""Percentiles and the window's end-to-end metrics, against hand-worked
values."""

import numpy as np
import pytest

from bench.stats import end_to_end, percentile


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 100])
def test_percentile_is_numpys_linear(q):
    rng = np.random.default_rng(3)
    v = rng.exponential(size=37).tolist()
    assert percentile(v, q) == pytest.approx(float(np.percentile(v, q)))


def test_percentile_by_hand():
    assert percentile([4, 1, 3, 2], 50) == 2.5
    assert percentile([1, 2, 3, 4, 5], 90) == pytest.approx(4.6)


class Loop:
    def __init__(self, send, tokens):
        self.send, self.tokens = send, tokens


def test_end_to_end_counts_only_the_window():
    loop = Loop(send=[0.0, 10.5, 11.0, 19.5],
                tokens=[[(9.0, 1), (10.0, 1), (10.2, 1)],
                        [(11.5, 1), (12.0, 1), (20.5, 1)],
                        [(13.0, 1)],
                        [(21.0, 1)]])
    m = end_to_end(loop, 10.0, 20.0)
    # inside: 10.0, 10.2, 11.5, 12.0, 13.0 -> 5 tokens in 10 s
    assert m["output_tok_s"] == 0.5
    # sent inside: requests 1, 2, 3 -> TTFT 1.0, 2.0, 1.5
    assert m["n_ttft"] == 3 and m["ttft_p50_s"] == 1.5
    # gaps with both tokens inside: 0.2 and 0.5
    assert m["n_tbt"] == 2
    assert m["tbt_p95_ms"] == pytest.approx(485.0)
