"""The generator: the same seed gives the same requests, another seed other
prompts of the same sizes; every stretch of requests serves nearly the
same sizes."""

import json
import math
from pathlib import Path

import numpy as np
import pytest

from bench import traffic

MIXES = {name: json.loads((Path(__file__).resolve().parents[1] / "traffic"
                           / f"{name}.json").read_text())
         for name in ("chat", "longdoc")}
MIX = MIXES["chat"]


def loguniform_mean(spec):
    lo, hi = spec["min"], spec["max"]
    return (hi - lo) / math.log(hi / lo)


def test_same_seed_same_requests():
    a = traffic.requests(MIX, 2**31 + 77, 1000, 96)
    b = traffic.requests(MIX, 2**31 + 77, 1000, 96)
    assert all((p == q).all() and m == n for (p, m), (q, n) in zip(a, b))
    c = traffic.requests(MIX, 2**31 + 78, 1000, 96)
    assert [(len(p), m) for p, m in a] == [(len(p), m) for p, m in c]
    assert any((p != q).any() for (p, _), (q, _) in zip(a, c))


@pytest.mark.parametrize("name", sorted(MIXES))
def test_warm_up_then_the_mix(name):
    mix = MIXES[name]
    reqs = traffic.requests(mix, 5, 1000, 96)
    clients, longest = mix["clients"], mix["output_tokens"]["max"]
    assert len(reqs) == mix["requests"]
    assert [len(p) for p, _ in reqs[:clients]] == [96] * clients
    assert [m for _, m in reqs[:clients]] == [
        max(1, round(longest * (i + 1) / clients)) for i in range(clients)]
    rest = reqs[clients:]
    assert min(len(p) for p, _ in rest) >= mix["prompt_tokens"]["min"]
    assert max(len(p) for p, _ in rest) <= mix["prompt_tokens"]["max"]
    assert all(mix["output_tokens"]["min"] <= m <= longest for _, m in rest)
    assert all(p.dtype == np.int32 and p.max() < 1000 for p, _ in reqs)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_medians_are_the_sources(name):
    """Each mix's lengths are drawn around the medians its source
    publishes, which its ``source`` names."""
    mix = MIXES[name]
    published = {"chat": (1020, 129), "longdoc": (1500, 13)}[name]
    for spec, median in zip((mix["prompt_tokens"], mix["output_tokens"]),
                            published):
        assert math.sqrt(spec["min"] * spec["max"]) == \
            pytest.approx(median, rel=0.01)
        assert str(f"{median:,}") in mix["source"]


@pytest.mark.parametrize("name", sorted(MIXES))
def test_every_stretch_serves_nearly_the_same_sizes(name):
    mix = MIXES[name]
    prompt, out = [], []
    for seed in (1, 2**31 + 5, 2**33 + 1):
        reqs = traffic.requests(mix, seed, 1000, 96)[mix["clients"]:]
        for lo in range(0, 200, 40):
            prompt.append(np.mean([len(p) for p, _ in reqs[lo:lo + 40]]))
            out.append(np.mean([m for _, m in reqs[lo:lo + 40]]))
    p_mean = loguniform_mean(mix["prompt_tokens"])
    o_mean = loguniform_mean(mix["output_tokens"])
    assert 0.92 < min(prompt) / p_mean and max(prompt) / p_mean < 1.08
    assert 0.92 < min(out) / o_mean and max(out) / o_mean < 1.08
