"""A whole run of each tiny cell on the CPU (the harness without its look
for a card): sound, it comes out correct; with the timed path broken
underneath it, ``correct`` comes out false, once for each fault a serving
cell can have.  And the control -- the reference in float8 -- reads above
the limit that sound runs keep under (the tiny cells compare the mean
gap: ``conftest.TINY_LIMITS``)."""

import time

import pytest
import torch

from bench import harness

CELLS = ["deepseek-v2-236b-l8.tiny", "mixtral-8x7b-l16.tiny"]
SECONDS = 3.0


class TokenClock:
    """A clock that advances ``step`` seconds each time it is read: the
    closed loop reads it once a token, so a tiny cell's window holds the
    same requests however fast the host runs."""

    def __init__(self, step: float = 0.01):
        self.t, self.step = 0.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def altered_token(monkeypatch):
    """A token altered where it is produced: the sampler's pick shifted."""
    import repro_torch.serve.engine as engine

    sample = engine.sample
    monkeypatch.setattr(engine, "sample", lambda logits, cfg, gen:
                        (sample(logits, cfg, gen) + 1) % logits.shape[-1])


def state_unchanged(monkeypatch):
    """A step that leaves its state unchanged: the paged blocks attend but
    never write their new keys and values (or latent rows) into the
    pool."""
    import repro_torch.models.layers as layers
    import repro_torch.models.mla as mla
    from repro_torch.kernels.paged_attention import paged_attention

    def attend_only(q, k, v, k_pool, v_pool, layer, page_ids, off, table,
                    lengths, window, t):
        return paged_attention(q.contiguous(), k_pool[layer], v_pool[layer],
                               table, lengths, window=window, page_tokens=t)

    monkeypatch.setattr(layers, "pool_write_attend", attend_only)
    monkeypatch.setattr(mla, "pool_write_attend", attend_only)


def half_the_batch(monkeypatch):
    """Half of the batch left out: the routed experts' outputs reach only
    the first half of the rows they serve."""
    import repro_torch.models.moe as moe

    combine = moe._combine

    def half(out_buf, top_i, top_v, keep, slot):
        y = combine(out_buf, top_i, top_v, keep, slot)
        rows = y.shape[0] * y.shape[1]
        flat = y.reshape(rows, -1).clone()
        flat[rows // 2:] = 0
        return flat.reshape(y.shape)

    monkeypatch.setattr(moe, "_combine", half)


FAULTS = [altered_token, state_unchanged, half_the_batch]


def run(tiny, cell, seed=2**31 + 11, control=False):
    return harness.run(cell, seed, SECONDS, False, time.monotonic(),
                       device="cpu", control=control, bench=tiny,
                       clock=TokenClock())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    r = run(tiny, cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["counts"]["preemptions"] == 0
    c = r["counts"]
    assert 0 < c["pool_pages_pinned_peak"] <= c["pool_pages"]
    assert [k for k in r if not k.startswith("_")][-1] == "checks"


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny, cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run(tiny, cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(tiny, cell):
    for seed in (3, 2**31 + 5, 2**32 + 9):
        r = run(tiny, cell, seed, control=True)
        limit = r["checks"]["logit_gap_mean"]["limit"]
        assert r["_gaps"]["mean"] <= limit < r["_gaps"]["control_mean"]
        assert r["correct"] and r["control_correct"] is False
