"""``mfu`` and the roofline shares against small cases worked by hand."""

import importlib
import types

import pytest

from bench import spec
from bench.work import HBM_BYTES_PER_S, PEAK_BF16_FLOPS, model_calls


def record(cfg, events=(), arithmetic=None):
    """Request 0: a 4-token prompt in one chunk, then two decode ticks;
    request 1 (6 prompt tokens) got its first token before the window."""
    return {
        "config": cfg,
        "reference": types.SimpleNamespace(arithmetic=arithmetic),
        "prompt_lens": [4, 6],
        "spans": [
            {"name": "prefill_chunk", "start": 0.1, "end": 0.2,
             "args": {"done": 0, "tokens": 4}},
            {"name": "decode_tick", "start": 0.3, "end": 0.4, "args": {}},
            {"name": "decode_tick", "start": 0.5, "end": 0.6, "args": {}},
            {"name": "request", "start": 0.0, "end": 1.0, "args": {}},
        ],
        "tokens": [[(0.25, 9), (0.45, 9), (0.65, 9)],
                   [(0.05, 9), (0.45, 9), (0.65, 9)]],
        "trace": {"t0": 0.0, "t1": 1.0, "events": list(events)},
    }


def test_model_calls():
    calls = model_calls(record({}), 0.0, 1.0)
    assert sorted((c["kind"], c["contexts"], c["heads"]) for c in calls) == [
        ("chunk", [1, 2, 3, 4], 1), ("decode", [5, 7], 2),
        ("decode", [6, 8], 2)]
    assert [c["kind"] for c in model_calls(record({}), 0.35, 1.0)] == \
        ["decode"]


def test_mfu():
    a = {"token": 1e12, "head": 1e11, "context": 1e9}
    r = record({}, arithmetic=lambda cfg: a)
    flops = (4e12 + 1e11 + 10e9) + (2e12 + 2e11 + 12e9) \
        + (2e12 + 2e11 + 14e9)
    got = spec.metric_reader("mfu")(r)
    assert got == pytest.approx(100 * flops / PEAK_BF16_FLOPS)


def test_mla_roofline():
    cfg = {"num_attention_heads": 2, "kv_lora_rank": 4,
           "qk_rope_head_dim": 2, "num_hidden_layers": 3}
    ev = [("paged_mla_kernel(x)", 0.30, 0.30 + 1e-9),
          ("other", 0.3, 0.5)]
    r = record(cfg, ev)
    # D = 6 (the latent row), Dv = 4, H = 2: bytes (rows read x D + tokens
    # x H x (D + Dv)) x 2 and operations 2 x H x (D + Dv) x context.
    # chunk: 2 (4 x 6 + 4 x 20) = 208 B, 400 ops; ticks: 12 and 14 rows
    # read: 224 B, 480 ops and 248 B, 560 ops.  All bound by bytes.
    least = (208 + 224 + 248) / HBM_BYTES_PER_S
    got = spec.metric_reader("paged_attention_roofline.mla")(r)
    assert got == pytest.approx(100 * 3 * least / 1e-9, rel=1e-6)
    assert spec.metric_reader("paged_attention_roofline.split")(r) is None


def test_split_roofline():
    cfg = {"num_attention_heads": 64, "num_key_value_heads": 1,
           "head_dim": 256, "num_hidden_layers": 1}
    ev = [("void paged_split_kernel<bf16>(y)", 0.3, 0.3 + 1e-6),
          ("paged_combine_kernel(z)", 0.4, 0.4 + 1e-6)]
    r = record(cfg, ev)
    # A key's K and V: 2 x G x D = 512 values; a token's q and out: 2 x H x
    # D = 32,768; 2 x H x 2 x D = 65,536 operations a key.  Bytes (x 2):
    # chunk 4 new rows and 4 tokens, the ticks 12 and 14 rows read for 2.
    calls = [(2 * (4 * 512 + 4 * 32768), 65536 * 10),
             (2 * (12 * 512 + 2 * 32768), 65536 * 12),
             (2 * (14 * 512 + 2 * 32768), 65536 * 14)]
    least = sum(max(b / HBM_BYTES_PER_S, o / PEAK_BF16_FLOPS)
                for b, o in calls)
    got = spec.metric_reader("paged_attention_roofline.split")(r)
    assert got == pytest.approx(100 * least / 2e-6, rel=1e-6)


def test_counter_and_span_readers():
    r = record({})
    r["counted"] = {"open": (0.0, {"decode_steps": 10, "slot_steps": 320,
                                   "active_slot_steps": 300}),
                    "close": (2.0, {"decode_steps": 30, "slot_steps": 960,
                                    "active_slot_steps": 780})}
    assert spec.metric_reader("tick_ms")(r) == pytest.approx(100.0)
    assert spec.metric_reader("slot_occupancy")(r) == pytest.approx(0.75)
    assert spec.metric_reader("chunk_enqueue_ms")(r) == pytest.approx(100.0)
    r["trace"]["events"] = [("k", 0.0, 0.25), ("k", 0.5, 0.75)]
    assert spec.metric_reader("device_idle_share")(r) == pytest.approx(50.0)


def test_arithmetic_of_the_deepseek_cut():
    cfg = spec.load_cell("deepseek-v2-236b-l8.longdoc")["config"]
    a = importlib.import_module("bench.reference.mla_moe").arithmetic(cfg)
    # attention 149,225,472; the dense FFN 188,743,680; a MoE layer's
    # router, 6 routed and 2 shared experts 189,562,880 (parameters).
    assert a["token"] == 2 * (8 * 149_225_472 + 188_743_680
                              + 7 * 189_562_880)
    assert a["head"] == 2 * 5120 * 102400
    assert a["context"] == 2 * 8 * 128 * (128 + 64 + 128)


def _ttft_loop():
    from bench.loop import ClosedLoop

    loop = ClosedLoop([1] * 12, 1, 1, 10.0)
    loop.start(0.0)
    loop.t_open, loop.t_close = 10.0, 20.0
    for i in range(11):
        loop.send[i + 1] = 10.0 + i * 0.5            # 11 sent inside
        loop.tokens[i + 1] = [(loop.send[i + 1] + 0.1 * (i + 1), 5)]
    return {"loop": loop, "window": (10.0, 20.0)}


def test_traced_ttft_p90():
    got = spec.metric_reader("ttft_p90_s.traced")(_ttft_loop())
    assert got == pytest.approx(1.0)                 # TTFTs 0.1 .. 1.1


def test_traced_ttft_p50():
    got = spec.metric_reader("ttft_p50_s.traced")(_ttft_loop())
    assert got == pytest.approx(0.6)
