"""Each configuration file's ``port`` block runs what its published keys
say, and the cuts weigh what the files say."""

import json
import math
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
CONFIGS = sorted((BENCH / "configs").glob("*.json"))

#: (published key, port key) pairs that both name one number.
SAME = [("hidden_size", "d_model"), ("num_attention_heads", "n_heads"),
        ("num_key_value_heads", "n_kv_heads"), ("vocab_size", "vocab_size"),
        ("num_hidden_layers", "n_layers"), ("rope_theta", "rope_theta"),
        ("rms_norm_eps", "norm_eps"), ("head_dim", "d_head"),
        ("kv_lora_rank", "mla.kv_lora_rank"),
        ("q_lora_rank", "mla.q_lora_rank"),
        ("qk_rope_head_dim", "mla.rope_head_dim"),
        ("qk_nope_head_dim", "mla.nope_head_dim"),
        ("v_head_dim", "mla.v_head_dim"),
        ("n_routed_experts", "moe.n_experts"),
        ("num_local_experts", "moe.n_experts"),
        ("num_experts_per_tok", "moe.top_k"),
        ("n_shared_experts", "moe.n_shared_experts"),
        ("moe_intermediate_size", "moe.d_ff_expert"),
        ("first_k_dense_replace", "moe.first_k_dense")]


def port_value(port, key):
    for k in key.split("."):
        if not isinstance(port, dict) or k not in port:
            return None
        port = port[k]
    return port


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_port_block_matches_the_published_keys(path):
    cfg = json.loads(path.read_text())
    port = cfg["port"]
    assert port["family"] == cfg["family"]
    assert set(cfg["reduced"]) <= set(cfg) and cfg["name"] == path.stem
    for pub, key in SAME:
        got = port_value(port, key)
        if pub in cfg and got is not None:
            assert got == cfg[pub], (pub, key)
    window = cfg.get("sliding_window") or 0
    assert port.get("sliding_window", 0) == window


@pytest.mark.parametrize("name,params", [("deepseek-v2-236b-l8", 29.19e9),
                                         ("mixtral-8x7b-l16", 23.48e9)])
def test_cut_sizes(name, params):
    from bench import port

    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    n = sum(math.prod(s[0]) for s in port.param_specs(cfg).values())
    assert n == pytest.approx(params, rel=5e-4)
