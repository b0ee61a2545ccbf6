"""Each family's plain reference held to the port's CPU path at a tiny
configuration of that family: the port's forward (dropless MoE) in
float32 on the benchmark's own weights gives the reference's logits."""

import json

import pytest
import torch

from bench import port, spec, weights


@pytest.mark.parametrize("name", ["deepseek-v2-236b-l8", "mixtral-8x7b-l16"])
def test_reference_matches_the_port(tiny, name):
    from repro_torch.models.model import Model

    cfg = json.loads((tiny / "configs" / f"{name}.json").read_text())
    ref = spec.reference(cfg["family"], tiny)
    params = weights.make(port.param_specs(cfg), 7, "cpu", torch.float32)
    model = Model(port.model_config(cfg))
    model.capacity_factor = None            # dropless, as the reference
    g = torch.Generator().manual_seed(1)
    seqs = [torch.randint(0, cfg["vocab_size"], (n,), generator=g)
            for n in (9, 23)]
    hidden = ref.final_hidden(params, cfg, seqs)
    for s, h in zip(seqs, hidden):
        with torch.no_grad():
            want, _ = model.forward(params, {"tokens": s[None]},
                                    dtype=torch.float32)
        got = h @ ref.head(params, cfg).float()
        assert got.shape == want[0].shape
        torch.testing.assert_close(got, want[0], rtol=1e-4, atol=1e-4)
