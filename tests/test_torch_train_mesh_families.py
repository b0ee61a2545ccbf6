"""The port's sharded training forward and step for the MoE and enc-dec
families against the JAX package's, on 4 ranks in float32 (the runs and
the tolerance rule are in ``tests/torch_mesh_parity.py``).

For reduced mixtral-8x7b (MoE: expert parallelism on the model axis, the
load-balancing term) and whisper-large-v3 (enc-dec: the encoder, the
fused cross-attention K/V): the training forward under gspmd, ring and
serpentine rules on a (1, 4) mesh at 2e-4, and one ``make_train_step``
step on (2, 2) against the reference's step on a (2, 2) host mesh.
"""

import pytest

import torch_mesh_parity as M

ARCHS = ["mixtral-8x7b", "whisper-large-v3"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return M.run(tmp_path_factory.mktemp("train_mesh_families"), ARCHS)


@pytest.mark.parametrize("mode", ["gspmd", "ring", "serpentine"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_on_1x4_matches_reference(results, arch, mode):
    M.same_forward(*results, arch, mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_on_2x2_matches_reference(results, arch):
    ranks, ref = results
    M.same_step(ranks[0], ref, arch)
    assert str(ranks[0][f"{arch}/step/collectives"]) == "gspmd"
