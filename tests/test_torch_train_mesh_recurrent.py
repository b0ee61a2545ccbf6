"""The port's sharded training forward and step for the recurrent
families against the JAX package's, on 4 ranks in float32 (the runs and
the tolerance rule are in ``tests/torch_mesh_parity.py``).

For reduced xlstm-1.3b (the cells on each data rank's batch rows) and
zamba2-1.2b (Mamba2 blocks and the shared attention): the training
forward under gspmd, ring and serpentine rules on a (1, 4) mesh at 2e-4,
and one ``make_train_step`` step on (2, 2) against the reference's step
on a (2, 2) host mesh.
"""

import pytest

import torch_mesh_parity as M

ARCHS = ["xlstm-1.3b", "zamba2-1.2b"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return M.run(tmp_path_factory.mktemp("train_mesh_recurrent"), ARCHS)


@pytest.mark.parametrize("mode", ["gspmd", "ring", "serpentine"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_on_1x4_matches_reference(results, arch, mode):
    M.same_forward(*results, arch, mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_on_2x2_matches_reference(results, arch):
    ranks, ref = results
    M.same_step(ranks[0], ref, arch)
    assert str(ranks[0][f"{arch}/step/collectives"]) == "gspmd"
