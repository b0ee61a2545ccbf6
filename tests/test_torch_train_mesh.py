"""The port's tensor-parallel training over a device mesh
(``repro_torch.launch.trainer`` on a ``DeviceMesh``, ``dist.sharding``'s
placements, the rings in the model) against the JAX package's, on 4 ranks
of reduced llama3.2-1b in float32 (the runs and the tolerance rule are in
``tests/torch_mesh_parity.py``):

  * the training forward under gspmd, ring and serpentine rules on a
    (1, 4) mesh, held to the reference's forward at 2e-4;
  * one ``make_train_step`` step on (2, 2), held to the reference's step
    on a (2, 2) host mesh (a tiny model: the planner replicates it);
  * one step on (2, 2) under rules both packages plan against one shrunk
    HBM: FSDP, the embedding sharded over "data", and the serpentine rings
    that ``collectives="auto"`` takes then.

The other families are in ``tests/test_torch_train_mesh_families.py`` and
``tests/test_torch_train_mesh_recurrent.py``; the loop on a mesh, elastic
restore and the CLI under ``torchrun`` in ``tests/test_torch_elastic.py``.
"""

import numpy as np
import pytest

import torch_mesh_parity as M

ARCH = "llama3.2-1b"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return M.run(tmp_path_factory.mktemp("train_mesh"), [ARCH], fsdp=ARCH)


@pytest.mark.parametrize("mode", ["gspmd", "ring", "serpentine"])
def test_forward_on_1x4_matches_reference(results, mode):
    M.same_forward(*results, ARCH, mode)


def test_ring_and_serpentine_forward_equal_gspmd(results):
    ranks, _ = results
    for mode in ("ring", "serpentine"):
        np.testing.assert_allclose(ranks[0][f"{ARCH}/forward/{mode}"],
                                   ranks[0][f"{ARCH}/forward/gspmd"],
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("part", ["metrics", "moments", "params"])
def test_sharded_step_on_2x2_matches_reference(results, part):
    ranks, ref = results
    M.same_step(ranks[0], ref, ARCH, part)
    if part == "metrics":
        assert not bool(ranks[0][f"{ARCH}/step/fsdp"])   # a tiny model
        assert str(ranks[0][f"{ARCH}/step/collectives"]) == "gspmd"


def test_fsdp_step_on_2x2_matches_reference(results):
    ranks, ref = results
    got = ranks[0]
    assert bool(ref["fsdp/ref/fsdp"]) and bool(got["fsdp/step/fsdp"])
    assert str(ref["fsdp/ref/embed_rule"]) == "data"
    assert "Shard(dim=0)" in str(got["fsdp/embed_placements"])
    assert str(got["fsdp/step/collectives"]) == "serpentine"
    M.same_step(got, ref, "fsdp")
