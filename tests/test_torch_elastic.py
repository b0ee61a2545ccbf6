"""Training on a device mesh over time (``repro_torch.launch.trainer``'s
``Trainer`` on a ``DeviceMesh``, ``ckpt`` across meshes, the train CLI
under ``torchrun``), on reduced llama3.2-1b on the CPU.

One 4-rank gloo world of spawned processes (``launch.mesh.spawn_world``,
a ``FileStore`` under the test's temporary directory, a 240 s timeout):

  * ``init_train_state`` on a (2, 2) mesh: the one-device init's values,
    each rank's local tensors owning their shards alone;
  * 40 serpentine steps on a (2, 2) mesh: the loss falls by more than 0.5,
    as in the reference's mesh test (``tests/test_dist.py``);
  * elastic restore: a (4, 1) ``Trainer`` checkpoints at step 2, and a
    (2, 2) ``Trainer`` on the same directory resumes at step 2 with every
    leaf of the parameters and optimizer state equal, on its own
    placements;
  * a preemption signal that reaches rank 1 alone, during the 4th step:
    every rank stops after it (the ranks agree on the flag) and the final
    checkpoint of step 4 is on disk for all of them when ``fit`` returns;
  * a relaunch whose ranks see different checkpoints (rank 0 alone has
    one): every rank raises rather than restore.

Beside it, the CLI: ``torchrun --standalone --nproc_per_node 2`` of
``repro_torch.launch.train --device cpu``, a (2, 1) gloo mesh.
"""

import os
import subprocess
import sys

import pytest

import torch_dist_workers as W
from repro_torch.launch.mesh import spawn_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1"}
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
         "--arch", "llama3.2-1b", "--steps", "3", "--seq_len", "16",
         "--batch", "4", "--train.checkpoint_dir", str(tmp / "cli_ckpt"),
         "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = spawn_world(W.loop_world, 4, str(tmp / "store"),
                            (str(tmp / "ckpt"),), timeout_s=240)
        cli_out, _ = cli.communicate(timeout=240)
    finally:
        if cli.poll() is None:
            cli.kill()
    return ranks, (cli.returncode, cli_out)


def test_sharded_init_holds_the_one_device_values_shard_by_shard(results):
    for r in results[0]:
        assert float(r["init/err"]) == 0.0
        assert bool(r["init/owned"])
        assert int(r["init/sharded"]) > 0


def test_loss_falls_over_40_steps_on_2x2(results):
    losses = results[0][0]["losses"]
    assert losses[-1] < losses[0] - 0.5, losses[::8]


def test_elastic_restore_from_4x1_onto_2x2(results):
    for r in results[0]:
        assert int(r["restore/step"]) == 2
        assert float(r["restore/err"]) == 0.0
    # The restored leaf carries the (2, 2) mesh's placements: wq's heads
    # (dim 2 of the stacked (L, d, H * D)) over "model".
    assert str(results[0][0]["restore/placements"]) == \
        "(Replicate(), Shard(dim=2))"


def test_preemption_on_one_rank_stops_every_rank(results):
    for r in results[0]:
        assert int(r["preempt/step"]) == 4
        assert int(r["preempt/saved"]) == 4


def test_restore_refused_when_ranks_see_different_checkpoints(results):
    for r in results[0]:
        err = str(r["disagree/error"])
        assert "the ranks see different checkpoints" in err, err
        assert "[4, None, None, None]" in err, err


def test_train_cli_under_torchrun_on_cpu(results):
    rc, out = results[1]
    assert rc == 0, out
    assert "mesh={'data': 2, 'model': 1}" in out, out
    assert "[train] loss" in out, out
