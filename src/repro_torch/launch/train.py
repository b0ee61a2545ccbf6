"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[opts]`` (the port of ``repro.launch.train``).

The reference's flags and defaults (``--arch qwen2-0.5b --shape train_4k
--reduced true --steps 200 --seq_len 256 --batch 8``, dotted overrides
such as ``--train.learning_rate 1e-3``) and ``--device`` (default the
card; ``cpu`` runs on the CPU).  It trains on ``make_host_mesh()``: the
world ``torchrun`` started (several cards: ``torchrun --nproc_per_node N
-m repro_torch.launch.train ...``), else a one-rank world of its own --
NCCL on the card, gloo with ``--device cpu``.  Init or restore from
``--train.checkpoint_dir`` (onto this mesh, whatever mesh wrote it), the
prefetching synthetic data pipeline, async checkpoints, preemption drain
and the step watchdog.  Reduced configs train at ``--seq_len`` x
``--batch`` with ``remat="none"``; full ones at the named shape with
``remat="full"``.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from repro_torch.configs import (
        RunConfig,
        ShapeConfig,
        TrainConfig,
        apply_overrides,
        get_model_config,
        get_shape,
        parse_cli,
    )

    overrides, _ = parse_cli(argv if argv is not None else sys.argv[1:])
    arch = overrides.pop("arch", "qwen2-0.5b")
    shape_name = overrides.pop("shape", "train_4k")
    reduced = overrides.pop("reduced", "true").lower() in ("1", "true", "yes")
    steps = int(overrides.pop("steps", "200"))
    seq_len = int(overrides.pop("seq_len", "256"))
    batch = int(overrides.pop("batch", "8"))
    device = overrides.pop("device", None)

    cfg = get_model_config(arch)
    if reduced:
        cfg = cfg.reduced()
        shape = ShapeConfig(shape_name, seq_len, batch, "train")
    else:
        shape = get_shape(shape_name)

    run = RunConfig(model=cfg, shape=shape, train=TrainConfig(
        total_steps=steps, remat="none" if reduced else "full"))
    for k, v in list(overrides.items()):
        run = apply_overrides(run, {k: v})

    import torch.distributed as dist

    from repro_torch.data import DataPipeline, SyntheticLMDataset
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.trainer import Trainer

    mesh = make_host_mesh(device=device)
    trainer = Trainer(run, mesh)
    shape_of = dict(zip(mesh.mesh_dim_names, mesh.shape))
    print(f"[train] arch={arch} reduced={reduced} mesh={shape_of} "
          f"device={trainer.device} "
          f"params={trainer.ts.model.n_params() / 1e6:.1f}M")
    try:
        start = trainer.init_or_restore()
        ds = SyntheticLMDataset(vocab_size=cfg.vocab_size,
                                seq_len=shape.seq_len, seed=run.train.seed)
        pipe = DataPipeline(ds, global_batch=shape.global_batch,
                            start_step=start)
        try:
            history = trainer.fit(steps - start, iter(pipe))
        finally:
            pipe.close()
    finally:
        trainer.preempt.uninstall()
        dist.destroy_process_group()
    if history["loss"]:
        print(f"[train] loss {history['loss'][0]:.3f} -> "
              f"{history['loss'][-1]:.3f} over {len(history['loss'])} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
