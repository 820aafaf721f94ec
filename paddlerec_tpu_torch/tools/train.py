"""Train CLI — counterpart of ``paddlerec_tpu/tools/train.py``.

Usage (same flags, plus ``--device``):

    python -m paddlerec_tpu_torch.tools.train -m configs/rank/deepfm/config.yaml \
        -o runner.epochs=1 runner.train_batch_size=512 [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given; without a card it raises.
``runner.use_host_table: true`` trains through the host-tiered pass loop
(``train/host_loop.py`` ``HostTableTrainer``), and ``runner.sync_mode: fl``
through the federated rounds (``train/fl.py`` ``FLTrainer``), as the JAX CLI
does.

Under ``tools.launch`` (``WORLD_SIZE`` > 1) each process joins the group
first (``maybe_init_distributed``) and drives one rank of the ``(dp, mp)``
mesh of ``runner.mesh_dp`` / ``runner.mesh_mp`` /
``hyper_parameters.distributed_embedding``:

    python -m paddlerec_tpu_torch.tools.launch --nproc 4 --backend gloo -- \
        python -m paddlerec_tpu_torch.tools.train -m configs/rank/deepfm/config.yaml \
        -o runner.mesh_dp=2 runner.mesh_mp=2 [--device cpu]

Geo and FL take one process a worker, each on its own file shard:

    python -m paddlerec_tpu_torch.tools.launch --nproc 2 --backend gloo -- \
        python -m paddlerec_tpu_torch.tools.train -m configs/rank/deepfm/config.yaml \
        -o runner.sync_mode=geo runner.geo_k_steps=4 [--device cpu]
    ... -o runner.sync_mode=fl runner.fl_rounds=2 runner.fl_client_fraction=0.5
"""

from __future__ import annotations

import argparse

from paddlerec_tpu_torch.core.config import load_config, parse_overrides
from paddlerec_tpu_torch.train.trainer import Trainer, rank0_info


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="paddlerec_tpu_torch trainer")
    parser.add_argument("-m", "--config_yaml", required=True)
    parser.add_argument(
        "-o", "--opt", nargs="*", default=None, help="key=value config overrides"
    )
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def maybe_init_distributed(device=None):
    """Join the process group when launched by ``tools/launch`` (the
    counterpart of the JAX CLI's ``jax.distributed.initialize``).  Returns
    the rank's device (``device`` as ``init_from_env`` takes it), or
    ``device`` itself when this process is not a rank of a launch."""
    import torch.distributed as dist

    from paddlerec_tpu_torch.tools.launch import init_from_env, launched

    if launched() and not dist.is_initialized():
        return init_from_env(device)
    return device


def main(argv=None):
    args = parse_args(argv)
    args.device = maybe_init_distributed(args.device)
    config = load_config(args.config_yaml, parse_overrides(args.opt))
    rank0_info("config:\n" + config.pretty())
    if bool(config.runner("use_host_table", False)):
        # GPUBox-analog pass loop: host-resident table + per-pass device cache
        from paddlerec_tpu_torch.train.host_loop import HostTableTrainer

        trainer = HostTableTrainer(config, device=args.device)
    elif str(config.runner("sync_mode", "") or "").lower() == "fl":
        # federated rounds over private per-process shards (FL-PS analog)
        from paddlerec_tpu_torch.train.fl import FLTrainer

        trainer = FLTrainer(config, device=args.device)
    else:
        trainer = Trainer(config, device=args.device)
    metrics = trainer.train()
    rank0_info(f"training finished: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
