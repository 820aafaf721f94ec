"""Train CLI — counterpart of ``paddlerec_tpu/tools/train.py``.

Usage (same flags, plus ``--device``):

    python -m paddlerec_tpu_torch.tools.train -m configs/rank/deepfm/config.yaml \
        -o runner.epochs=1 runner.train_batch_size=512 [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given; without a card it raises.
``runner.use_host_table: true`` trains through the host-tiered pass loop
(``train/host_loop.py`` ``HostTableTrainer``), as the JAX CLI does.
"""

from __future__ import annotations

import argparse

from paddlerec_tpu_torch.core.config import load_config, parse_overrides
from paddlerec_tpu_torch.train.trainer import Trainer, logger


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="paddlerec_tpu_torch trainer")
    parser.add_argument("-m", "--config_yaml", required=True)
    parser.add_argument(
        "-o", "--opt", nargs="*", default=None, help="key=value config overrides"
    )
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    config = load_config(args.config_yaml, parse_overrides(args.opt))
    logger.info("config:\n" + config.pretty())
    if bool(config.runner("use_host_table", False)):
        # GPUBox-analog pass loop: host-resident table + per-pass device cache
        from paddlerec_tpu_torch.train.host_loop import HostTableTrainer

        trainer = HostTableTrainer(config, device=args.device)
    else:
        trainer = Trainer(config, device=args.device)
    metrics = trainer.train()
    logger.info(f"training finished: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
