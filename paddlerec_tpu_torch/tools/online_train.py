"""Online (streaming) train CLI: counterpart of
``paddlerec_tpu/tools/online_train.py`` (the reference's
static_ps_online_trainer.py).

    python -m paddlerec_tpu_torch.tools.online_train -m config.yaml \
        -o runner.start_day=20240101 runner.end_day=20240102 [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import argparse

from paddlerec_tpu_torch.core.config import load_config, parse_overrides
from paddlerec_tpu_torch.train.online import OnlineTrainer
from paddlerec_tpu_torch.train.trainer import logger


def main(argv=None):
    parser = argparse.ArgumentParser(description="paddlerec_tpu_torch online trainer")
    parser.add_argument("-m", "--config_yaml", required=True)
    parser.add_argument("-o", "--opt", nargs="*", default=None,
                        help="key=value config overrides")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    config = load_config(args.config_yaml, parse_overrides(args.opt))
    trainer = OnlineTrainer(config, device=args.device)
    metrics = trainer.run()
    logger.info(f"online training finished: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
