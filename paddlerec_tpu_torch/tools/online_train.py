"""Online (streaming) train CLI: counterpart of
``paddlerec_tpu/tools/online_train.py`` (the reference's
static_ps_online_trainer.py).

    python -m paddlerec_tpu_torch.tools.online_train -m config.yaml \
        -o runner.start_day=20240101 runner.end_day=20240102 [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given; without a card it raises.
Under ``tools.launch`` each process joins the group first and drives one rank
of the ``(dp, mp)`` mesh (``runner.mesh_dp`` / ``runner.mesh_mp`` /
``hyper_parameters.distributed_embedding``); rank 0 publishes:

    python -m paddlerec_tpu_torch.tools.launch --nproc 4 --backend gloo -- \
        python -m paddlerec_tpu_torch.tools.online_train -m config.yaml \
        -o runner.mesh_dp=2 runner.mesh_mp=2 [--device cpu]
"""

from __future__ import annotations

import argparse

from paddlerec_tpu_torch.core.config import load_config, parse_overrides
from paddlerec_tpu_torch.tools.train import maybe_init_distributed
from paddlerec_tpu_torch.train.online import OnlineTrainer
from paddlerec_tpu_torch.train.trainer import rank0_info


def main(argv=None):
    parser = argparse.ArgumentParser(description="paddlerec_tpu_torch online trainer")
    parser.add_argument("-m", "--config_yaml", required=True)
    parser.add_argument("-o", "--opt", nargs="*", default=None,
                        help="key=value config overrides")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    args.device = maybe_init_distributed(args.device)
    config = load_config(args.config_yaml, parse_overrides(args.opt))
    trainer = OnlineTrainer(config, device=args.device)
    metrics = trainer.run()
    rank0_info(f"online training finished: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
