"""Inference/eval CLI — counterpart of ``paddlerec_tpu/tools/infer.py``.

Evaluates checkpoints saved per epoch between runner.infer_start_epoch and
runner.infer_end_epoch.  Same flags, plus ``--device`` (``cuda`` unless
``--device cpu``; without a card it raises).  Under ``tools.launch`` each
process joins the group and evaluates as one rank of the mesh, as
``tools/train.py`` trains.
"""

from __future__ import annotations

import argparse

from paddlerec_tpu_torch.core.config import load_config, parse_overrides
from paddlerec_tpu_torch.tools.train import maybe_init_distributed
from paddlerec_tpu_torch.train.trainer import Trainer, rank0_info


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="paddlerec_tpu_torch infer")
    parser.add_argument("-m", "--config_yaml", required=True)
    parser.add_argument("-o", "--opt", nargs="*", default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    args.device = maybe_init_distributed(args.device)
    config = load_config(args.config_yaml, parse_overrides(args.opt))
    trainer = Trainer(config, device=args.device)
    start = int(config.runner("infer_start_epoch", 0))
    end = int(config.runner("infer_end_epoch", 1))
    results = {}
    for epoch in range(start, end):
        rank0_info(f"load model epoch {epoch}")
        metrics = trainer.evaluate(epoch_tag=epoch)
        results[epoch] = metrics
    rank0_info(f"inference finished: {results}")
    return results


if __name__ == "__main__":
    main()
