"""JTM CLI — counterpart of ``paddlerec_tpu/tools/jtm.py``: alternating
tree-model learning, one command for the whole loop (train TDM under the
current tree, re-learn the tree, repeat).

Usage (same flags, plus ``--device``):

    python -m paddlerec_tpu_torch.tools.jtm -m configs/treebased/jtm/config.yaml \
        -o runner.jtm_rounds=3 hyper_parameters.jtm_gap=7 [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given; without a card it raises.
Each round's tree is saved as ``<model_save_path>/jtm_tree_round<r>.npz``.
"""

from __future__ import annotations

import argparse
import sys

from paddlerec_tpu_torch.core.config import load_config, parse_overrides
from paddlerec_tpu_torch.train.trainer import logger


def main(argv=None):
    parser = argparse.ArgumentParser(description="JTM trainer")
    parser.add_argument("-m", "--config_yaml", required=True)
    parser.add_argument("-o", "--opt", nargs="*", default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    config = load_config(args.config_yaml, parse_overrides(args.opt))
    from paddlerec_tpu_torch.models.treebased.jtm import jtm_train

    metrics, tree = jtm_train(config, device=args.device)
    logger.info(
        f"JTM finished: {metrics}; final tree depth {tree.max_level}"
    )
    return metrics


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
