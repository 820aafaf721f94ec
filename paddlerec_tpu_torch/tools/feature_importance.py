"""Feature importance by slot shuffling: the AUC drop per sparse slot group.

The port of ``paddlerec_tpu/tools/feature_importance.py``: a baseline eval
AUC, then for each group of sparse slots that slot's values permuted across
the rows of every batch and the eval re-run; the AUC drop is the group's
importance.  The permutation of a batch is ``RandomState(seed).permutation``
drawn in the same order as the JAX tool draws it, so the same checkpoint
and rows give the same baseline and the same deltas.

    python -m paddlerec_tpu_torch.tools.feature_importance -m config.yaml \
        -o runner.model_init_path=output_model_deepfm/2 \
        --shuffled_slots 1,2 3 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Sequence

import numpy as np

from paddlerec_tpu_torch.core.config import load_config, parse_overrides, resolve_path
from paddlerec_tpu_torch.core.device import to_tensors
from paddlerec_tpu_torch.train.trainer import Trainer, logger


def evaluate_with_shuffle(trainer: Trainer, data_dir: str, batch_size: int,
                          shuffle_slots: Sequence[int], seed: int = 0) -> float:
    """Eval AUC with the given sparse slot indices permuted across rows."""
    rng = np.random.RandomState(seed)
    metric_state = trainer._init_metric_state()
    dataset = trainer.make_dataset(data_dir, batch_size, drop_last=False)
    for batch in dataset:
        if shuffle_slots:
            sparse = batch["sparse"].copy()
            perm = rng.permutation(len(sparse))
            for s in shuffle_slots:
                sparse[:, s] = sparse[perm, s]
            batch = dict(batch, sparse=sparse)
        metric_state, _ = trainer.infer_step(to_tensors(batch, trainer.device),
                                             metric_state)
    metrics = trainer._compute_metrics(metric_state)
    if metrics.get("total_ins", 0) == 0:
        logger.warning(
            "evaluated ZERO instances — check test_data_dir/batch_size "
            "(AUC defaults to 0.5 on an empty eval)"
        )
    return metrics["auc"]


def run(config, shuffled_slot_groups: List[List[int]], device=None) -> Dict[str, float]:
    trainer = Trainer(config, device=device)
    trainer.init_state()
    init_path = resolve_path(config, "runner.model_init_path")
    if not init_path:
        # accept the infer-tool convention too
        load_root = resolve_path(config, "runner.infer_load_path")
        epoch = config.runner("infer_start_epoch")
        if load_root and epoch is not None:
            init_path = os.path.join(load_root, str(epoch))
    if init_path:
        trainer.load_checkpoint(
            os.path.dirname(init_path), os.path.basename(init_path),
            params_only=True,
        )
    else:
        logger.warning(
            "no runner.model_init_path / infer_load_path set — measuring "
            "importance on UNTRAINED params (all deltas will be ~0)"
        )
    data_dir = resolve_path(config, "runner.test_data_dir")
    batch_size = int(config.runner("infer_batch_size", 512))

    base_auc = evaluate_with_shuffle(trainer, data_dir, batch_size, [])
    logger.info(f"baseline auc: {base_auc:.6f}")
    result = {"baseline": base_auc}
    for group in shuffled_slot_groups:
        auc = evaluate_with_shuffle(trainer, data_dir, batch_size, group)
        delta = base_auc - auc
        key = ",".join(map(str, group))
        result[key] = delta
        logger.info(
            f"slots [{key}] shuffled: auc {auc:.6f}, importance {delta:+.6f}"
        )
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description="slot-shuffle feature importance")
    parser.add_argument("-m", "--config_yaml", required=True)
    parser.add_argument("-o", "--opt", nargs="*", default=None)
    parser.add_argument(
        "--shuffled_slots", nargs="*", default=None,
        help="slot index groups, e.g. '1,2 3' (default: each slot alone)",
    )
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    config = load_config(args.config_yaml, parse_overrides(args.opt))
    if args.shuffled_slots:
        groups = [[int(s) for s in g.split(",")] for g in args.shuffled_slots]
    else:
        n = int(config.hyper("sparse_inputs_slots", 27)) - 1
        groups = [[i] for i in range(n)]
    return run(config, groups, device=args.device)


if __name__ == "__main__":
    main()
