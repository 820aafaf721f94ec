"""FL-PS: federated training over private per-process shards, the port of
``paddlerec_tpu/train/fl.py``.

The reference's FL mode (tools/static_fl_trainer.py) runs workers wrapped in
an ``FLClient`` that registers its example count, servers that hold the
parameters, and a coordinator that picks, each round, the clients that pull
the parameters, train locally and push their updates, weighted by their
example counts.  Here the roles collapse into the processes of one launch
(``tools/launch.py``), on the geo rendezvous of ``train/trainer.py``:

  * every process is one client training its own file shard on a mesh of its
    own (no collective inside its local epochs);
  * the coordinator's choice is a seeded Bernoulli draw that every process
    computes alike (``runner.fl_client_fraction``; ``RandomState(seed·9973 +
    round)``), so no strategy call is needed; at least one client is chosen;
  * aggregation is FedAvg: base += Σ_k (n_k/Σn)·Δ_k over the clients' diffs,
    n_k the examples client k trained this round; the tables ship their
    touched rows only, as in geo;
  * a client with no data, or one not chosen, joins the rendezvous with zero
    examples and weight 0, so the collective sequence never diverges.

Config::

    runner:
      sync_mode: fl
      fl_rounds: 10            # federated rounds
      fl_local_epochs: 1       # local epochs of a chosen client a round
      fl_client_fraction: 1.0  # the coordinator's share of clients a round
"""

from __future__ import annotations

import collections
import time
from typing import Dict

import numpy as np

from paddlerec_tpu_torch.core.config import Config, resolve_path
from paddlerec_tpu_torch.train.trainer import Trainer, rank0_info


class FLTrainer(Trainer):
    """FedAvg over private per-process data shards.  ``device`` as
    ``Trainer``'s."""

    def __init__(self, config: Config, model_def=None, device=None):
        # the geo rendezvous: a local mesh a process, lazy Adam, touched-row
        # bookkeeping, the weighted _geo_sync
        config["runner.sync_mode"] = "geo"
        if config.runner("geo_k_steps") is None:
            config["runner.geo_k_steps"] = 1
        super().__init__(config, model_def=model_def, device=device)
        if self.world <= 1:
            raise ValueError(
                "sync_mode: fl needs >1 process (each process is one federated "
                "client with a private data shard); launch with tools/launch "
                "and torch.distributed")
        self.rounds = int(config.runner("fl_rounds", 10))
        self.local_epochs = int(config.runner("fl_local_epochs", 1))
        self.client_fraction = float(config.runner("fl_client_fraction", 1.0))
        self.seed = int(config.runner("seed", 2023))

    def plan(self, rnd: int) -> np.ndarray:
        """The coordinator's choice of clients for round ``rnd`` (a bool a
        process): a seeded draw every process computes alike."""
        if self.client_fraction >= 1.0:
            return np.ones(self.world, bool)
        draws = np.random.RandomState(self.seed * 9973 + rnd).rand(self.world)
        chosen = draws < self.client_fraction
        if not chosen.any():  # the coordinator never idles a whole round
            chosen[int(np.argmin(draws))] = True
        return chosen

    def _selected(self, rnd: int) -> bool:
        return bool(self.plan(rnd)[self.rank])

    def train(self) -> Dict[str, float]:
        cfg = self.config
        batch_size = int(cfg.runner("train_batch_size", 32))
        data_dir = resolve_path(cfg, "runner.train_data_dir")
        save_path = resolve_path(cfg, "runner.model_save_path")
        if self.state is None:
            self.init_state()
        if self._geo_base is None:
            self._init_geo_state()
        dataset = self.make_dataset(data_dir, batch_size,
                                    shuffle=bool(cfg.runner("shuffle_files", False)))
        last_metrics: Dict[str, float] = {}
        for rnd in range(self.rounds):
            t0 = time.time()
            local_examples = 0
            metric_state = self._init_metric_state()
            if self._selected(rnd):
                self._geo_pending_rows = collections.deque()
                for _ in range(self.local_epochs):
                    for batch in self._device_batches(self._geo_observing(dataset),
                                                      augment=True):
                        self._geo_mark_consumed()
                        metric_state, _ = self.train_step(batch, metric_state)
                        local_examples += self._batch_rows(batch)
                self._sync()
            # the FedAvg rendezvous: weights are this round's example counts
            counts = self._all_gather_np(np.asarray([local_examples], np.int64)).reshape(-1)
            total = int(counts.sum())
            weights = (counts / total if total else np.zeros_like(counts, np.float32))
            weights = weights.astype(np.float32)
            self._geo_sync(counts, weights=weights)
            merged = self._geo_merge_metrics(metric_state)
            last_metrics = self._compute_metrics(merged) if self.use_auc else {}
            plan = " ".join(f"c{k}:{int(n)}" for k, n in enumerate(counts))
            rank0_info(f"[fl round {rnd}] coordinator plan {plan} | "
                       + (self._bundle_str(last_metrics, "train") if self.use_auc else "")
                       + f" | {time.time() - t0:.2f} s")
        if save_path:
            path = self.save_checkpoint(save_path, "fl_final")
            rank0_info(f"saved FL model to {path}")
        last_metrics["rounds"] = float(self.rounds)
        return last_metrics
