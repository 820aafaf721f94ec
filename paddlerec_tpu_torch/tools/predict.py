"""Batch inference from an exported artifact, with a latency report.

Counterpart of ``paddlerec_tpu/tools/predict.py``: load the artifact (its
parameters go to the device once), stream batches through ``infer_forward``
(the model's own reader where it has one, ``make_dataset``; slot text
otherwise), drop mask-padded tail rows from the outputs, and report
avg/p50/p90/p99 latency and qps over the full batches after the warm-up.
A batch's time runs from the forward to the predictions on the host, after
``torch.cuda.synchronize()``.  The predictions are the aux's
``predictions``, or else the first of ``probs``, ``scores``, ``ctr``,
``outputs`` (deeprec's reconstruction) and ``sim_pos``, as the JAX tool
picks them; a model with none of these (bert4rec's accuracy flags) writes
nothing and its batches are only timed.

Usage:
    python -m paddlerec_tpu_torch.tools.predict --export_dir exported_model \
        --data_dir data/sample_data/train --batch_size 512 [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from paddlerec_tpu_torch.core.device import resolve_device, to_tensors
from paddlerec_tpu_torch.data.schema import schema_from_config
from paddlerec_tpu_torch.data.slot_reader import SlotDataset, list_data_files
from paddlerec_tpu_torch.tools.export import load_exported

logger = logging.getLogger("paddlerec_tpu_torch")

# the aux keys a model's predictions go under, in the order they are tried
PREDICTION_KEYS = ("predictions", "probs", "scores", "ctr", "outputs", "sim_pos")


def run_predict(export_dir: str, data_dir: str, batch_size: int,
                warmup: int = 1, device=None):
    """Returns (outputs, report): one predictions array per batch, padded
    tail rows dropped, and the latency report (empty if no batch was
    timed)."""
    device = resolve_device(device)
    model_def, module = load_exported(export_dir, device)
    if hasattr(model_def, "make_dataset"):
        dataset = model_def.make_dataset(data_dir, batch_size)
    else:
        dataset = SlotDataset(
            list_data_files(data_dir), schema_from_config(model_def.config),
            batch_size, drop_last=False,
        )

    latencies = []
    total = 0
    outputs = []
    for i, host_batch in enumerate(dataset):
        batch = to_tensors(host_batch, device)
        t0 = time.perf_counter()
        with model_def.infer_context(torch.inference_mode):
            aux = model_def.infer_forward(module, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        preds = next((aux[k] for k in PREDICTION_KEYS if k in aux), None)
        arr = None if preds is None else preds.cpu().numpy()
        elapsed = time.perf_counter() - t0
        if arr is not None:
            if "mask" in host_batch:
                # drop mask-padded tail rows so prediction lines align 1:1
                # with input instances
                mask = host_batch["mask"].reshape(-1) > 0
                if arr.shape[0] == mask.shape[0]:
                    arr = arr[mask]
            outputs.append(arr)
        rows = int(host_batch["mask"].sum()) if "mask" in host_batch else batch_size
        full = (host_batch["label"].shape[0] if "label" in host_batch
                else rows) == batch_size
        if i >= warmup and full:
            latencies.append(elapsed)
            total += rows  # only timed rows count toward qps

    report = {}
    if latencies:
        lat = np.array(latencies) * 1000
        report = {
            "batches": len(latencies),
            "avg_ms": float(lat.mean()),
            "p50_ms": float(np.percentile(lat, 50)),
            "p90_ms": float(np.percentile(lat, 90)),
            "p99_ms": float(np.percentile(lat, 99)),
            "qps": total / max(sum(latencies), 1e-9),
        }
        logger.info(
            "inference benchmark (%s): %s", device,
            ", ".join(f"{k}={v:.2f}" for k, v in report.items()),
        )
    return outputs, report


def main(argv=None):
    parser = argparse.ArgumentParser(description="batch predict")
    parser.add_argument("--export_dir", required=True)
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--batch_size", type=int, default=512)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run_predict(args.export_dir, args.data_dir, args.batch_size,
                device=args.device)


if __name__ == "__main__":
    main()
