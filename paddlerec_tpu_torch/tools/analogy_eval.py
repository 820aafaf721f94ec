"""Word-analogy evaluation of ``recall.word2vec``.

Counterpart of ``paddlerec_tpu/tools/analogy_eval.py``: for each question
(a, b, c, d), target = emb[b] - emb[a] + emb[c]; every word is ranked by its
dot product with the target against the normalized table, the three question
words left out, and the top word counts as right when it is d.  The table is
the input embedding of a checkpoint of the port (``runner.infer_load_path``,
``runner.infer_epoch`` or the last saved), read on the card unless
``--device cpu`` is given: ``target @ normed.T`` is one plain product (the
JAX package computes it in numpy, outside any kernel).

Usage:
    python -m paddlerec_tpu_torch.tools.analogy_eval -m config.yaml \
        -o runner.analogy_file=questions.txt runner.infer_load_path=output [--device cpu]

The question file holds one ``a b c d`` per line: token ids, or words when
``runner.word_id_dict_path`` maps ``word id`` per line; lines of another
length and ``:`` section headers are skipped.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from paddlerec_tpu_torch.core.config import load_config, parse_overrides, resolve_path
from paddlerec_tpu_torch.core.device import full_float32_matmul, resolve_device


def load_questions(path: str, word_to_id=None) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) != 4 or toks[0].startswith(":"):
                continue
            if word_to_id is not None:
                if any(t not in word_to_id for t in toks):
                    continue
                rows.append([word_to_id[t] for t in toks])
            else:
                rows.append([int(t) for t in toks])
    return np.asarray(rows, np.int64)


def analogy_accuracy(emb: torch.Tensor, questions: np.ndarray, batch: int = 1024) -> float:
    """Top-1 accuracy with a, b and c left out, over the whole vocabulary, on
    the table's device."""
    normed = emb / torch.clamp(torch.linalg.norm(emb, dim=1, keepdim=True), min=1e-12)
    q_all = torch.from_numpy(questions).to(emb.device)
    correct = 0
    for lo in range(0, len(questions), batch):
        q = q_all[lo:lo + batch]
        a, b, c, d = (q[:, i] for i in range(4))
        dist = (emb[b] - emb[a] + emb[c]) @ normed.T  # (B, V)
        rows = torch.arange(len(q), device=emb.device)
        for ex in (a, b, c):
            dist[rows, ex] = -float("inf")
        correct += int((dist.argmax(dim=1) == d).sum())
    return correct / max(len(questions), 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description="word2vec analogy eval")
    ap.add_argument("-m", "--config_yaml", required=True)
    ap.add_argument("-o", "--opt", nargs="*", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    config = load_config(args.config_yaml, parse_overrides(args.opt))
    device = resolve_device(args.device)
    full_float32_matmul()

    from paddlerec_tpu_torch.core.registry import load_model_def
    from paddlerec_tpu_torch.train import checkpoint as ckpt_lib

    model_def = load_model_def(config)
    root = resolve_path(config, "runner.infer_load_path", "output")
    tag = config.runner("infer_epoch")
    if tag is None:
        tag = ckpt_lib.last_saved_tag(root)
    state = ckpt_lib.load_params_from_state(root, tag)
    emb = model_def.embedding_table(state).to(device=device, dtype=torch.float32)

    word_to_id = None
    dict_path = resolve_path(config, "runner.word_id_dict_path")
    if dict_path:
        word_to_id = {}
        with open(dict_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    word_to_id[parts[0]] = int(parts[1])
    qfile = resolve_path(config, "runner.analogy_file")
    if not qfile:
        raise SystemExit("runner.analogy_file is required")
    questions = load_questions(qfile, word_to_id)
    acc = analogy_accuracy(emb, questions)
    out = {"analogy_acc": round(acc, 5), "questions": int(len(questions)),
           "checkpoint": f"{root}/{tag}", "device": str(device)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
