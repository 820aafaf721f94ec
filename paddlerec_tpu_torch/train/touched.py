"""Per-table touched-row mapping: a copy of ``paddlerec_tpu/train/touched.py``
(numpy only).

Maps a host batch onto the physical rows of each embedding table, keyed by
the table's flax-form name (``"/"``-joined, ``convert.is_embedding_path``).
The online trainer (``train/online.py``) uses it for mode-1 delta
publishing and the feature lifecycle, the geo trainer (``train/trainer.py``)
for its touched-row diff push.  The model's ``touched_tables`` hook wins
when it returns a dict; the fused-CTR default maps ``batch["sparse"]``
through the pack arithmetic onto every table whose row count matches the
configured vocab, or, on a mesh with mp > 1 (the parallel context's), the
row count of the engine's table padded up to an mp multiple
(``parallel/embedding.py`` ``ShardedEmbedding``; a sharded table is named by
its whole padded rows, not its shard's).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from paddlerec_tpu_torch.ops.sparse_update import infer_pack
from paddlerec_tpu_torch.parallel import context


def batch_rows_by_table(
    model_def,
    batch,
    table_rows: Dict[str, int],
    warn: Optional[Callable[[str, str], None]] = None,
) -> Dict[str, np.ndarray]:
    """name → physical row ids of ``batch`` for each table in table_rows.

    warn(name, why) is called (once-semantics are the caller's concern)
    for tables that get no mapping.
    """
    warn = warn or (lambda name, why: None)
    hooked = model_def.touched_tables(batch)
    if hooked is not None:
        out = {}
        for name, rows in hooked.items():
            if name in table_rows:
                out[name] = np.asarray(rows).reshape(-1)
            else:
                warn(name, "touched_tables names no param table")
        for name in table_rows:
            if name not in hooked:
                warn(name, "absent from touched_tables")
        return out
    if "sparse" not in batch:
        return {}
    ids = np.asarray(batch["sparse"]).reshape(-1)
    vocab = getattr(model_def, "vocab_size", None)
    out = {}
    mp = context.model_parallel_size()
    for name, n_rows in table_rows.items():
        if vocab:
            try:
                pack = infer_pack(vocab, n_rows)
            except ValueError:
                try:
                    # the engine's geometry: rows padded to an mp multiple
                    pack = infer_pack(vocab, n_rows, mp) if mp > 1 else None
                except ValueError:
                    pack = None
                if pack is None:
                    warn(name, f"rows {n_rows} do not match vocab {vocab} "
                               "under any pack factor")
                    continue
            out[name] = ((ids % vocab) // pack) % n_rows
        else:
            out[name] = ids % n_rows
    return out
