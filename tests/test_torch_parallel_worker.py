"""One rank of the all_to_all engine's multi-process checks (no tests here).

``tests/test_torch_parallel.py`` launches this file through
``paddlerec_tpu_torch.tools.launch`` (gloo, on the CPU) with a case
directory holding ``case.npz``; each rank writes ``rank<r>.npz``: its dp
row's vectors, its shard's gradient and its overflow counts, and the
calls of K1 and K1b on its shard, for the test to hold against the JAX
engine on the same ``(dp, mp)`` mesh.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counting(fn, calls, name):
    def wrapper(*args, **kwargs):
        calls.append((name, tuple(args[0].shape), tuple(args[1].shape),
                      kwargs.get("mode", "clip")))
        return fn(*args, **kwargs)
    return wrapper


def run(case_dir: str) -> None:
    import numpy as np
    import torch

    from paddlerec_tpu_torch.parallel import embedding as emb
    from paddlerec_tpu_torch.parallel.mesh import create_mesh
    from paddlerec_tpu_torch.parallel.sharding import local_rows
    from paddlerec_tpu_torch.tools.launch import init_from_env

    torch.set_num_threads(1)
    init_from_env("cpu", timeout_s=60)
    z = np.load(os.path.join(case_dir, "case.npz"))
    dp, mp = int(z["dp"]), int(z["mp"])
    mesh = create_mesh(dp, mp)
    calls = []
    emb.gather_pool = _counting(emb.gather_pool, calls, "k1")
    emb.gather_pool_bwd = _counting(emb.gather_pool_bwd, calls, "k1b")
    out = {}

    def row(a):  # this rank's dp row of a global (B, ...) array
        b = a.shape[0] // dp
        return torch.from_numpy(a[mesh.dp_index * b:(mesh.dp_index + 1) * b])

    for key in ("lookup", "grad", "hot", "overflow"):
        vocab, dim = (int(v) for v in z[f"{key}_shape"])
        eng = emb.ShardedEmbedding(mesh, vocab, dim, float(z[f"{key}_cf"]), device="cpu")
        table = local_rows(torch.from_numpy(z[f"{key}_table"]), mesh.mp_index, mp)
        table = table.clone().requires_grad_(key == "grad")
        calls.clear()
        vecs, overflow = eng.lookup_with_overflow(table, row(z[f"{key}_ids"]))
        if key == "grad":
            loss = ((vecs - row(z["grad_tgt"])) ** 2).sum()
            loss.backward()
            out["grad_dtable"] = table.grad.numpy()
        out[f"{key}_vecs"] = vecs.detach().numpy()
        out[f"{key}_overflow"] = overflow.numpy()
        out[f"{key}_calls"] = np.array([f"{c[0]} {c[1]} {c[2]} {c[3]}" for c in calls])
        out[f"{key}_capacity"] = np.array(eng.capacity(row(z[f"{key}_ids"]).numel()))
        if key == "lookup":  # the delta-tap lookup over the same shard and ids
            delta = row(z["external_delta"]).clone().requires_grad_()
            ext, _ = eng.lookup_external(table, delta, row(z["lookup_ids"]))
            (ext * row(z["external_weight"])).sum().backward()
            out["external_vecs"] = ext.detach().numpy()
            out["external_dgrad"] = delta.grad.numpy()
    np.savez(os.path.join(case_dir, f"rank{mesh.rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    run(sys.argv[1])
