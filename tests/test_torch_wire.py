"""The feed of the port against the JAX package: wire encoding and its
device-side decode, the slotbin reader and writer, superbatch stacking and
the prefetch thread."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu.data import binary as jax_binary
from paddlerec_tpu.data import superbatch as jax_superbatch
from paddlerec_tpu.data import wire as jax_wire
from paddlerec_tpu_torch.core.device import to_tensors
from paddlerec_tpu_torch.data import binary as port_binary
from paddlerec_tpu_torch.data import superbatch as port_superbatch
from paddlerec_tpu_torch.data import wire as port_wire
from paddlerec_tpu_torch.data.slot_reader import PrefetchIterator

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _batch(rng, rows, vocab, sparse_dtype=np.int64):
    return {
        "label": (rng.rand(rows) < 0.3).astype(np.float32),
        "sparse": rng.randint(0, vocab, (rows, 26)).astype(sparse_dtype),
        "dense": rng.rand(rows, 13).astype(np.float32),
        "mask": (rng.rand(rows) < 0.9).astype(np.float32),
    }


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("vocab", [1000001, 1 << 24, (1 << 24) + 5, 0])
def test_encode_and_decode_match_jax_bitwise(vocab):
    rng = np.random.RandomState(vocab % 97)
    batch = _batch(rng, 48, max(vocab, 1 << 20) + 50)
    ref_wire = jax_wire.encode_batch(batch, vocab)
    out_wire = port_wire.encode_batch(batch, vocab)
    _same(out_wire, ref_wire)
    assert port_wire.wire_bytes(out_wire) == jax_wire.wire_bytes(ref_wire)
    ref = jax_wire.decode_batch({k: jnp.asarray(v) for k, v in ref_wire.items()})
    out = port_wire.decode_batch(to_tensors(out_wire, CPU))
    _same({k: v.numpy() for k, v in out.items()}, ref)
    if 0 < vocab <= 1 << 24:
        assert out_wire["sparse"].dtype == np.uint8 and out_wire["sparse"].shape == (48, 26, 3)
        assert out["sparse"].dtype == torch.int32
        np.testing.assert_array_equal(out["sparse"].numpy() % vocab, batch["sparse"] % vocab)
    assert out["dense"].dtype == out["label"].dtype == out["mask"].dtype == torch.float32


def test_decode_is_a_noop_on_plain_batches_and_superbatches():
    rng = np.random.RandomState(0)
    plain = to_tensors(_batch(rng, 8, 1000), CPU)
    out = port_wire.decode_batch(plain)
    assert all(out[k] is plain[k] for k in plain)
    # a staged superbatch carries a leading K axis: decode after indexing
    enc = port_wire.WireEncoder(1000)
    stack = next(port_superbatch.stack_superbatches(
        (enc(_batch(rng, 8, 1000)) for _ in range(3)), 3))
    sb = to_tensors(stack, CPU)
    assert sb["sparse"].shape == (3, 8, 26, 3)
    sub = port_wire.decode_batch({k: v[1] for k, v in sb.items()})
    assert sub["sparse"].shape == (8, 26) and sub["sparse"].dtype == torch.int32


def test_wire_encoder_escalates_once_like_jax():
    rng = np.random.RandomState(1)
    first, second = _batch(rng, 4, 1000), _batch(rng, 4, 1000)
    second["sparse"][0, 0] = -7  # a negative id cannot ride u24
    ref_enc, out_enc = jax_wire.WireEncoder(1000), port_wire.WireEncoder(1000)
    for b in (first, second, first):
        _same(out_enc(b), ref_enc(b))
    assert out_enc._mode == ref_enc._mode == "i32"


@pytest.mark.parametrize("ids_per_slot", [1, 3])
def test_slotbin_reader_and_writer_match_jax(tmp_path, ids_per_slot):
    rng = np.random.RandomState(4)
    paths = {"jax": [], "port": []}
    for i, rows in enumerate([50, 7, 33]):
        labels = (rng.rand(rows) < 0.5).astype(np.float32)
        shape = (rows, 26) if ids_per_slot == 1 else (rows, 26, ids_per_slot)
        sparse = rng.randint(0, 10**6, shape).astype(np.int32)
        dense = rng.rand(rows, 13).astype(np.float32)
        for name, mod in (("jax", jax_binary), ("port", port_binary)):
            path = str(tmp_path / f"{name}-{i}.bin")
            mod.write_slotbin(path, labels, sparse, dense)
            paths[name].append(path)
    for a, b in zip(paths["jax"], paths["port"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        assert port_binary.is_slotbin(b) and not port_binary.is_slotbin(__file__)
    for kwargs in ({"drop_last": True}, {"drop_last": False},
                   {"drop_last": False, "shuffle_files": True,
                    "shuffle_batches": True, "seed": 3}):
        ref_ds = jax_binary.BinarySlotDataset(paths["jax"], 16, **kwargs)
        out_ds = port_binary.BinarySlotDataset(paths["jax"], 16, **kwargs)
        for _ in range(2):  # the second epoch reshuffles
            ref, out = list(ref_ds), list(out_ds)
            assert len(out) == len(ref) == (5 if kwargs["drop_last"] else 6)
            for r, o in zip(ref, out):
                _same(o, r)
        if not kwargs["drop_last"]:
            assert out[-1]["mask"].sum() == 90 - 5 * 16


def test_stack_superbatches_matches_jax():
    rng = np.random.RandomState(5)
    batches = [_batch(rng, 8, 1000) for _ in range(5)] + [_batch(rng, 4, 1000)]
    ref = list(jax_superbatch.stack_superbatches(iter(batches), 2))
    out = list(port_superbatch.stack_superbatches(iter(batches), 2))
    assert [o["label"].shape for o in out] == [(2, 8), (2, 8), (1, 8), (1, 4)]
    for r, o in zip(ref, out):
        _same(o, r)


def test_prefetch_iterator_keeps_order_and_surfaces_errors():
    assert list(PrefetchIterator(iter(range(20)), depth=3)) == list(range(20))

    def broken():
        yield 1
        raise OSError("reader failed")

    it = PrefetchIterator(broken(), depth=2)
    assert next(it) == 1
    with pytest.raises(OSError, match="reader failed"):
        next(it)
