"""The benchmark's weights, made on the device from the seed.

Each leaf of a model (``models/<model>.py`` ``leaves``) is drawn by its own
``torch.Generator`` on the device, seeded from the run's seed, the leaf's
name and a block index, in blocks of ``BLOCK_ROWS`` rows: a table of
gigabytes is filled in a few dozen large calls, and any block can be drawn
again alone.  The program gets them written into its parameters; the
reference draws them again itself (``table_rows``, ``make``), so it takes
nothing the program made.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from recbench.traffic import mix64

BLOCK_ROWS = 1 << 20


def _blocks(name: str, shape: Tuple[int, ...], dtype: torch.dtype, init: tuple,
            seed: int, device) -> Iterator[Tuple[int, torch.Tensor]]:
    """(first row, block in ``dtype``) over the leaf's rows, in order."""
    rows = shape[0] if shape else 1
    for b, start in enumerate(range(0, rows, BLOCK_ROWS)):
        n = min(BLOCK_ROWS, rows - start)
        block_shape = (n,) + tuple(shape[1:]) if shape else ()
        if init[0] in ("zeros", "const"):
            value = float(init[1]) if init[0] == "const" else 0.0
            yield start, torch.full(block_shape, value, dtype=dtype, device=device)
            continue
        gen = torch.Generator(device=device).manual_seed(mix64(seed, *name.encode(), b))
        block = torch.randn(block_shape, generator=gen, dtype=torch.float32, device=device)
        yield start, block.mul_(float(init[1])).to(dtype)


@torch.no_grad()
def fill_(param: torch.Tensor, name: str, init: tuple, seed: int) -> None:
    """Write the leaf's weights into ``param`` in place."""
    if not param.shape:
        for _, block in _blocks(name, (), param.dtype, init, seed, param.device):
            param.copy_(block)
        return
    for start, block in _blocks(name, tuple(param.shape), param.dtype, init, seed,
                                param.device):
        param[start:start + block.shape[0]].copy_(block)


def make(name: str, shape, dtype: torch.dtype, init: tuple, seed: int,
         device) -> torch.Tensor:
    """The leaf whole, as float32."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    fill_(out, name, init, seed)
    return out.float()


def table_rows(name: str, shape, dtype: torch.dtype, init: tuple, seed: int,
               rows: torch.Tensor) -> torch.Tensor:
    """float32 values of the leaf at ascending int64 ``rows`` (their stored
    values: drawn, cast to ``dtype``, read back), block by block."""
    out = torch.empty((rows.shape[0],) + tuple(shape[1:]), dtype=torch.float32,
                      device=rows.device)
    for start, block in _blocks(name, tuple(shape), dtype, init, seed, rows.device):
        lo = int(torch.searchsorted(rows, start))
        hi = int(torch.searchsorted(rows, start + block.shape[0]))
        if hi > lo:
            out[lo:hi] = block[rows[lo:hi] - start].float()
    return out


@torch.no_grad()
def change_sq(param: torch.Tensor, name: str, init: tuple, seed: int) -> float:
    """Σ (param − the leaf as drawn)², in float64, block by block."""
    total = 0.0
    if not param.shape:
        return float((param.double() - make(name, (), param.dtype, init, seed,
                                            param.device).double()) ** 2)
    for start, block in _blocks(name, tuple(param.shape), param.dtype, init, seed,
                                param.device):
        d = param[start:start + block.shape[0]].double() - block.double()
        total += float(torch.sum(d * d))
    return total
