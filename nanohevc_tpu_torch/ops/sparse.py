"""Sparse device->host transfer of quantized level tensors, port of
`nanohevc_tpu/ops/sparse.py`.

Levels are scan-packed per block (DC first), so at production QPs the
occupied coefficients concentrate in a short prefix of the scan order.
The sequence runner fetches only that prefix:

  device:  compact_levels()  -- two reductions giving an 8-byte header
           [prefix_len, max_abs], prefix_len being 1 + the last scan
           position occupied by ANY block;
  host:    fetch_levels()    -- reads the header, rounds the prefix up
           to a power-of-two bucket (at least _MIN_PREFIX), fetches
           `levels[..., :P]` as int16 and zero-pads back to the dense
           ndarray; a header whose max_abs exceeds int16 falls back to
           the dense int32 transfer.

Lossless at every QP: every nonzero lies inside the fetched prefix by
the definition of prefix_len.  The JAX package compiles one slice
program per bucket; here the slice is a plain tensor slice.  The
fetch runs on the current stream: the sequence runner issues it on a
copy stream of its own, ordered after the batch's event only (see
`models.sequence`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["compact_levels", "fetch_levels"]

# Smallest fetch prefix (scan positions).
_MIN_PREFIX = 4


def compact_levels(levels: torch.Tensor) -> dict:
    """Device-side header for the prefix fetch.

    `levels` is (..., ncoef) with the last axis scan-packed (DC first).
    Returns {"header": (2,) int32 [prefix_len, max_abs]} on the device
    of `levels`: prefix_len is 1 + the highest scan position any block
    occupies (0 when the tensor is all zero), so `levels[..., :prefix_len]`
    contains every nonzero.
    """
    ncoef = levels.shape[-1]
    flat = levels.reshape(-1, ncoef)
    occupied = (flat != 0).any(dim=0)                             # (ncoef,)
    pos = torch.arange(ncoef, dtype=torch.int32, device=levels.device)
    last = torch.where(occupied, pos, -1).max()
    max_abs = flat.abs().max().to(torch.int32)
    return {"header": torch.stack([last + 1, max_abs]).to(torch.int32)}


def _bucket(need: int, ncoef: int) -> int:
    b = _MIN_PREFIX
    while b < need:
        b *= 2
    return min(b, ncoef)


def fetch_levels(sparse: dict, shape, dense=None) -> np.ndarray:
    """Fetch a level tensor to a dense host ndarray via its prefix.

    `sparse` is compact_levels' output (its header on the device or
    already on the host); `dense` is the dense tensor the prefix is
    sliced from (required).  Transfers 8 bytes of header + 2 bytes x
    prefix x blocks instead of 4 bytes per coefficient; the int16
    overflow falls back to the full int32 transfer.
    """
    if dense is None:
        raise ValueError(
            "fetch_levels requires the dense device tensor to slice "
            "the occupied prefix from"
        )
    header = sparse["header"].cpu().numpy()
    need, max_abs = int(header[0]), int(header[1])
    if max_abs > np.iinfo(np.int16).max:
        return dense.to(torch.int32).cpu().numpy().reshape(shape)
    if need <= 0:
        return np.zeros(shape, np.int32)
    ncoef = int(shape[-1])
    p = _bucket(need, ncoef)
    pre = dense[..., :p].to(torch.int16).cpu().numpy()
    if p >= ncoef:
        return pre.astype(np.int32).reshape(shape)
    out = np.zeros(shape, np.int32)
    out.reshape(-1, ncoef)[:, :p] = pre.reshape(-1, p)
    return out
