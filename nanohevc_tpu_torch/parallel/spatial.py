"""Spatially sharded open loop: the slab and mode-search kernels on row
shards, port of `nanohevc_tpu/parallel/spatial.py`.

The frame batch splits over the mesh's "frame" axis and each plane's
rows over its "space" axis.  Each row shard runs the slab kernel
(`kernels.slab_pipeline`) or the mode-search kernel
(`kernels.mode_search`) on its device, with the rows it needs from its
neighbours moved to it (see `parallel.mesh` for the execution model):

- the last row of the shard above, the top reference of the shard's
  first block-row (shard 0 takes the `1 << (bit_depth - 1)` fill, which
  is the frame-top reference), as one padding block-row above the shard;
- for the mode search only, the first N rows of the shard below, since
  angular modes read the left reference's rows N..2N-1, which lie below
  the shard's last block-row (the last shard repeats its own last row,
  which is the kernels' bottom clamp), as one padding block-row below.

The padding block-rows' outputs are cropped.  The frame bottom is first
padded to a multiple of space * N rows by repeating the last row, so
that every shard is a whole number of block-rows; the pad's blocks are
cropped after the gather.
"""

from __future__ import annotations

from typing import Callable

import torch

from nanohevc_tpu_torch import ops
from nanohevc_tpu_torch.config import EncoderConfig
from nanohevc_tpu_torch.kernels.mode_search import mode_search_encode_plane
from nanohevc_tpu_torch.kernels.slab_pipeline import slab_encode_plane
from nanohevc_tpu_torch.models.all_intra import (
    supports_fast_path,
    supports_mode_search_fast_path,
)
from nanohevc_tpu_torch.parallel.mesh import Mesh, frame_sharded, move, on_device


def sharded_fast_supported(config: EncoderConfig, mesh: Mesh,
                           height: int, width: int,
                           is_luma: bool = True) -> str | None:
    """Which sharded kernel covers this (config, mesh, plane): 'slab',
    'mode_search', or None.

    The plane must be a whole number of block-rows; the bottom padding
    makes any such height split over the space axis.
    """
    n = config.block_size if is_luma else config.chroma_block_size()
    if height % n != 0:
        return None
    if supports_fast_path(config, n, width, is_luma):
        return "slab"
    if supports_mode_search_fast_path(config, n, width, is_luma):
        return "mode_search"
    return None


def make_sharded_fast_encoder(config: EncoderConfig, mesh: Mesh,
                              variant: str = "slab",
                              is_luma: bool = True) -> Callable:
    """A (frame, space)-sharded kernel encoder.

    Returns fn(planes (F, H, W) int32, qp=None) -> dict(recon (F, H, W),
    levels (F, nb, N*N) scan-packed, modes (F, nb)) on the mesh's first
    device.  The kernels take `qp`, or config.qp where it is None.
    Requires a kernel config (variant='slab': dc_planar/energy;
    'mode_search': all/satd) and W % N == 0; F must divide over the
    "frame" axis.  Each call launches the variant's kernel F x space
    times.
    """
    if variant not in ("slab", "mode_search"):
        raise ValueError(f"unknown variant: {variant!r}")
    n = config.block_size if is_luma else config.chroma_block_size()
    kernel = slab_encode_plane if variant == "slab" else mode_search_encode_plane
    kw = dict(bit_depth=config.bit_depth, use_dst=config.use_dst(n, is_luma),
              dequant_rescale=config.dequant_rescale)
    boundary = 1 << (config.bit_depth - 1)
    space = mesh.shape["space"]

    def encode_rows(rows: list, qp: int, dest: torch.device) -> tuple:
        """One plane's row shards (each on its device) -> its recon,
        scan-packed levels and modes on `dest`."""
        recon, levels, modes = [], [], []
        for s, shard in enumerate(rows):
            dev, (h, w) = shard.device, shard.shape
            with on_device(dev):
                top = (torch.full((1, w), boundary, dtype=torch.int32,
                                  device=dev)
                       if s == 0 else move(rows[s - 1][-1:], dev))
                parts = [top.expand(n, w), shard]
                if variant == "mode_search":
                    parts.append(shard[-1:].expand(n, w) if s == space - 1
                                 else move(rows[s + 1][:n], dev))
                out = kernel(torch.cat(parts), qp, n, **kw)
                # drop the padding block-rows' blocks
                nbx = w // n
                keep = slice(nbx, nbx + (h // n) * nbx)
                shard_modes = out["modes"][keep]
                levels.append(ops.scan_pack(out["levels"][keep], config.scan,
                                            modes=shard_modes))
            recon.append(out["recon"][n:n + h])
            modes.append(shard_modes)
        return tuple(torch.cat([move(t, dest) for t in ts])
                     for ts in (recon, levels, modes))

    def encode_shard(planes: torch.Tensor, qp: int, row) -> dict:
        """One frame shard, each plane's rows over the mesh row `row`."""
        f, h, w = planes.shape
        # Pad the frame bottom so every row shard is a whole number of
        # block-rows; repeating the last row matches the kernels' own
        # bottom clamp, and the pad's blocks are cropped below.
        unit = space * n
        h_pad = -(-h // unit) * unit
        if h_pad != h:
            planes = torch.cat(
                [planes, planes[:, h - 1:h].expand(f, h_pad - h, w)], dim=1)
        hl = h_pad // space
        outs = [encode_rows([move(p[s * hl:(s + 1) * hl], row[s])
                             for s in range(space)], qp, row[0])
                for p in planes]
        nb = (h // n) * (w // n)
        recon, levels, modes = (torch.stack(ts) for ts in zip(*outs))
        return {"recon": recon[:, :h], "levels": levels[:, :nb],
                "modes": modes[:, :nb]}

    sharded = frame_sharded(encode_shard, mesh)

    def run(planes: torch.Tensor, qp: int | None = None) -> dict:
        return sharded(planes.to(torch.int32),
                       config.qp if qp is None else int(qp))

    return run
