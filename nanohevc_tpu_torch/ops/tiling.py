"""Plane <-> block-tensor tiling and batched neighbour extraction.

Port of `nanohevc_tpu/ops/tiling.py`.  The block tensor is
`(nb, N, N)` in raster block order; partial edge blocks are dropped.
`extract_refs` gives every block the combined reference layout

    refs[b] = [ top_-1..top_2N-1 | left_-1..left_2N-1 ]   (length 4N+2)

with the corner at index 0 and 2N+1, the boundary fill outside the
frame and the last in-frame sample replicated past the frame edge.
`extract_refs` reads the source plane (open loop); `extract_refs_at`
reads any plane at a chosen set of blocks, which the closed loop uses
on its partly written reconstruction.
"""

from __future__ import annotations

import torch

BOUNDARY_FILL = 128


def num_blocks(height: int, width: int, n: int) -> tuple[int, int]:
    """(blocks per column, blocks per row) of full NxN blocks."""
    return height // n, width // n


def tile_plane(plane: torch.Tensor, n: int) -> torch.Tensor:
    """(H, W) -> (nby*nbx, N, N) in raster block order; edges dropped."""
    h, w = plane.shape
    nby, nbx = h // n, w // n
    x = plane[: nby * n, : nbx * n].reshape(nby, n, nbx, n)
    return x.permute(0, 2, 1, 3).reshape(nby * nbx, n, n)


def untile_plane(blocks: torch.Tensor, height: int, width: int,
                 fill: int = 0) -> torch.Tensor:
    """(nb, N, N) -> (H, W); dropped edge regions take `fill`."""
    n = blocks.shape[-1]
    nby, nbx = height // n, width // n
    body = (
        blocks.reshape(nby, nbx, n, n).permute(0, 2, 1, 3)
        .reshape(nby * n, nbx * n)
    )
    if nby * n == height and nbx * n == width:
        return body
    out = torch.full((height, width), fill, dtype=blocks.dtype,
                     device=blocks.device)
    out[: nby * n, : nbx * n] = body
    return out


def extract_refs_at(plane: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    n: int, boundary: int = BOUNDARY_FILL) -> torch.Tensor:
    """Neighbour extraction for an arbitrary set of block origins.

    (..., H, W) plane, (m,) block-row and (m,) block-column indices ->
    (..., m, 4N+2) in the layout of `extract_refs`, leading (batch)
    dimensions kept.  The clamps are those of `extract_refs`: top
    columns to W-1, left rows to H-1.  On a zero-filled reconstruction
    written one anti-diagonal at a time they give the closed loop's
    availability rule: the top-right and below-left extensions lie on
    the block's own diagonal and read 0, except at the last block-column
    (last block-row), where the clamp replicates T[N] (L[N]).
    """
    h, w = plane.shape[-2:]
    p = plane.to(torch.int32)
    dev = p.device
    y0 = (ys.to(torch.int64) * n)[:, None]                       # (m, 1)
    x0 = (xs.to(torch.int64) * n)[:, None]
    i = torch.arange(2 * n + 1, dtype=torch.int64, device=dev)[None, :]
    fill = torch.tensor(boundary, dtype=torch.int32, device=dev)
    edge = (y0[:, 0] == 0) | (x0[:, 0] == 0)                    # (m,)

    tcol = (x0 + (i - 1)).clamp(0, w - 1)
    trow = (y0 - 1).clamp(0, h - 1).expand_as(tcol)
    top = torch.where(y0 == 0, fill, p[..., trow, tcol])         # (..., m, 2N+1)
    top[..., 0] = torch.where(edge, fill, top[..., 0])

    lrow = (y0 + (i - 1)).clamp(0, h - 1)
    lcol = (x0 - 1).clamp(0, w - 1).expand_as(lrow)
    left = torch.where(x0 == 0, fill, p[..., lrow, lcol])
    left[..., 0] = torch.where(edge, fill, left[..., 0])
    return torch.cat([top, left], dim=-1)


def extract_refs(plane: torch.Tensor, n: int,
                 boundary: int = BOUNDARY_FILL) -> torch.Tensor:
    """Batched neighbour extraction: (H, W) -> (nb, 4N+2) int32.

    Positions 0..2N are the top reference with the corner at 0;
    positions 2N+1..4N+1 the left reference with the corner at 2N+1.
    """
    h, w = plane.shape
    nby, nbx = h // n, w // n
    dev = plane.device
    p = plane.to(torch.int32)
    y0 = (torch.arange(nby, dtype=torch.int64, device=dev) * n)[:, None, None]
    x0 = (torch.arange(nbx, dtype=torch.int64, device=dev) * n)[None, :, None]
    i = torch.arange(2 * n + 1, dtype=torch.int64, device=dev)[None, None, :]
    fill = torch.tensor(boundary, dtype=torch.int32, device=dev)
    edge = (y0 == 0) | (x0 == 0)                                # (nby, nbx, 1)
    shape = (nby, nbx, 2 * n + 1)

    # Top: row y0-1, columns x0-1+i (clamped right).
    tcol = (x0 + (i - 1)).clamp(0, w - 1).expand(shape)
    trow = (y0 - 1).clamp(0, h - 1).expand(shape)
    top = p[trow, tcol]                                          # (nby, nbx, 2N+1)
    top = torch.where(y0 == 0, fill, top)
    top[:, :, :1] = torch.where(edge, fill, top[:, :, :1])

    # Left: column x0-1, rows y0-1+i (clamped down).
    lrow = (y0 + (i - 1)).clamp(0, h - 1).expand(shape)
    lcol = (x0 - 1).clamp(0, w - 1).expand(shape)
    left = p[lrow, lcol]
    left = torch.where(x0 == 0, fill, left)
    left[:, :, :1] = torch.where(edge, fill, left[:, :, :1])

    return torch.cat([top, left], dim=-1).reshape(nby * nbx, 4 * n + 2)
