# Copy of nanohevc_tpu/block.py (only the import lines and reference paths differ).
"""Host-side block view over a Plane (API parity layer).

API-compatible with reference/nano_hevc/block.py:14-74.  The TPU
compute path never materializes per-block objects — it operates on a
`(num_blocks, N, N)` tensor produced by `nanohevc_tpu.ops.tiling` —
but the reference exposes BlockView / iterate_blocks publicly, so they
are preserved here for host-side use and for defining the boundary
semantics (128 fill at frame edges, partial edge blocks skipped).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from nanohevc_tpu_torch.frame import Plane

__all__ = ["BlockView", "iterate_blocks"]

BOUNDARY_FILL = 128  # neighbor value used outside the frame


class BlockView:
    """A zero-copy NxN window into a Plane with neighbor accessors."""

    __slots__ = ("plane", "x", "y", "size")

    def __init__(self, plane: Plane, x: int, y: int, size: int):
        self.plane = plane
        self.x = x
        self.y = y
        self.size = size

    def _fill(self, n: int) -> np.ndarray:
        return np.full(n, BOUNDARY_FILL, dtype=self.plane.data.dtype)

    @property
    def pixels(self) -> np.ndarray:
        a = self.plane.data
        return a[self.y : self.y + self.size, self.x : self.x + self.size]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.size, self.size)

    def get_top_neighbors(self, count: Optional[int] = None) -> np.ndarray:
        """Pixels from the row above; BOUNDARY_FILL on the top edge."""
        n = self.size if count is None else count
        if self.y == 0:
            return self._fill(n)
        return self.plane.data[self.y - 1, self.x : self.x + n].copy()

    def get_left_neighbors(self, count: Optional[int] = None) -> np.ndarray:
        """Pixels from the column to the left; BOUNDARY_FILL on the left edge."""
        n = self.size if count is None else count
        if self.x == 0:
            return self._fill(n)
        return self.plane.data[self.y : self.y + n, self.x - 1].copy()

    def get_top_left_neighbor(self) -> int:
        """Corner pixel; BOUNDARY_FILL when the block touches either edge."""
        on_edge = self.y == 0 or self.x == 0
        return BOUNDARY_FILL if on_edge else int(
            self.plane.data[self.y - 1, self.x - 1]
        )

    def copy_pixels(self) -> np.ndarray:
        return self.pixels.copy()

    def write_pixels(self, data: np.ndarray) -> None:
        self.pixels[...] = data

    def __repr__(self) -> str:
        return f"BlockView(x={self.x}, y={self.y}, size={self.size})"


def iterate_blocks(plane: Plane, block_size: int) -> Iterator[BlockView]:
    """Raster-order full blocks only; partial edge blocks are skipped.

    Matches the device tiling (ops/tiling.py tile_plane): the grid is
    floor(H/N) x floor(W/N); a ragged right/bottom margin is never
    visited.
    """
    nby = plane.height // block_size
    nbx = plane.width // block_size
    for by in range(nby):
        for bx in range(nbx):
            yield BlockView(plane, bx * block_size, by * block_size, block_size)
