# Copy of nanohevc_tpu/frame.py (only the import lines and reference paths differ).
"""Host-side frame data model: Plane / Frame / PackedFrame / FrameBufferPool.

API-compatible with the reference data model
(reference/nano_hevc/frame.py:16-308).  On TPU, frames live as
device arrays produced by `nanohevc_tpu.ops.tiling`; these classes are
the host staging layer (raw YUV420p bytes <-> numpy planes) and the
public-API surface.  XLA owns device memory, so PackedFrame /
FrameBufferPool matter only for host buffer reuse.
"""

from __future__ import annotations

from typing import List, Set, Tuple

import numpy as np

__all__ = [
    "Plane",
    "Frame",
    "PackedFrame",
    "FrameBufferPool",
]


class Plane:
    """One color plane (Y, U or V) as a C-contiguous 2-D array."""

    __slots__ = ("data",)

    def __init__(self, data: np.ndarray):
        self.data = data

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.data.shape[:2]

    @classmethod
    def zeros(cls, height: int, width: int, dtype: np.dtype = np.int16) -> "Plane":
        return cls(np.zeros((height, width), dtype=dtype, order="C"))

    @classmethod
    def from_buffer(
        cls, buffer: bytes, height: int, width: int, dtype: np.dtype = np.uint8
    ) -> "Plane":
        data = np.frombuffer(buffer, dtype=dtype).reshape(height, width)
        return cls(np.ascontiguousarray(data))

    def __repr__(self) -> str:
        return f"Plane(shape={self.shape}, dtype={self.data.dtype})"


class Frame:
    """A YUV420p frame: full-resolution Y, half-resolution U and V."""

    __slots__ = ("y", "u", "v")

    def __init__(self, y: Plane, u: Plane, v: Plane):
        self.y = y
        self.u = u
        self.v = v

    @property
    def height(self) -> int:
        return self.y.height

    @property
    def width(self) -> int:
        return self.y.width

    @classmethod
    def zeros(cls, height: int, width: int, dtype: np.dtype = np.int16) -> "Frame":
        return cls(
            Plane.zeros(height, width, dtype),
            Plane.zeros(height // 2, width // 2, dtype),
            Plane.zeros(height // 2, width // 2, dtype),
        )

    @classmethod
    def from_yuv420p(cls, buffer: bytes, height: int, width: int) -> "Frame":
        """Split a raw planar YUV420p byte buffer (Y then U then V)."""
        ys = height * width
        uh, uw = height // 2, width // 2
        us = uh * uw
        return cls(
            Plane.from_buffer(buffer[:ys], height, width),
            Plane.from_buffer(buffer[ys : ys + us], uh, uw),
            Plane.from_buffer(buffer[ys + us : ys + 2 * us], uh, uw),
        )

    def to_yuv420p(self, bit_depth: int = 8) -> bytes:
        """Serialize back to raw planar YUV420p bytes.

        bit_depth > 8 writes 16-bit little-endian samples (the yuv420p
        10le-style layout); 8 writes one byte per sample.
        """
        dt = np.uint8 if bit_depth <= 8 else np.dtype("<u2")
        return (
            self.y.data.astype(dt).tobytes()
            + self.u.data.astype(dt).tobytes()
            + self.v.data.astype(dt).tobytes()
        )

    def __repr__(self) -> str:
        return f"Frame(height={self.height}, width={self.width})"


class PackedFrame:
    """YUV420p frame over one contiguous allocation (Y | U | V views).

    The single backing array keeps a whole frame's planes adjacent in
    memory — one `device_put`, one file write — while `y`/`u`/`v`
    stay zero-copy reshaped views into it.
    """

    __slots__ = ("_store", "y", "u", "v", "height", "width")

    def __init__(self, height: int, width: int, dtype: np.dtype = np.int16):
        self.height = height
        self.width = width
        luma = height * width
        chroma = luma // 4
        self._store = np.zeros(luma + 2 * chroma, dtype=dtype, order="C")
        cuts = (luma, luma + chroma)
        self.y = self._store[: cuts[0]].reshape(height, width)
        self.u = self._store[cuts[0] : cuts[1]].reshape(height // 2, width // 2)
        self.v = self._store[cuts[1] :].reshape(height // 2, width // 2)

    @classmethod
    def from_yuv420p(cls, buffer: bytes, height: int, width: int) -> "PackedFrame":
        pf = cls(height, width, dtype=np.uint8)
        pf._store[:] = np.frombuffer(buffer, dtype=np.uint8)[: pf._store.size]
        return pf

    @classmethod
    def from_frame(cls, frame: Frame) -> "PackedFrame":
        pf = cls(frame.height, frame.width, dtype=frame.y.data.dtype)
        pf.y[...] = frame.y.data
        pf.u[...] = frame.u.data
        pf.v[...] = frame.v.data
        return pf

    def to_yuv420p(self) -> bytes:
        return self._store.astype(np.uint8).tobytes()

    def to_frame(self) -> Frame:
        return Frame(Plane(self.y.copy()), Plane(self.u.copy()), Plane(self.v.copy()))

    def clear(self) -> None:
        self._store.fill(0)

    def __repr__(self) -> str:
        return (
            f"PackedFrame(height={self.height}, width={self.width}, "
            f"dtype={self._store.dtype})"
        )


class FrameBufferPool:
    """Fixed set of pre-allocated host frames with acquire/release.

    Allocation happens once, up front; steady-state encoding then
    recycles buffers instead of churning the allocator.  Same
    fail-fast contract as the reference pool (exhaustion raises
    RuntimeError, double-release raises ValueError).
    """

    __slots__ = ("_slots", "_free", "_live", "height", "width", "dtype")

    def __init__(
        self,
        height: int,
        width: int,
        pool_size: int = 4,
        dtype: np.dtype = np.int16,
        use_packed: bool = True,
    ):
        self.height = height
        self.width = width
        self.dtype = dtype
        if use_packed:
            self._slots: List[PackedFrame | Frame] = [
                PackedFrame(height, width, dtype=dtype) for _ in range(pool_size)
            ]
        else:
            self._slots = [
                Frame.zeros(height, width, dtype=dtype) for _ in range(pool_size)
            ]
        self._free: List[int] = list(range(pool_size))
        self._live: Set[int] = set()

    def acquire(self, clear: bool = True) -> Tuple[int, "PackedFrame | Frame"]:
        """Take a buffer out of the pool; raises RuntimeError when empty."""
        if not self._free:
            raise RuntimeError(
                f"frame pool exhausted ({len(self._live)} of "
                f"{len(self._slots)} buffers held; release one first)"
            )
        idx = self._free.pop()
        self._live.add(idx)
        frame = self._slots[idx]
        if clear:
            if isinstance(frame, PackedFrame):
                frame.clear()
            else:
                for plane in (frame.y, frame.u, frame.v):
                    plane.data.fill(0)
        return idx, frame

    def release(self, idx: int) -> None:
        """Return a buffer; raises ValueError on double-release."""
        if idx not in self._live:
            raise ValueError(f"buffer {idx} was not acquired (double release?)")
        self._live.discard(idx)
        self._free.append(idx)

    @property
    def available_count(self) -> int:
        return len(self._free)

    @property
    def in_use_count(self) -> int:
        return len(self._live)

    @property
    def pool_size(self) -> int:
        return len(self._slots)

    def __repr__(self) -> str:
        return (
            f"FrameBufferPool(height={self.height}, width={self.width}, "
            f"available={self.available_count}/{self.pool_size})"
        )
