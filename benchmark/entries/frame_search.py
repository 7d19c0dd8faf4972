"""Entry `frame_search`: the `frame` entry on a configuration whose
closed loop decides each block's mode by a per-block cost (x265's fast
presets: the 35 modes by SATD), which the port codes on its wavefront
kernel (`kernels/wavefront.py::wavefront_encode_planes`).

The window, the sampled calls and the four numbers compared, each with
the limit 0, are the `frame` entry's; the reference is
`plainref/search.py`, put in the place of `plainref/encoder.py`'s
`encode_frames` while the entry lives and while it checks, so that the
`frame` entry's check and `control.py` run it unchanged.
"""

from __future__ import annotations

import contextlib

from benchlib import spec

frame = spec.load_module("entries", "frame")


@contextlib.contextmanager
def search_reference():
    """`plainref.encoder.encode_frames` is `plainref.search.encode_frames`
    inside; put back on exit."""
    from plainref import encoder, search

    orig = encoder.encode_frames
    encoder.encode_frames = search.encode_frames
    try:
        yield
    finally:
        encoder.encode_frames = orig


class Entry(frame.Entry):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.reference = contextlib.ExitStack()
        self.reference.enter_context(search_reference())

    def spans(self) -> list:
        return super().spans() + [
            (frame._WF, "wavefront_encode_planes", "search_kernel")]

    def release(self) -> None:
        super().release()
        self.reference.close()

    def check(self, kept: dict, attempted: int) -> list:
        with search_reference():
            return super().check(kept, attempted)
