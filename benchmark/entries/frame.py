"""Entry `frame`: one caller sends raw 4:2:0 frames, one at a time, to
the port's frame API, `nanohevc_tpu_torch.models.wavefront.
encode_frame_closed_loop(frame, config, device="cuda")`, which returns
(recon Frame, bitstream bytes); call i sends frame i mod F of the
cell's F distinct frames.

What the window produced is held to the plain reference (`plainref/`):
the first call of `frames_checked` of the distinct frames, drawn from
the seed (its recon, and the levels, modes and CTB SAO parameters it
handed the bitstream writer), against the reference's own encode of
that frame; the bytes of `streams_checked` of those against the
reference's bitstream of the reference's levels; and a sample of the
later calls, drawn from the seed, against the first call of the same
frame (their samples and bytes count with the others).  Every number
compared has the limit 0.
"""

from __future__ import annotations

import importlib
import sys
import time

import numpy as np
import torch

PLANES = ("Y", "U", "V")
# Kept later calls: one in REPEAT_STRIDE, at an offset drawn from the seed.
REPEAT_STRIDE = 16

_WF = "nanohevc_tpu_torch.models.wavefront"
_BS = "nanohevc_tpu_torch.runtime.bitstream"
# Kernel wrappers whose `.launches` counters the entry reads.
_KERNEL_MODULES = ("wavefront_rd", "wavefront", "loop_filter", "decode",
                   "slab_pipeline", "mode_search", "fused_pipeline")


class _Capture:
    """Wraps the bitstream writer the frame API looks up at call time
    and keeps, while armed, the levels, modes and CTB SAO parameters of
    the frame it writes."""

    def __init__(self):
        self.mod = importlib.import_module(_BS)
        self.orig = self.mod.assemble_bitstream
        self.armed = False
        self.last = None

        def assemble(*args, **kwargs):
            if self.armed:
                self.last = (args[3], args[4], kwargs.get("sao_ctb"))
            return self.orig(*args, **kwargs)

        self.mod.assemble_bitstream = assemble

    def close(self):
        self.mod.assemble_bitstream = self.orig


class Entry:
    def __init__(self, config: dict, work: dict, frames: list, device: str,
                 seed: int):
        from nanohevc_tpu_torch.config import EncoderConfig
        from nanohevc_tpu_torch.frame import Frame, Plane

        self.wf = importlib.import_module(_WF)
        self.settings = dict(config["encoder"], qp=int(work["qp"]))
        self.config = EncoderConfig(**self.settings)
        self.work = work
        self.raw = frames
        self.frames = [Frame(*(Plane(p) for p in f)) for f in frames]
        self.device = device
        self.seed = seed
        self.repeat_offset = int(np.random.default_rng([seed, 1]).integers(
            REPEAT_STRIDE))
        self.capture = _Capture()

    # --- the timed path -------------------------------------------------

    def __call__(self, i: int):
        self.capture.armed = i < len(self.frames)
        self.capture.last = None
        recon, bits = self.wf.encode_frame_closed_loop(
            self.frames[i % len(self.frames)], self.config, device=self.device)
        return recon, bits, self.capture.last

    def warm_up(self) -> None:
        """One frame call: builds and loads every kernel and library the
        window runs, at the cell's shapes."""
        self(len(self.frames))

    def keep(self, i: int) -> bool:
        return (i < len(self.frames)
                or i % REPEAT_STRIDE == self.repeat_offset)

    # --- what the trace reads -------------------------------------------

    def spans(self) -> list:
        """(module, attribute, span) of each layer the program looks up
        at call time."""
        return [
            (_WF, "encode_plane_closed_loop", "plane"),
            (_WF, "wavefront_rd_encode_planes", "rd_kernel"),
            (_WF, "deblock_planes", "deblock"),
            (_WF, "sao_estimate", "sao_estimate"),
            (_WF, "sao_apply", "sao_apply"),
            (_BS, "assemble_bitstream", "entropy"),
        ]

    def counters(self) -> dict:
        """Every kernel wrapper's `.launches`, by qualified name."""
        out = {}
        for name in _KERNEL_MODULES:
            mod = importlib.import_module(f"nanohevc_tpu_torch.kernels.{name}")
            for attr, fn in vars(mod).items():
                if callable(fn) and isinstance(getattr(fn, "launches", None),
                                               int):
                    out[f"{name}.{attr}"] = fn.launches
        return out

    def release(self) -> None:
        self.capture.close()

    # --- the check --------------------------------------------------------

    def checked(self, attempted: int) -> tuple:
        """(frames, streams): the distinct frames whose first call the
        reference checks, and those whose bytes it checks too, drawn
        from the seed among the frames the window reached."""
        rng = np.random.default_rng([self.seed, 2])
        count = min(len(self.frames), attempted)
        frames = sorted(rng.choice(count, min(count, int(
            self.work["frames_checked"])), replace=False).tolist())
        streams = set(frames[:int(self.work["streams_checked"])])
        return frames, streams

    def check(self, kept: dict, attempted: int) -> list:
        """(name, value, limit) of each number compared."""
        from plainref import bitstream, encoder

        t0 = time.perf_counter()
        t_streams = 0.0
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        h, w = int(self.work["height"]), int(self.work["width"])
        blocks = samples = tiles = streams = 0
        ids, sampled = self.checked(attempted)
        refs = encoder.encode_frames([self.raw[f] for f in ids],
                                     self.settings, self.device) if ids else []
        for f, ref in zip(ids, refs):
            out = kept.get(f)
            if out is None or out[2] is None:
                blocks += sum(len(ref["modes"][p]) for p in PLANES)
                continue
            recon, bits, (levels, modes, sao) = out
            for p, plane in zip(PLANES, (recon.y, recon.u, recon.v)):
                samples += _differ(plane.data, ref["recon"][p])
                blocks += _blocks_differ(levels[p], modes[p],
                                         ref["levels"][p], ref["modes"][p])
                tiles += _tiles_differ((sao or {}).get(p), ref["sao_ctb"][p])
            if f in sampled:
                t1 = time.perf_counter()
                want = bitstream.assemble(w, h, self.settings, ref["levels"],
                                          ref["modes"], ref["sao_ctb"])
                streams += int(bits != want)
                t_streams += time.perf_counter() - t1
        # Later calls: each frame's output again, sample for sample and
        # byte for byte.
        later = 0
        for i, out in kept.items():
            first = kept.get(i % len(self.frames))
            if i < len(self.frames) or out is None or first is None:
                continue
            later += 1
            streams += int(out[1] != first[1])
            samples += sum(_differ(a.data, b.data) for a, b in zip(
                (out[0].y, out[0].u, out[0].v),
                (first[0].y, first[0].u, first[0].v)))
        print(f"reference: {len(ids)} frames and {len(sampled)} streams in "
              f"{time.perf_counter() - t0:.1f} s ({t_streams:.1f} s of it "
              f"the streams); {later} later calls against their frame's "
              "first", file=sys.stderr)
        return [("blocks_differing", blocks, 0),
                ("samples_differing", samples, 0),
                ("sao_tiles_differing", tiles, 0),
                ("streams_differing", streams, 0)]


def _differ(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return int(max(a.size, b.size))
    return int(np.count_nonzero(a != b))


def _blocks_differ(levels, modes, ref_levels, ref_modes) -> int:
    """Blocks whose mode or any level differs from the reference's."""
    lev, n = levels
    ref_lev, ref_n = ref_levels
    lev, modes = np.asarray(lev), np.asarray(modes)
    if n != ref_n or lev.shape != ref_lev.shape or modes.shape != ref_modes.shape:
        return int(ref_modes.size)
    return int(np.count_nonzero((lev != ref_lev).any(axis=1)
                                | (modes != ref_modes)))


def _tiles_differ(params, ref) -> int:
    """SAO tiles whose type, band or offsets differ."""
    nty, ntx = np.asarray(ref[1]).shape
    if params is None or params[0] != ref[0]:
        return nty * ntx
    t, b, o = (np.asarray(x) for x in params[1:])
    rt, rb, ro = ref[1:]
    if t.shape != rt.shape or o.shape != ro.shape:
        return nty * ntx
    return int(np.count_nonzero((t != rt) | (b != rb) | (o != ro).any(-1)))
