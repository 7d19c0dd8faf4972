"""Entry `sequence`: one producer pushes raw 4:2:0 frames, one a call,
into one sequence of the port's push-style sequence encoder,
`nanohevc_tpu_torch.models.sequence.SequenceEncoder(config, width,
height, batch=..., closed_loop=..., device="cuda")`, as the
configuration's `sequence` block sets them; call i pushes frame i mod F
of the cell's F distinct frames, as uint8 planes (as a YUV file holds
them).

Set-up makes the encoder and pushes the F frames once (frames 0 to F -
1 of the sequence), which builds and loads every kernel at the batch's
shapes; the window's calls go on pushing into the same sequence, so
window call i is frame F + i.  A push only stages its frame until a
batch is full; the push that fills a batch dispatches it to the card
and drains the batch before, whose access units it returns.  The frames
still in the pipeline when the window ends, at most two batches, count
as done: they are coded after the window, outside it, when the entry is
released, for the check.

What the window produced is held to the plain reference (`plainref/`),
every number with the limit 0: `frames_checked` of the first F window
frames, drawn from the seed one from each batch slot in turn (a frame's
slot is its index in the sequence modulo the batch: luma plane i and
chroma planes i and batch + i of its batch), so that 8 frames at batch
8 cover every slot, by the levels, modes and CTB SAO
parameters the runner handed the bitstream writer, against
`plainref/encoder.py::encode_frames` of the same content
(`blocks_differing`, `sao_tiles_differing`); and by bytes
(`streams_differing`): the sequence's header against
`plainref/sequence.py`'s, the access units of `streams_checked` of
those frames, each of another slot, against the reference's access
units of the reference's levels, and one later frame in 16, at an offset drawn from the seed,
against the first window frame of the same content (the bytes after the
delimiter, whose frame index differs).  The sequence path returns no
recon: the samples follow from the bytes, through the port's decoder,
which the port's CPU tests hold pixel-exact to the encoder's recon.

`benchmark/control.py` puts its outputs in the program's place through
`check`'s `kept` (a window keeps nothing there): a frame's levels,
modes, CTB SAO and single-frame stream, whose parameter sets give way
to the frame's delimiter.
"""

from __future__ import annotations

import importlib
import itertools
import sys
import time

import numpy as np
import torch

from benchlib import spec

frame = spec.load_module("entries", "frame")

_SEQ = "nanohevc_tpu_torch.models.sequence"
_SHARDING = "nanohevc_tpu_torch.parallel.sharding"


class _Capture:
    """Wraps the bitstream writer the runner looks up at each call.  The
    runner writes the frames of a sequence in order, one call each, so
    the n-th call is frame n; the capture keeps the levels, modes and
    CTB SAO parameters handed to it for the frames in `frames`."""

    def __init__(self, frames: range):
        self.mod = importlib.import_module(frame._BS)
        self.orig = self.mod.assemble_bitstream
        self.frames = frames
        self.calls = 0
        self.kept = {}

        def assemble(*args, **kwargs):
            if self.calls in self.frames:
                self.kept[self.calls] = (args[3], args[4],
                                         kwargs.get("sao_ctb"))
            self.calls += 1
            return self.orig(*args, **kwargs)

        self.mod.assemble_bitstream = assemble

    def close(self):
        self.mod.assemble_bitstream = self.orig


class Entry:
    def __init__(self, config: dict, work: dict, frames: list, device: str,
                 seed: int):
        from nanohevc_tpu_torch.config import EncoderConfig

        # The runner's class, looked up at set-up: a program without it
        # fails here, before any frame is pushed.
        encoder_cls = importlib.import_module(_SEQ).SequenceEncoder
        self.settings = dict(config["encoder"], qp=int(work["qp"]))
        self.work = work
        self.raw = frames
        self.frames = [tuple(p.astype(np.uint8) for p in f) for f in frames]
        self.height, self.width = int(work["height"]), int(work["width"])
        self.device = device
        self.seed = seed
        self.repeat_offset = int(np.random.default_rng([seed, 1]).integers(
            frame.REPEAT_STRIDE))
        self.warm = len(frames)          # frames pushed by the warm-up
        self.batch = int(config["sequence"]["batch"])
        self.encoder = encoder_cls(
            EncoderConfig(**self.settings), self.width, self.height,
            batch=self.batch,
            closed_loop=bool(config["sequence"]["closed_loop"]),
            device=device)
        self.capture = _Capture(range(self.warm, 2 * self.warm))
        self.units = {}                  # window frame -> access unit

    # --- the timed path -------------------------------------------------

    def __call__(self, i: int):
        drained = self.encoder.push(*self.frames[i % len(self.frames)])
        self._file(drained)
        return drained

    def _file(self, drained: list) -> None:
        """Keep the access units of the window frames the check reads."""
        for index, unit in (u for d in drained for u in d.units):
            f = index - self.warm
            if f >= 0 and (f < len(self.frames)
                           or f % frame.REPEAT_STRIDE == self.repeat_offset):
                self.units[f] = unit

    def warm_up(self) -> None:
        """The F frames pushed once, into the sequence the window goes
        on with: every batch shape the window runs, built and loaded."""
        for planes in self.frames:
            self.encoder.push(*planes)

    def keep(self, i: int) -> bool:
        """No call's output is kept by the call: a push returns earlier
        frames' units, which the entry files by frame itself."""
        return False

    # --- what the trace reads -------------------------------------------

    def spans(self) -> list:
        """(module, attribute, span) of each layer the program looks up
        at call time."""
        return [
            (_SHARDING, "encode_planes_closed_loop", "batch"),
            (frame._WF, "wavefront_rd_encode_planes", "rd_kernel"),
            (frame._WF, "deblock_planes", "deblock"),
            (frame._WF, "sao_estimate", "sao_estimate"),
            (frame._WF, "sao_apply", "sao_apply"),
            (frame._BS, "assemble_bitstream", "entropy"),
        ]

    counters = frame.Entry.counters

    def release(self) -> None:
        """Code the frames still in the pipeline, then put the bitstream
        writer back."""
        self._file(self.encoder.flush())
        self.capture.close()

    # --- the check --------------------------------------------------------

    def checked(self, attempted: int) -> tuple:
        """(frames, streams): `frames_checked` of the first F window
        frames (those the window reached), drawn from the seed a slot at
        a time, each slot's in random order and the slots in random
        order; the first `streams_checked` drawn, of distinct slots
        where there are enough, are checked by bytes too."""
        rng = np.random.default_rng([self.seed, 2])
        count = min(len(self.frames), attempted)
        slots = [rng.permutation([f for f in range(count)
                                  if (self.warm + f) % self.batch == s])
                 for s in rng.permutation(self.batch)]
        drawn = [int(f) for turn in itertools.zip_longest(*slots)
                 for f in turn if f is not None]
        drawn = drawn[:int(self.work["frames_checked"])]
        return sorted(drawn), set(drawn[:int(self.work["streams_checked"])])

    def check(self, kept: dict, attempted: int) -> list:
        """(name, value, limit) of each number compared; `kept` holds
        the control's outputs, where it runs."""
        from plainref import encoder, sequence

        t0 = time.perf_counter()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        h, w = self.height, self.width
        blocks = tiles = 0
        streams = int(self.encoder.header
                      != sequence.header(w, h, self.settings))
        ids, sampled = self.checked(attempted)
        refs = encoder.encode_frames([self.raw[f] for f in ids],
                                     self.settings, self.device) if ids else []
        for f, ref in zip(ids, refs):
            got = self.capture.kept.get(self.warm + f)
            unit = self.units.get(f)
            if f in kept:
                _, bits, got = kept[f]
                unit = sequence.unit_of(self.warm + f, w, h, self.settings,
                                        bits)
            if got is None:
                blocks += sum(len(ref["modes"][p]) for p in frame.PLANES)
                streams += int(f in sampled)
                continue
            levels, modes, sao = got
            for p in frame.PLANES:
                blocks += frame._blocks_differ(levels[p], modes[p],
                                               ref["levels"][p],
                                               ref["modes"][p])
                tiles += frame._tiles_differ((sao or {}).get(p),
                                             ref["sao_ctb"][p])
            if f in sampled:
                want = sequence.access_unit(
                    self.warm + f, w, h, self.settings, ref["levels"],
                    ref["modes"], ref["sao_ctb"])
                streams += int(unit != want)
        # Later frames: each against the first window frame of the same
        # content, after the delimiters.
        later = 0
        for f, unit in self.units.items():
            first_f = f % len(self.frames)
            first = self.units.get(first_f)
            if f < len(self.frames) or first is None:
                continue
            later += 1
            rest = sequence.after_delimiter(unit, self.warm + f)
            streams += int(rest is None or rest != sequence.after_delimiter(
                first, self.warm + first_f))
        print(f"reference: {len(ids)} frames and {len(sampled)} access "
              f"units in {time.perf_counter() - t0:.1f} s; {later} later "
              "frames against their content's first", file=sys.stderr)
        return [("blocks_differing", blocks, 0),
                ("sao_tiles_differing", tiles, 0),
                ("streams_differing", streams, 0)]
