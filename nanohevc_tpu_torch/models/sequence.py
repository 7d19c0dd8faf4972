"""Multi-frame sequence encoder with checkpoint/resume, and its decoder,
port of `nanohevc_tpu/models/sequence.py`.

A YUV420p sequence is encoded in device batches of frames, levels
stream to the host entropy stage, and the bitstream grows one access
unit per frame:

  [VPS][SPS][PPS]  then per frame:  [AUD(frame_idx)][SAO][slice Y][U][V]

(the SAO NAL where the configuration signals SAO or CTB SAO).  The
bytes, the resume sidecar (`<bitstream>.progress`, JSON with
frames_done, bytes_written and the rate-control qp) and the decoded
pixels equal the JAX package's, so a sequence begun by one package can
be resumed by the other.

`SequenceEncoder` is the runner: frames are pushed into it one at a
time, as into x265's `x265_encoder_encode`, and it hands back each
frame's access unit once the frame is coded:

    enc = SequenceEncoder(config, width, height, batch=8,
                          closed_loop=True)
    out.write(enc.header)                  # VPS, SPS, PPS
    for planes in frames + [None]:         # None: the end, flush()
        for drained in (enc.push(*planes) if planes else enc.flush()):
            for index, unit in drained.units:
                out.write(unit)            # AUD + SAO NAL + slices

A push only stages its frame until a batch is full; the push that fills
batch i dispatches it to the device and then drains batch i - 1, so
push returns the access units of earlier frames: a frame's unit comes
back one to two batches after the frame went in (under rate control the
first batch drains as soon as it is dispatched).  Each batch drained
comes back as a `Drained`: its units, the frames done after it and the
QP of the next batch, which the resume sidecar records.  `flush()`
dispatches the staged part-batch and drains everything; a push after
it raises RuntimeError, and a second flush returns nothing.  The planes pushed
are read when their batch dispatches; they must not change before.
`encode_sequence` is the file reader, the stream writer and the resume
sidecar around it, and the CLI's `encode-seq` goes through it.

What carries over from the JAX runner, and how it looks on a card:

- Uploads ride as uint8 (from pinned memory, without blocking) and
  widen to int32 on the device.
- Ragged tail batches are padded to the full batch with copies of the
  last frame; the chroma stack is [U x batch, V x batch], so V of frame
  i is entry batch + i.
- Dispatch/drain overlap: batch i+1 is enqueued before batch i is
  drained.  PyTorch runs one stream in order, so a plain `.cpu()` of
  batch i's levels, issued after batch i+1's kernels, would wait for
  batch i+1 as well.  So at dispatch, right after batch i's kernels,
  its level headers (`ops.sparse.compact_levels`), int8 modes and PSNRs
  are computed and copied into pinned host buffers without blocking,
  and an event is recorded; drain waits on that event only, then
  fetches each level prefix (its length is in the header) on a copy
  stream ordered after the event, beside batch i+1's kernels.
- Rate control rides the same pipeline with one batch of lag, after a
  primed first batch; the QP is updated on full batches only, saved in
  the sidecar and restored on resume.
- Resume truncates the bitstream to the sidecar's byte count; a
  corrupt sidecar restarts from frame 0.

The RD tools run on both loops as in the JAX package (`rdo_cbf`,
`rdoq` and `decision="rd"` open loop; `rdoq` and `decision="rd"`
closed loop), with resume and rate control.  The in-loop filters
(deblocking, SAO, CTB SAO) run on the closed loop: each frame's SAO or
CTB-SAO parameters ride the batch's fetch and its access unit's SAO
NAL; the open loop refuses them with ValueError, as in the JAX
package.

Under a device mesh (`parallel.make_mesh`) the batches go through the
mesh encoders of `parallel.sharding`: the open loop's kernels on (frame,
space) shards, the closed loop on frame shards, as in the JAX package.
A closed-loop batch must be a multiple of the mesh's "frame" axis
(ValueError otherwise, with JAX's text).  Uploads and the pinned fetch
stay on the runner's `device`, which must be the mesh's first device,
where the encoders gather their outputs.

While a torch profiler records (`utils.tracing`), a batch's stacking,
pinning and upload up to its first launch is the span "seq.upload", a
drain's wait for its batch and its fetch the span "seq.fetch", and each
frame's parameter-set strip the span "seq.strip"; the bytes sent and
brought back count as "frame.bytes_up" and "frame.bytes_down" (the
level prefixes as copied, in `ops.sparse.fetch_levels`) and each
drain's wait for the card as "frame.waits", as the frame encoder counts
them.  The runner looks up `runtime.bitstream.assemble_bitstream` and
the batch encoders' closed loop at each call, so a wrapper put in their
place after construction sees every call.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import struct
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np
import torch

from nanohevc_tpu_torch import resolve_device
from nanohevc_tpu_torch.config import EncoderConfig
from nanohevc_tpu_torch.ops.sparse import compact_levels, fetch_levels
from nanohevc_tpu_torch.utils.tracing import (
    Stopwatch,
    count,
    span,
    throughput_stats,
)

NAL_AUD = 35


def _read_frames(path: str, width: int, height: int, start: int, count: int
                 ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (Y, U, V) uint8 planes for frames [start, start+count)."""
    fs = width * height * 3 // 2
    ys = width * height
    us = (width // 2) * (height // 2)
    with open(path, "rb") as f:
        f.seek(start * fs)
        for _ in range(count):
            buf = f.read(fs)
            if len(buf) < fs:
                return
            y = np.frombuffer(buf, np.uint8, ys).reshape(height, width)
            u = np.frombuffer(buf, np.uint8, us, ys).reshape(height // 2, width // 2)
            v = np.frombuffer(buf, np.uint8, us, ys + us).reshape(height // 2, width // 2)
            yield y, u, v


def _load_progress(
    progress_path: str, bitstream_path: str
) -> tuple[int, int, int | None]:
    """(frames_done, valid_bytes, qp) from the sidecar; (0, 0, None) if
    invalid.  qp is the rate-control state at checkpoint time (None for
    fixed-QP runs or older sidecars)."""
    try:
        with open(progress_path) as f:
            p = json.load(f)
        size = os.path.getsize(bitstream_path)
        if p["bytes_written"] <= size:
            saved_qp = p.get("qp")
            return (
                int(p["frames_done"]),
                int(p["bytes_written"]),
                int(saved_qp) if saved_qp is not None else None,
            )
    except (OSError, KeyError, ValueError):
        pass
    return 0, 0, None


@dataclass
class SequenceResult:
    frames: int
    resumed_from: int
    bytes_written: int
    mean_psnr_y: float
    stats: dict


@dataclass
class Drained:
    """One batch drained by `SequenceEncoder`: its access units,
    [(frame index, AUD + SAO NAL + slices)] in frame order, the frames
    done after it, and the QP of the next batch."""
    units: list
    frames_done: int
    qp: int


def _upload(frames: np.ndarray, dev: torch.device) -> torch.Tensor:
    """(F, H, W) uint8 host stack -> int32 on `dev`, widened there."""
    t = torch.from_numpy(frames)
    count("frame.bytes_up", t.nbytes)
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return t.to(torch.int32)


class _BatchFetch:
    """The device-to-host side of one dispatched batch (see the module
    docstring): created right after the batch's kernels are enqueued,
    drained by `fetch`."""

    def __init__(self, y_out: dict, c_out: dict, dev: torch.device):
        self.dense = (y_out["levels"], c_out["levels"])
        small = {
            "y_header": compact_levels(y_out["levels"])["header"],
            "c_header": compact_levels(c_out["levels"])["header"],
            "y_modes": y_out["modes"].to(torch.int8),
            "c_modes": c_out["modes"].to(torch.int8),
            "psnr": y_out["psnr"],
        }
        # The filters' per-frame parameters, as (plane kind, filter, i).
        self.filters = [(tag, kind, len(o[kind]))
                        for tag, o in (("y", y_out), ("c", c_out))
                        for kind in ("sao", "sao_ctb") if kind in o]
        for tag, kind, n in self.filters:
            out = y_out if tag == "y" else c_out
            small.update({(tag, kind, i): out[kind][i] for i in range(n)})
        self.event = None
        if dev.type == "cuda":
            small = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                     .copy_(v, non_blocking=True) for k, v in small.items()}
            self.event = torch.cuda.Event()
            self.event.record()
        self.small = small

    def fetch(self, copy_stream) -> tuple:
        """(y_levels, y_modes, c_levels, c_modes, psnr, filters) as host
        ndarrays (filters: {("y" or "c", "sao" or "sao_ctb"): tuple of
        arrays}), waiting for this batch's event and nothing enqueued
        after it."""
        with span("seq.fetch"):
            ctx = contextlib.nullcontext()
            if self.event is not None:
                self.event.synchronize()
                copy_stream.wait_event(self.event)
                ctx = torch.cuda.stream(copy_stream)
            count("frame.waits", 1)
            count("frame.bytes_down",
                  sum(v.nbytes for v in self.small.values()))
            with ctx:
                # The prefix slice and its copy run on the copy stream
                # and end before fetch_levels returns, so the dense
                # tensors are free for reuse once this batch is dropped.
                y_levels, c_levels = (
                    fetch_levels({"header": self.small[k]}, tuple(d.shape),
                                 dense=d)
                    for k, d in zip(("y_header", "c_header"), self.dense))
            filters = {(tag, kind): tuple(self.small[tag, kind, i].numpy()
                                          for i in range(n))
                       for tag, kind, n in self.filters}
            return (y_levels, self.small["y_modes"].numpy().astype(np.int32),
                    c_levels, self.small["c_modes"].numpy().astype(np.int32),
                    self.small["psnr"].numpy(), filters)


class SequenceEncoder:
    """A sequence's encoder that frames are pushed into (see the module
    docstring for the pipeline and its delay).

    closed_loop=True uses the reconstruction-fed wavefront encoder, so
    the stream is pixel-exactly decodable (decode_sequence); open loop
    (default) matches reference semantics and is faster.  target_bpp
    enables one-pass rate control: a RateController
    (models/rate_control.py) adjusts QP between batches to average
    `target_bpp` bits per luma pixel, seeded with config.qp (or `qp`);
    per-slice qp fields carry the schedule to the decoder.  batch i's
    coded size sets batch i+2's QP (i+1 is already in flight when i
    drains), after a primed first batch; the kernels take each batch's
    QP at launch.  `start` and `qp` resume a sequence: the index of its
    next frame and the controller's QP at the checkpoint.  Runs on
    `device` ("cuda" by default; "cpu" runs the kernels' plain
    versions), under `mesh` where given.

    `header` is the sequence's VPS, SPS and PPS; `push` and `flush`
    return a `Drained` for each batch they drained, in frame order, its
    units without parameter sets.  `qp` is the QP of the next batch and
    `frames_done` the frames whose units were returned.  `stopwatch`
    times the "dispatch", "fetch" and "entropy" stages and `psnrs`
    holds each coded frame's luma PSNR.
    """

    def __init__(self, config: EncoderConfig, width: int, height: int, *,
                 batch: int = 8, closed_loop: bool = False, mesh=None,
                 target_bpp: float | None = None, entropy_tiles: int = 1,
                 device: str | torch.device = "cuda", start: int = 0,
                 qp: int | None = None):
        from nanohevc_tpu_torch.parallel.mesh import canonical_device
        from nanohevc_tpu_torch.parallel.sharding import (
            make_batch_encoder,
            make_closed_loop_encoder,
        )
        from nanohevc_tpu_torch.runtime import entropy
        from nanohevc_tpu_torch.runtime.bitstream import (
            _ENTROPY_IDX,
            _SCAN_IDX,
        )

        dev = resolve_device(device)
        if mesh is not None and canonical_device(dev) != mesh.devices.flat[0]:
            raise ValueError(
                f"device {str(dev)!r} is not the mesh's first device "
                f"{str(mesh.devices.flat[0])!r}, where the mesh encoders "
                "gather their outputs")
        if (config.deblock or config.sao or config.sao_ctb) and not closed_loop:
            # the signalled filters would make the decoder transform a
            # reconstruction the open-loop encoder never produced -- refuse
            raise ValueError("config.deblock/config.sao/config.sao_ctb "
                             "require closed_loop=True (in-loop filters on "
                             "the decodable recon)")
        if closed_loop:
            if mesh is not None:
                # the luma batch and the 2*batch chroma stack must divide
                # the mesh's 'frame' axis
                f_axis = mesh.shape["frame"]
                if batch % f_axis:
                    raise ValueError(
                        f"closed-loop sequence batch {batch} must be a "
                        f"multiple of the mesh 'frame' axis ({f_axis})"
                    )
            self._luma = make_closed_loop_encoder(config, mesh, is_luma=True)
            self._chroma = make_closed_loop_encoder(config, mesh,
                                                    is_luma=False)
        else:
            rc = target_bpp is not None
            self._luma = make_batch_encoder(config, mesh, is_luma=True,
                                            honor_runtime_qp=rc)
            self._chroma = make_batch_encoder(config, mesh, is_luma=False,
                                              honor_runtime_qp=rc)
        self.config, self.width, self.height = config, width, height
        self.batch, self.entropy_tiles, self.dev = batch, entropy_tiles, dev
        self.qp = config.qp if qp is None else qp
        self.controller = None
        if target_bpp is not None:
            from nanohevc_tpu_torch.models.rate_control import RateController

            self.controller = RateController(
                target_bits=target_bpp * width * height * batch, qp=self.qp)

        def params(which: int) -> bytes:
            return entropy.write_params(
                width, height, config.block_size, config.qp, which,
                bit_depth=config.bit_depth,
                scan_idx=_SCAN_IDX[config.scan],
                rescale_flag=int(config.dequant_rescale),
                smoothing_flag=int(config.intra_smoothing),
                entropy_idx=_ENTROPY_IDX[config.entropy_coder],
                deblock_flag=int(config.deblock),
                mode_mpm_flag=1,  # per-frame slices code modes with MPM
                # every frame must then carry its SAO NAL or fail decode
                sao_flag=int(config.sao or config.sao_ctb),
            )

        self.header = b"".join(entropy.wrap_nal(t, params(which))
                               for which, t in enumerate((
                                   entropy.NAL_VPS, entropy.NAL_SPS,
                                   entropy.NAL_PPS)))
        self.frames_done = start
        self.stopwatch = Stopwatch()
        self.psnrs: List[float] = []
        self._next = start              # index of the next frame pushed
        self._staged: list = []
        self._pending = None            # the dispatched, undrained batch
        self._primed = self.controller is None
        self._flushed = False
        self._copy_stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                             else None)

    def push(self, y, u, v) -> List[Drained]:
        """Stage one frame's planes (uint8, or int16 holding 8-bit
        samples); returns the batches drained meanwhile."""
        if self._flushed:
            raise RuntimeError("push after flush(): the sequence has ended")
        self._staged.append((y, u, v))
        if len(self._staged) < self.batch:
            return []
        return self._cycle()

    def flush(self) -> List[Drained]:
        """Dispatch the staged part-batch, padded with copies of its last
        frame, and drain everything; returns the batches drained.  The
        sequence ends here."""
        drained = self._cycle() if self._staged else []
        if self._pending is not None:
            drained.append(self._drain(self._pending))
            self._pending = None
        self._flushed = True
        return drained

    def _cycle(self) -> List[Drained]:
        """Dispatch the staged batch, then drain the one before it; the
        first batch under rate control drains at once (the primed
        feedback loop corrects a badly seeded QP after one batch)."""
        batch = self._dispatch()
        drained = ([self._drain(self._pending)]
                   if self._pending is not None else [])
        self._pending = batch
        if not self._primed:
            self._primed = True
            drained.append(self._drain(batch))
            self._pending = None
        return drained

    def _dispatch(self) -> tuple:
        """Upload and enqueue the staged frames as one device batch."""
        planes, self._staged = self._staged, []
        first, take = self._next, len(planes)
        self._next += take
        padded = planes + [planes[-1]] * (self.batch - take)
        with self.stopwatch.time("dispatch"):
            with span("seq.upload"):
                ys = _upload(np.stack([p[0] for p in padded]), self.dev)
                uvs = _upload(np.stack([p[1] for p in padded]
                                       + [p[2] for p in padded]), self.dev)
            y_out = self._luma(ys, self.qp)
            c_out = self._chroma(uvs, self.qp)
            fetch = _BatchFetch(y_out, c_out, self.dev)
        return first, take, self.qp, fetch

    def _drain(self, pending: tuple) -> Drained:
        """Fetch a finished batch and entropy-code its frames."""
        from nanohevc_tpu_torch.runtime import bitstream, entropy

        first, take, batch_qp, fetch = pending
        config, batch = self.config, self.batch
        with self.stopwatch.time("fetch"):
            y_levels, y_modes, c_levels, c_modes, psnr, filters = (
                fetch.fetch(self._copy_stream))
            self.psnrs.extend(float(v) for v in psnr[:take])
        units = []
        with self.stopwatch.time("entropy"):
            cb = config.chroma_block_size()
            for i in range(take):
                sao_i = sao_ctb_i = None
                if config.sao:
                    y_sao, c_sao = filters["y", "sao"], filters["c", "sao"]
                    sao_i = {
                        "Y": tuple(a[i] for a in y_sao),
                        "U": tuple(a[i] for a in c_sao),
                        "V": tuple(a[batch + i] for a in c_sao),
                    }
                if config.sao_ctb:
                    t_ = config.sao_tile
                    y_ctb = filters["y", "sao_ctb"]
                    c_ctb = filters["c", "sao_ctb"]
                    sao_ctb_i = {
                        "Y": (t_,) + tuple(a[i] for a in y_ctb),
                        "U": (t_,) + tuple(a[i] for a in c_ctb),
                        "V": (t_,) + tuple(a[batch + i] for a in c_ctb),
                    }
                frame_bs = bitstream.assemble_bitstream(
                    self.width,
                    self.height,
                    batch_qp,
                    {
                        "Y": (y_levels[i], config.block_size),
                        "U": (c_levels[i], cb),
                        "V": (c_levels[batch + i], cb),
                    },
                    {
                        "Y": y_modes[i],
                        "U": c_modes[i],
                        "V": c_modes[batch + i],
                    },
                    scan=config.scan,
                    entropy_tiles=self.entropy_tiles,
                    entropy_coder=config.entropy_coder,
                    sao=sao_i,
                    sao_ctb=sao_ctb_i,
                )
                # assemble_bitstream repeats parameter sets per call;
                # strip them here (sequence carries one global set)
                aud = entropy.wrap_nal(
                    NAL_AUD, struct.pack("<I", first + i))
                units.append((first + i, aud + _strip_param_sets(frame_bs)))
        if self.controller is not None and take == batch:
            self.qp = self.controller.update(
                8 * sum(len(unit) for _, unit in units))
        self.frames_done = first + take
        return Drained(units, self.frames_done, self.qp)


def encode_sequence(
    input_path: str,
    width: int,
    height: int,
    num_frames: int,
    config: EncoderConfig,
    bitstream_path: str,
    *,
    batch: int = 8,
    resume: bool = True,
    mesh=None,
    report_every: int = 0,
    closed_loop: bool = False,
    target_bpp: float | None = None,
    entropy_tiles: int = 1,
    device: str | torch.device = "cuda",
) -> SequenceResult:
    """Encode `num_frames` frames of a YUV420p file to a bitstream.

    The frames go through a `SequenceEncoder` (closed loop, rate
    control, mesh and device as it takes them); this reads the file a
    batch at a time, writes the header and each access unit, and the
    sidecar after each drained batch.  With `resume`, a valid sidecar
    continues the sequence from its frame count, its byte count and its
    QP.
    """
    progress_path = bitstream_path + ".progress"
    start, valid_bytes, saved_qp = (0, 0, None)
    if resume:
        start, valid_bytes, saved_qp = _load_progress(
            progress_path, bitstream_path
        )
    start = min(start, num_frames)
    resumed_qp = saved_qp if start > 0 else None
    enc = SequenceEncoder(
        config, width, height, batch=batch, closed_loop=closed_loop,
        mesh=mesh, target_bpp=target_bpp, entropy_tiles=entropy_tiles,
        device=device, start=start,
        qp=resumed_qp if target_bpp is not None else None)

    mode_flags = "r+b" if (start > 0 and os.path.exists(bitstream_path)) else "wb"
    t_run = time.perf_counter()
    with open(bitstream_path, mode_flags) as out:
        if start > 0:
            out.truncate(valid_bytes)
            out.seek(valid_bytes)
        else:
            out.write(enc.header)

        def emit(drained: List[Drained]) -> None:
            """Write each batch's units, then its sidecar."""
            for d in drained:
                out.write(b"".join(unit for _, unit in d.units))
                out.flush()
                with open(progress_path, "w") as pf:
                    json.dump({"frames_done": d.frames_done,
                               "bytes_written": out.tell(), "qp": d.qp}, pf)
                if report_every and (d.frames_done - start) % report_every == 0:
                    print(f"  frame {d.frames_done}/{num_frames}", flush=True)

        if start < num_frames:
            frames = _read_frames(input_path, width, height, start,
                                  num_frames - start)
            while True:
                with enc.stopwatch.time("load"):
                    chunk = list(itertools.islice(frames, batch))
                for planes in chunk:
                    emit(enc.push(*planes))
                if len(chunk) < batch:
                    break
            emit(enc.flush())
        bytes_written = out.tell()

    done = enc.frames_done
    wall = time.perf_counter() - t_run
    stats = enc.stopwatch.report()
    stats["throughput"] = throughput_stats(
        (done - start) * width * height * 3 // 2, wall
    )
    if enc.controller is not None and done > start:
        stats["rate_control"] = {
            "target_bpp": target_bpp,
            "achieved_bpp": (bytes_written - valid_bytes) * 8
            / ((done - start) * width * height),
            "qp_start": config.qp if resumed_qp is None else resumed_qp,
            "qp_final": enc.qp,
        }
    return SequenceResult(
        frames=done,
        resumed_from=start,
        bytes_written=bytes_written,
        mean_psnr_y=float(np.mean(enc.psnrs)) if enc.psnrs else float("nan"),
        stats=stats,
    )


def _strip_param_sets(frame_bs: bytes) -> bytes:
    """Drop VPS/SPS/PPS NALs from a single-frame bitstream blob."""
    from nanohevc_tpu_torch.runtime import entropy
    from nanohevc_tpu_torch.runtime.bitstream import _split_nals

    with span("seq.strip"):
        out = []
        # re-wrap surviving NALs (payloads round-trip through
        # unescape/escape)
        for nal_type, payload in _split_nals(frame_bs):
            if nal_type in (32, 33, 34):
                continue
            out.append(entropy.wrap_nal(nal_type, payload))
        return b"".join(out)


def decode_sequence(bitstream_path: str, output_path: str, *,
                    device: str | torch.device = "cuda") -> int:
    """Pixel-exact decode of a closed-loop sequence bitstream to YUV420p.

    Geometry and QP come from the stream's parameter sets.  Returns the
    number of frames written.  Frames decode in chunks of 8 through
    `decode_planes` with per-frame slice QPs and SAO or CTB-SAO
    parameters (identity for a frame without them), or one by one where
    a chunk mixes block sizes.  (Streams produced with closed_loop=False
    parse but do not decode to the encoder's pixels -- open-loop
    prediction reads source neighbours a decoder does not have.)
    """
    from nanohevc_tpu_torch.models.wavefront import decode_plane, decode_planes
    from nanohevc_tpu_torch.runtime import entropy as E
    from nanohevc_tpu_torch.runtime.bitstream import (
        _SCAN_NAME,
        _split_nals,
        parse_params,
    )
    from nanohevc_tpu_torch.runtime.entropy import CorruptBitstreamError

    dev = resolve_device(device)
    with open(bitstream_path, "rb") as f:
        data = f.read()
    params: dict = {}
    for nal_type, payload in _split_nals(data):
        if nal_type in (E.NAL_SPS, E.NAL_PPS):
            try:
                params.update(parse_params(payload))
            except ValueError:
                continue            # skip corrupted parameter sets
    if not {"width", "height", "qp"} <= params.keys():
        raise CorruptBitstreamError(
            "no usable SPS/PPS in sequence stream (not a nanohevc "
            "bitstream, or parameter sets corrupted)"
        )
    width, height, qp = params["width"], params["height"], params["qp"]
    bit_depth = 8 + params.get("bit_depth_luma_minus8", 0)
    scan = _SCAN_NAME[params.get("scan_idx", 0)]
    rescale = params.get("dequant_rescale", False)
    smoothing = params.get("intra_smoothing", False)
    deblock = params.get("deblock", False)

    frames = decode_sequence_levels(bitstream_path)
    n_written = 0
    dt = np.uint8 if bit_depth <= 8 else np.dtype("<u2")
    batch = 8
    with open(output_path, "wb") as out:
        for b0 in range(0, len(frames), batch):
            chunk = frames[b0: b0 + batch]
            for fi, fr in enumerate(chunk):
                p = fr.get("params", {})
                if p.get("sao_enabled") and not (
                    p.get("sao") or p.get("sao_ctb")
                ):
                    # the global PPS promised per-frame SAO; a frame
                    # whose SAO NAL was dropped must fail loudly
                    raise CorruptBitstreamError(
                        f"PPS signals SAO but frame {b0 + fi} has no "
                        "SAO NAL (truncated or corrupted stream)"
                    )
            planes_out = {}
            for name, (h, w) in (
                ("Y", (height, width)),
                ("U", (height // 2, width // 2)),
                ("V", (height // 2, width // 2)),
            ):
                sls = [fr[name] for fr in chunk]
                kw = dict(height=h, width=w, bit_depth=bit_depth, scan=scan,
                          dequant_rescale=rescale,
                          intra_smoothing=smoothing and name == "Y",
                          deblock=deblock, is_chroma=name != "Y")
                sao_b, sao_ctb_b = _chunk_sao(chunk, name)
                bs = sls[0]["block_size"]
                if any(s["block_size"] != bs for s in sls):
                    # mixed per-slice block sizes: decode singly
                    planes_out[name] = [
                        decode_plane(
                            torch.from_numpy(np.ascontiguousarray(s["levels"])).to(dev),
                            torch.from_numpy(np.ascontiguousarray(s["modes"])).to(dev),
                            s.get("qp", qp), n=s["block_size"],
                            use_dst=(name == "Y" and s["block_size"] == 4),
                            sao=None if sao_b is None
                            else tuple(a[j] for a in sao_b),
                            sao_ctb=None if sao_ctb_b is None
                            else (sao_ctb_b[0],) + tuple(
                                a[j] for a in sao_ctb_b[1:]),
                            **kw,
                        ).cpu().numpy().astype(dt) for j, s in enumerate(sls)
                    ]
                    continue
                recon = decode_planes(
                    torch.from_numpy(np.stack([s["levels"] for s in sls])).to(dev),
                    torch.from_numpy(np.stack([s["modes"] for s in sls])).to(dev),
                    [s.get("qp", qp) for s in sls],
                    n=bs, use_dst=(name == "Y" and bs == 4),
                    sao=sao_b, sao_ctb=sao_ctb_b, **kw,
                )
                planes_out[name] = list(recon.cpu().numpy().astype(dt))
            for i in range(len(chunk)):
                for name in ("Y", "U", "V"):
                    out.write(np.asarray(planes_out[name][i], dtype=dt).tobytes())
                n_written += 1
    return n_written


def _chunk_sao(chunk: list, name: str) -> tuple:
    """The chunk's per-frame SAO parameters of plane `name`, stacked:
    (sao, sao_ctb) as `decode_planes` takes them, None where no frame
    carries any.  A frame without parameters gets the identity (type 0
    per frame, all-off maps for CTB SAO), so the chunk still decodes in
    one call."""
    saos = [fr.get("params", {}).get("sao", {}).get(name) for fr in chunk]
    sao_b = None
    if any(s is not None for s in saos):
        off = (0, 0, np.zeros(4, np.int32))
        filled = [s if s is not None else off for s in saos]
        sao_b = (np.array([s[0] for s in filled], np.int32),
                 np.array([s[1] for s in filled], np.int32),
                 np.stack([np.asarray(s[2], np.int32) for s in filled]))
    ctbs = [fr.get("params", {}).get("sao_ctb", {}).get(name) for fr in chunk]
    sao_ctb_b = None
    if any(c is not None for c in ctbs):
        tile = next(c[0] for c in ctbs if c is not None)
        shape = next(np.asarray(c[1]).shape for c in ctbs if c is not None)
        zero = (tile, np.zeros(shape, np.int32), np.zeros(shape, np.int32),
                np.zeros(shape + (4,), np.int32))
        filled = [c if c is not None else zero for c in ctbs]
        sao_ctb_b = (tile,) + tuple(
            np.stack([np.asarray(c[k], np.int32) for c in filled])
            for k in (1, 2, 3))
    return sao_b, sao_ctb_b


def decode_sequence_levels(bitstream_path: str) -> List[Dict[str, dict]]:
    """Parse a sequence bitstream back to per-frame plane level dicts."""
    from nanohevc_tpu_torch.runtime import entropy as E
    from nanohevc_tpu_torch.runtime.bitstream import _split_nals, parse_bitstream

    with open(bitstream_path, "rb") as f:
        data = f.read()

    # split into access units on AUD NALs; the sequence's single global
    # parameter-set group is replayed in front of every frame so each
    # parse sees the SPS geometry bound and the PPS entropy/scan flags
    frames: List[Dict[str, dict]] = []
    current: List[bytes] = []
    param_nals: List[bytes] = []
    for nal_type, payload in _split_nals(data):
        if nal_type == NAL_AUD:
            if current:
                frames.append(
                    parse_bitstream(b"".join(param_nals + current))
                )
            current = []
        elif nal_type in (E.NAL_VPS, E.NAL_SPS, E.NAL_PPS):
            param_nals.append(E.wrap_nal(nal_type, payload))
        elif nal_type in (E.NAL_SLICE, E.NAL_SAO):
            # SAO parameters are per-frame: they ride each access unit
            current.append(E.wrap_nal(nal_type, payload))
    if current:
        frames.append(parse_bitstream(b"".join(param_nals + current)))
    return frames
