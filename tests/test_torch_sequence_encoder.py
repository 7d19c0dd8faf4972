"""The port's push-style sequence encoder (`models.sequence.
SequenceEncoder`) under the benchmark's `ctc_ai_n8_seq8` configuration
(RD over 35 modes, RDOQ, smoothing, deblocking, CTB SAO, CABAC on the
mode scan, closed loop), on the CPU at a geometry that no plane kind
tiles (38x50 luma at N=8, 19x25 chroma at N=4), 5 frames at batch 2
(the last batch ragged):

- its header and access units are `encode_sequence`'s file, under a
  fixed QP and under `target_bpp`, and each push returns the batches
  of earlier frames, one batch behind (none behind under rate control's
  primed first batch);
- that file, its sidecar and its rate control are the JAX package's
  `encode_sequence` of the same frames;
- the plain reference of the sequence stream
  (`benchmark/plainref/sequence.py` over `plainref/encoder.py`) gives
  the same bytes;
- its spans and counters record only under the profiler, and
  "frame.bytes_down" is the bytes of what each drain copies;
- a push after `flush()` raises, and a flush with nothing staged
  returns nothing.
"""

import json
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import nanohevc_tpu.models.sequence as jax_seq
from nanohevc_tpu.config import EncoderConfig as JaxConfig
from nanohevc_tpu_torch.config import EncoderConfig
from nanohevc_tpu_torch.models import sequence as seq
from nanohevc_tpu_torch.ops.sparse import _bucket
from nanohevc_tpu_torch.utils import tracing

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
CONFIG = json.loads((BENCH / "configs" / "ctc_ai_n8_seq8.json").read_text())
QP = 37
SETTINGS = dict(CONFIG["encoder"], qp=QP)
H, W = 38, 50
FRAMES, BATCH = 5, 2
TARGET_BPP = 1.5


def make_frames(count, h, w, seed=5):
    """(y, u, v) uint8 planes: a ramp and a wave with flat and noisy
    patches, each frame rolled, so that blocks are smooth and
    textured."""
    rng = np.random.default_rng(seed)

    def plane(ph, pw, i):
        yy, xx = np.mgrid[0:ph, 0:pw]
        base = yy * 5 + xx * 3 + 40 * np.sin((xx + 3 * i) / 5.0)
        flat = np.kron(rng.random((ph // 8 + 1, pw // 8 + 1)) < 0.3,
                       np.ones((8, 8), bool))[:ph, :pw]
        noisy = base + rng.integers(-12, 13, (ph, pw))
        return np.clip(np.where(flat, 128, noisy), 0, 255).astype(np.uint8)

    return [(plane(h, w, i), plane(h // 2, w // 2, i),
             plane(h // 2, w // 2, i)) for i in range(count)]


def encoder(target_bpp=None):
    return seq.SequenceEncoder(EncoderConfig(**SETTINGS), W, H, batch=BATCH,
                               closed_loop=True, target_bpp=target_bpp,
                               device="cpu")


def push_all(enc, frames):
    """[the batches drained by a push] and the flush's."""
    pushed = [enc.push(*f) for f in frames]
    return pushed, enc.flush()


def units(drained):
    """The (frame index, unit) pairs of a list of drained batches."""
    return [u for d in drained for u in d.units]


@lru_cache(maxsize=None)
def file_run(target_bpp, tmp):
    """encode_sequence of the frames' YUV file, `seq.yuv` in `tmp`:
    (bytes, sidecar, the spans and counters recorded meanwhile, the
    SequenceResult)."""
    src, bits = Path(tmp) / "seq.yuv", Path(tmp) / f"seq{target_bpp}.bin"
    src.write_bytes(b"".join(p.tobytes() for f in make_frames(FRAMES, H, W)
                             for p in f))
    tracing.reset()
    res = seq.encode_sequence(str(src), W, H, FRAMES,
                              EncoderConfig(**SETTINGS), str(bits),
                              batch=BATCH, closed_loop=True,
                              target_bpp=target_bpp, device="cpu")
    recorded = (dict(tracing.SPANS.counts), dict(tracing.COUNTS))
    return (bits.read_bytes(), json.loads((Path(str(bits) + ".progress"))
                                          .read_text()), recorded, res)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("seq_encoder"))


class Drains:
    """Records what each drain copies to the host: the small outputs'
    bytes and each level prefix's, from the batch's header."""

    def __init__(self, monkeypatch):
        self.small, self.prefixes = [], []
        fetch, levels = seq._BatchFetch.fetch, seq.fetch_levels

        def counted_fetch(batch, stream):
            self.small.append(sum(v.nbytes for v in batch.small.values()))
            return fetch(batch, stream)

        def counted_levels(sparse, shape, dense=None):
            need, max_abs = (int(x) for x in sparse["header"])
            if max_abs > np.iinfo(np.int16).max:
                self.prefixes.append(dense.numel() * 4)
            elif need > 0:
                self.prefixes.append(
                    dense[..., :_bucket(need, shape[-1])].numel() * 2)
            return levels(sparse, shape, dense=dense)

        monkeypatch.setattr(seq._BatchFetch, "fetch", counted_fetch)
        monkeypatch.setattr(seq, "fetch_levels", counted_levels)


@pytest.fixture(scope="module")
def pushed_run():
    """The frames pushed as int16 planes under the profiler: (encoder,
    units a push, the flush's units, spans and counters recorded,
    what the drains copied)."""
    mp = pytest.MonkeyPatch()
    drains = Drains(mp)
    enc = encoder()
    frames = [tuple(p.astype(np.int16) for p in f)
              for f in make_frames(FRAMES, H, W)]
    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pushed, flushed = push_all(enc, frames)
    finally:
        mp.undo()
    recorded = (dict(tracing.SPANS.counts), dict(tracing.COUNTS))
    tracing.reset()
    return enc, pushed, flushed, recorded, drains


def indices(drained):
    return [i for i, _ in units(drained)]


def test_push_returns_earlier_frames(pushed_run):
    """A push that fills batch i returns batch i - 1's units; the
    others return none; flush dispatches the ragged batch (frame 4,
    padded) and drains the rest."""
    enc, pushed, flushed, _, _ = pushed_run
    assert [indices(u) for u in pushed] == [[], [], [], [0, 1], []]
    assert indices(flushed) == [2, 3, 4]
    assert enc.frames_done == FRAMES
    assert [(d.frames_done, d.qp) for d in flushed] == [(4, QP), (5, QP)]
    assert [indices([d]) for d in flushed] == [[2, 3], [4]]


@pytest.mark.parametrize("target_bpp", [None, TARGET_BPP],
                         ids=["fixed_qp", "target_bpp"])
def test_pushed_stream_equals_encode_sequence(tmp, target_bpp):
    enc = encoder(target_bpp)
    pushed, flushed = push_all(enc, make_frames(FRAMES, H, W))
    drained = [d for p in pushed for d in p] + flushed
    assert indices(drained) == list(range(FRAMES))
    stream, sidecar, _, _ = file_run(target_bpp, tmp)
    assert enc.header + b"".join(u for _, u in units(drained)) == stream
    assert (sidecar["frames_done"], sidecar["qp"]) == (enc.frames_done,
                                                       enc.qp)
    if target_bpp is not None:
        # the primed first batch drains at once
        assert [indices(p) for p in pushed][:2] == [[], [0, 1]]
        assert len({fr["Y"]["qp"] for fr in seq.decode_sequence_levels(
            str(Path(tmp) / f"seq{target_bpp}.bin"))}) > 1


@pytest.mark.parametrize("target_bpp", [None, TARGET_BPP],
                         ids=["fixed_qp", "target_bpp"])
def test_file_equals_the_jax_package(tmp, tmp_path, target_bpp):
    """The JAX package's encode_sequence of the same file at the same
    batch: bytes, sidecar, rate control and mean luma PSNR."""
    stream, sidecar, _, res = file_run(target_bpp, tmp)
    bits = tmp_path / "jax.bin"
    jres = jax_seq.encode_sequence(
        str(Path(tmp) / "seq.yuv"), W, H, FRAMES, JaxConfig(**SETTINGS),
        str(bits), batch=BATCH, closed_loop=True, target_bpp=target_bpp)
    assert bits.read_bytes() == stream
    assert json.loads(Path(str(bits) + ".progress").read_text()) == sidecar
    assert res.bytes_written == jres.bytes_written
    assert res.stats.get("rate_control") == jres.stats.get("rate_control")
    assert res.mean_psnr_y == pytest.approx(jres.mean_psnr_y, rel=1e-6)


def test_int16_planes_give_the_uint8_file_bytes(tmp, pushed_run):
    enc, pushed, flushed, _, _ = pushed_run
    drained = [d for p in pushed for d in p] + flushed
    assert enc.header + b"".join(u for _, u in units(drained)) == \
        file_run(None, tmp)[0]


def test_plain_reference_stream_equals_the_port(tmp):
    if str(BENCH) not in sys.path:
        sys.path.append(str(BENCH))
    from plainref import encoder as plain_encoder
    from plainref import sequence as plain_sequence

    refs = plain_encoder.encode_frames(make_frames(FRAMES, H, W), SETTINGS,
                                       "cpu")
    want = plain_sequence.stream(W, H, SETTINGS, refs)
    assert want == file_run(None, tmp)[0]


def test_spans_and_counters_record_only_under_the_profiler(tmp, pushed_run):
    assert file_run(None, tmp)[2] == ({}, {})
    _, _, _, (spans, counts), drains = pushed_run
    batches = -(-FRAMES // BATCH)
    assert {k: v for k, v in spans.items() if k.startswith("seq.")} == {
        "seq.upload": batches, "seq.fetch": batches, "seq.strip": FRAMES}
    assert counts["frame.waits"] == batches
    # int16 planes: two bytes a sample, ragged batches padded
    assert counts["frame.bytes_up"] == (
        2 * batches * BATCH * (H * W + 2 * (H // 2) * (W // 2)))
    assert len(drains.small) == batches


def test_bytes_down_are_what_each_drain_copies(pushed_run):
    _, _, _, (_, counts), drains = pushed_run
    assert len(drains.prefixes) > 0
    assert counts["frame.bytes_down"] == (sum(drains.small)
                                          + sum(drains.prefixes))


def test_push_after_flush_raises(pushed_run):
    enc = pushed_run[0]
    with pytest.raises(RuntimeError, match="after flush"):
        enc.push(*make_frames(1, H, W)[0])
    assert enc.flush() == []


def test_flush_with_nothing_staged_returns_nothing():
    enc = encoder()
    assert enc.flush() == []
    assert enc.frames_done == 0
    assert enc.header.startswith(b"\x00\x00\x00\x01")
