"""The port's stage spans and byte counters (`utils.tracing`).

With no profiler recording, `span` and `count` read one flag: `span`
returns the shared null context, nothing is recorded.  Under
`torch.profiler`, a closed-loop frame call opens the spans "frame.upload"
(once a frame call: the planes go up in one copy), "frame.fetch" and
"frame.convert" (once a plane batch: luma, then U and V together) and
"entropy.modes", "entropy.scan", "entropy.residual" (once a plane),
"entropy.sao" (once a frame), each as an "nhevc.<name>" range in the
profiler's events, and counts the bytes each way, the host's waits for
the device and the blocks the CABAC coder reads in scan order.  On the card's path the wavefront kernel's wrapper opens
"wavefront.launch" and counts the blocks it codes as "wavefront.blocks"
(driven here with the launch replaced by the plain loop).  The outputs
are the same either way.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nanohevc_tpu_torch.config import EncoderConfig
from nanohevc_tpu_torch.frame import Frame, Plane
from nanohevc_tpu_torch.kernels import wavefront as kwf
from nanohevc_tpu_torch.models import wavefront as wf
from nanohevc_tpu_torch.models.all_intra import create_test_frame
from nanohevc_tpu_torch.utils import tracing

CONFIG = EncoderConfig(qp=30, deblock=True, sao_ctb=True, sao_tile=16,
                       entropy_coder="cabac", scan="mode")
PER_BATCH = ("frame.fetch", "frame.convert")
PER_PLANE = ("entropy.modes", "entropy.scan", "entropy.residual")


def encode(frame):
    return wf.encode_frame_closed_loop(frame, CONFIG, device="cpu")


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


class _FlagOnly:
    """Stands for torch.autograd.profiler: counts reads of the flag."""

    def __init__(self):
        self.reads = 0

    @property
    def _is_profiler_enabled(self):
        self.reads += 1
        return False


def _refused(name):
    raise AssertionError(f"profiler range {name!r} entered")


def test_off_span_and_count_read_one_flag(monkeypatch):
    flag = _FlagOnly()
    monkeypatch.setattr(tracing, "_profiler", flag)
    monkeypatch.setattr(tracing, "_Range", _refused)
    with tracing.span("frame.upload") as s:
        assert s is None
    assert tracing.span("entropy.sao") is tracing.NULL_SPAN
    assert flag.reads == 2
    tracing.count("frame.bytes_up", 100)
    assert flag.reads == 3
    assert tracing.SPANS.totals == {} and tracing.COUNTS == {}


def test_off_frame_call_records_nothing(monkeypatch):
    monkeypatch.setattr(tracing, "_Range", _refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refused)
    encode(create_test_frame(24, 40))
    assert tracing.SPANS.totals == {} and tracing.SPANS.counts == {}
    assert tracing.COUNTS == {}


def test_profiled_frame_calls_open_each_span(tmp_path):
    frame = create_test_frame(24, 40)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        encode(frame)
        encode(frame)
    counts = tracing.SPANS.counts
    assert counts["frame.upload"] == 2
    assert {k: counts[k] for k in PER_BATCH} == {k: 4 for k in PER_BATCH}
    assert {k: counts[k] for k in PER_PLANE} == {k: 6 for k in PER_PLANE}
    assert counts["entropy.sao"] == 2
    assert set(counts) == ({"frame.upload", "entropy.sao"} | set(PER_BATCH)
                           | set(PER_PLANE))
    assert all(t > 0 for t in tracing.SPANS.totals.values())
    names = {ev.name for ev in prof.events()}
    assert {tracing.PREFIX + k for k in counts} <= names
    report = tracing.SPANS.report()
    assert report["entropy.residual"]["calls"] == 6
    # Operator ranges, not user annotations: the profiler mirrors a user
    # annotation onto the card's timeline, where a stage that waits for
    # the card would read as device time.
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    cats = {e.get("cat") for e in events
            if str(e.get("name", "")).startswith(tracing.PREFIX)}
    assert cats and "user_annotation" not in cats


def test_profiled_counters_are_the_bytes_moved():
    frame = create_test_frame(24, 40)
    frame = Frame(*(Plane(p.data.astype(np.uint8))
                    for p in (frame.y, frame.u, frame.v)))
    with profile(activities=[ProfilerActivity.CPU]):
        encode(frame)
    # Up: the planes in their own dtype, uint8, 24x40 luma and two 12x20
    # chroma planes.  Down: the int16 recon; int32 levels, modes and CTB
    # SAO maps (type, band, four offsets a tile) of luma's 3x5 blocks at
    # N=8 and 2x3 tiles of 16, and of each chroma plane's 3x5 blocks at
    # N=4 and 1x2 tiles.
    samples = 24 * 40 + 2 * 12 * 20
    blocks = 3 * 5 + 2 * 3 * 5
    values = 15 * 64 + 2 * 15 * 16 + blocks + 6 * 6 + 2 * 2 * 6
    # The CABAC coder reads every block of the three slices in the scan
    # order it was fetched in; the host waits for the device once a plane
    # batch, for luma while the chroma pair runs, then for the pair.
    assert tracing.COUNTS == {"frame.bytes_up": samples,
                              "frame.bytes_down": 2 * samples + 4 * values,
                              "frame.waits": 2,
                              "entropy.scan_order_blocks": blocks}
    tracing.reset()
    assert tracing.COUNTS == {} and tracing.SPANS.totals == {}


def test_outputs_equal_with_and_without_the_profiler():
    frame = create_test_frame(24, 40)
    recon0, bits0 = encode(frame)
    with profile(activities=[ProfilerActivity.CPU]):
        recon1, bits1 = encode(frame)
    assert bits1 == bits0
    for a, b in zip((recon0.y, recon0.u, recon0.v),
                    (recon1.y, recon1.u, recon1.v)):
        assert a.data.dtype == b.data.dtype == np.int16
        assert np.array_equal(a.data, b.data)
    assert tracing.SPANS.counts["entropy.sao"] == 1


@pytest.fixture
def card_path(monkeypatch):
    """The wavefront wrapper's card path on CPU tensors: the C call
    replaced by the plain loop, the wrapper's counters put back after.
    Returns the path as `encode_planes_closed_loop` calls the wrapper."""
    def launch(kern, planes, qp, n, *, max_grid=0, **kw):
        return kwf.wavefront_encode_planes_reference(planes, qp, n, **kw), 1

    monkeypatch.setattr(kwf, "_launch", launch)
    monkeypatch.setattr(kwf, "cuda_kernels", lambda: None)
    for attr, value in (("launches", 0), ("grids", 0),
                        ("launches_by_config", {})):
        monkeypatch.setattr(kwf.wavefront_encode_planes, attr, value)
    return lambda planes, qp, n, **kw: kwf._encode_on_card(planes, qp, n, 0,
                                                           kw)


LOOP = dict(mode_set="all", decision="satd", bit_depth=8, use_dst=False,
            dequant_rescale=True, intra_smoothing=True, rdoq=False,
            scan="mode", rd_lambda_scale=1.0)


@pytest.mark.parametrize("profiled", [False, True])
def test_wavefront_span_and_blocks_only_while_profiling(card_path, profiled):
    planes = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 24, 40), dtype=np.int32))
    want = kwf.wavefront_encode_planes_reference(planes, 30, 8, **LOOP)
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = card_path(planes, 30, 8, **LOOP)
        assert tracing.SPANS.counts == {"wavefront.launch": 1}
        assert tracing.COUNTS == {"wavefront.blocks": 2 * 3 * 5}
        assert tracing.PREFIX + "wavefront.launch" in {
            ev.name for ev in prof.events()}
    else:
        out = card_path(planes, 30, 8, **LOOP)
        assert tracing.SPANS.totals == {} and tracing.COUNTS == {}
    assert kwf.wavefront_encode_planes.launches == 1
    for k in want:
        assert torch.equal(out[k], want[k])


@pytest.mark.parametrize("shape", [(24, 40), (38, 50)])
def test_wavefront_blocks_are_each_planes_padded_blocks(card_path,
                                                        monkeypatch, shape):
    frame = create_test_frame(*shape)
    recon0, bits0 = encode(frame)
    monkeypatch.setattr(wf, "wavefront_encode_planes", card_path)
    with profile(activities=[ProfilerActivity.CPU]):
        recon1, bits1 = encode(frame)
    assert bits1 == bits0 and np.array_equal(recon1.y.data, recon0.y.data)
    # Luma at N=8, chroma at N=4, each padded up to whole blocks.
    h, w = shape
    want = (-(-h // 8) * -(-w // 8)
            + 2 * -(-(h // 2) // 4) * -(-(w // 2) // 4))
    assert tracing.COUNTS["wavefront.blocks"] == want
    # One launch for luma, one for the chroma pair.
    assert tracing.SPANS.counts["wavefront.launch"] == 2
