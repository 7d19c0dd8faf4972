"""Run the loop filters' phases of `chip_smoke.py` (3i, 6i) alone, and
time the filter kernels against another tree's.

    python3 tools/torch_loop_filter_phase.py            # from a checkout's root
    python3 tools/torch_loop_filter_phase.py --times
    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    python3 tools/torch_loop_filter_phase.py --parent build/parent

Builds the kernels (printing the deblock and SAO libraries' registers
and spills) and runs `chip_smoke.phase_filters_vs_plain` (3i: each
filter kernel == its plain version on the card).  `--times` adds
`chip_smoke.filter_times` (6i: each kernel and its plain version a
padded 1080p plane through a CUDA graph, beside its bound), 8b's stage
times (`filter_stage_times`: kernels beside the plain ops, stream and
CUDA-graph time) and the 1080p closed-loop frame call and its device
part without filters, with deblock+sao and with deblock+sao_ctb, under
the default config and the mode search (`frame_call_ms`).

`--parent DIR` builds DIR's `deblock.cu` and `sao.cu` (a tree whose SAO
library has the statistics and decision kernels apart: `nhv_sao_stats`,
`nhv_sao_decide`) and times, on the padded 1080p Y / U / V planes of
the default closed-loop recon, through a CUDA graph, in turns (parent,
this tree, this tree, parent), with the outputs held equal: the
deblocking kernel; the parent's statistics and decision (two launches)
against this tree's estimate (one), CTB SAO at tiles of 64 with the
merge pass and per-plane SAO; and the parent's statistics kernel alone.
Each line carries the card's name and power limit; exits non-zero when
there is no card or a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nanohevc_tpu_torch.kernels import build  # noqa: E402
from nanohevc_tpu_torch.kernels import loop_filter as lf  # noqa: E402
from nanohevc_tpu_torch.ref.sao import max_offset  # noqa: E402

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
# The parent's C interface: deblocking as this tree's; SAO's statistics,
# decision and application kernels apart.
PARENT_SIGNATURES = {
    "deblock": build.SIGNATURES["deblock"],
    "sao": {"nhv_sao_stats": [_P, _P] + [_I] * 5 + [_P, _P, _I],
            "nhv_sao_decide": [_P] + [_I] * 5 + [_F] * 4 + [_I] + [_P] * 4
                              + [_I]},
}


class Parent:
    """Another tree's deblocking and SAO kernels, called through their
    own C interfaces on the current stream."""

    def __init__(self, tree: Path):
        out = build.BUILD_DIR / "parent"
        csrc = tree / "nanohevc_tpu_torch" / "csrc"
        self.libs = {}
        for name, sig in PARENT_SIGNATURES.items():
            lib, info = build.build_copy(csrc, name, out / name, sig)
            self.libs[name] = lib
            cs.log(f"built the parent's {name} in {info.seconds:.2f} s")
            for line in info.log.splitlines():
                if "registers" in line or "spill" in line:
                    cs.log(f"  {line.strip()}")

    @staticmethod
    def _check(rc: int, fn: str) -> None:
        if rc:
            raise SystemExit(f"the parent's {fn} failed: CUDA error {rc}")

    def deblock(self, planes, qp: int, chroma: bool):
        b, h, w = planes.shape
        out = torch.empty_like(planes)
        self._check(self.libs["deblock"].nhv_deblock(
            planes.data_ptr(), b, h, w, 8, int(chroma), qp, None,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream, 0),
            "nhv_deblock")
        return out

    def stats(self, src, rec, tile: int):
        b, h, w = rec.shape
        nty, ntx = -(-h // tile), -(-w // tile)
        out = torch.empty((b, nty, ntx, lf.STAT_INTS), dtype=torch.int32,
                          device=rec.device)
        self._check(self.libs["sao"].nhv_sao_stats(
            src.data_ptr(), rec.data_ptr(), b, h, w, tile.bit_length() - 1,
            8, out.data_ptr(), torch.cuda.current_stream().cuda_stream, 0),
            "nhv_sao_stats")
        return out

    def estimate(self, src, rec, tile=None, qp: int = 22):
        """Statistics then decision, two launches, as the parent's
        `sao_estimate` did."""
        st = self.stats(src, rec, lf.FRAME_STATS_TILE if tile is None
                        else tile)
        b, nty, ntx, _ = st.shape
        grid = () if tile is None else (nty, ntx)
        maps = [torch.empty((b,) + grid + extra, dtype=torch.int32,
                            device=rec.device) for extra in ((), (), (4,))]
        prices = (0.0,) * 4 if tile is None else lf.sao_prices(qp)
        self._check(self.libs["sao"].nhv_sao_decide(
            st.data_ptr(), b, nty, ntx, int(tile is None), max_offset(8),
            *prices, 1, *(m.data_ptr() for m in maps),
            torch.cuda.current_stream().cuda_stream, 0), "nhv_sao_decide")
        return tuple(maps)


def in_turns(fns: dict) -> dict:
    """{label: (parent fn, this tree's fn)} -> {label: ([parent ms],
    [this tree's ms])}, each timed through a CUDA graph in turns:
    parent, this tree, this tree, parent."""
    times = {}
    for label, (p_fn, c_fn) in fns.items():
        runs = [cs.graph_ms(fn) for fn in (p_fn, c_fn, c_fn, p_fn)]
        times[label] = ([runs[0], runs[3]], [runs[1], runs[2]])
    return times


def compare_parent(dev, frame, tree: Path, gpu: str) -> None:
    parent = Parent(tree)
    for name, src, rec, chroma in cs.filter_planes(dev, frame):
        deb = lf.deblock_planes(rec, 22, 8, chroma)
        if not torch.equal(parent.deblock(rec, 22, chroma), deb):
            raise SystemExit(f"{name}: the deblocking kernels differ")
        for kw in (dict(tile=64, qp=22), dict()):
            if cs.differing(parent.estimate(src, deb, **kw),
                            lf.sao_estimate(src, deb, **kw)):
                raise SystemExit(f"{name}: the SAO estimates differ ({kw})")
        times = in_turns({
            "deblock": (lambda: parent.deblock(rec, 22, chroma),
                        lambda: lf.deblock_planes(rec, 22, 8, chroma)),
            "CTB estimate (tile 64, merge)": (
                lambda: parent.estimate(src, deb, tile=64),
                lambda: lf.sao_estimate(src, deb, tile=64, qp=22)),
            "per-plane estimate": (
                lambda: parent.estimate(src, deb),
                lambda: lf.sao_estimate(src, deb)),
        })
        alone = [cs.graph_ms(lambda: parent.stats(src, deb, 64))
                 for _ in range(2)]
        cs.log(f"[parent] {name} {tuple(rec.shape[1:])}, ms (CUDA graph; "
               f"parent, change, change, parent; outputs equal): " + "; ".join(
                   f"{k} parent {'/'.join(f'{t:.4f}' for t in p)}, change "
                   f"{'/'.join(f'{t:.4f}' for t in c)} "
                   f"({min(p) / max(c):.2f}x)"
                   for k, (p, c) in times.items())
               + f"; the parent's statistics alone (tile 64) "
               f"{'/'.join(f'{t:.4f}' for t in alone)} [{gpu}]")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--times", action="store_true",
                        help="also time the kernels, the stages and the "
                             "filtered frame calls")
    parser.add_argument("--parent", type=Path, default=None,
                        help="a tree (an unpacked git archive) whose "
                             "filter kernels to time against this one's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_loop_filter_phase: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    cs.log(gpu)
    for stem, info in cs.build.build_libraries().items():
        cs.log(f"built {stem} in {info.seconds:.2f} s")
        if stem in ("deblock", "sao"):
            for line in info.log.splitlines():
                if "registers" in line or "spill" in line:
                    cs.log(f"  {line.strip()}")
    frame = cs.make_frame(np.random.default_rng(cs.SEED))
    cs.phase_filters_vs_plain(dev, frame, gpu)
    if args.parent is not None:
        compare_parent(dev, frame, args.parent.resolve(), gpu)
    if args.times:
        cs.filter_times(dev, frame, gpu)
        cs.filter_stage_times(dev, frame, gpu)
        for label, base in (("default", cs.EncoderConfig()),
                            ("mode search", cs.MODE_SEARCH)):
            for filters in ("none", "deblock+sao", "deblock+sao_ctb"):
                cfg = (base if filters == "none" else
                       cs.filtered(base, **cs.FILTER_CONFIGS[filters]))
                wall, dev_ms = cs.frame_call_ms(dev, frame, cfg)
                cs.log(f"[8b] {label}, filters {filters}: 1080p 4:2:0 "
                       f"closed-loop frame call {wall:.2f} ms (median of 3), "
                       f"device part {dev_ms:.2f} ms [{gpu}]")
    cs.log(f"torch_loop_filter_phase: passed in "
           f"{time.perf_counter() - t0:.1f} s [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
