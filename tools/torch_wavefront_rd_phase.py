"""Run the RD closed loop's kernel phases of `chip_smoke.py` alone, and
compare the kernel with another tree's.

    python3 tools/torch_wavefront_rd_phase.py           # 3h, price sweep
    python3 tools/torch_wavefront_rd_phase.py --times   # and 6h
    python3 tools/torch_wavefront_rd_phase.py --parent build/parent

Builds the kernels (printing the RD library's registers and spills),
then runs `chip_smoke`'s 3h (the kernel ==
`kernels.wavefront_rd.wavefront_rd_encode_planes_reference` on the card
over the crops' cases, the 1080p luma plane at N=8 under both
mode sets, the sequence's RD batches and a batch of mixed texture,
three repeats each) and its price sweep (the device prices == the
host's `_prices`, 0 bits differing).  With --times, 6h: the kernel per
1080p luma plane at every N beside its synchronisation alone, its
bound and the plain loop, and on 7d's two plane batches.

`--parent DIR` builds DIR's `nanohevc_tpu_torch/csrc/wavefront_rd.cu`
(the parent commit unpacked there: `mkdir -p build/parent && git
archive HEAD | tar -x -C build/parent`) into `build/parent` and times
it against this tree's kernel in turns (parent, change, change, parent)
through a CUDA graph, after checking that both give the same recon,
levels and modes: the seeded 1080p luma plane at N 4 (DST), 8, 16 and
32 under both mode sets, and 7d's two plane batches (8 luma planes of
1080p at N=8, 16 chroma planes of 540x960 at N=4, as
EncoderConfig(decision="rd") gives their arguments); each kernel's
synchronisation alone beside it.  Each timing line carries the card's
name and power limit; exits non-zero when there is no card or a check
fails.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nanohevc_tpu_torch.kernels import wavefront_rd as krd  # noqa: E402


def build_parent(tree: Path):
    """nvcc of TREE's wavefront_rd.cu into build/parent (this tree's flags
    and generated headers); returns it as a KernelLibrary."""
    kern = cs.build.KernelLibrary(
        "wavefront_rd", krd.cuda_kernels().table,
        cs.build.build_copy(tree / "nanohevc_tpu_torch" / "csrc",
                            "wavefront_rd", cs.build.BUILD_DIR / "parent"))
    cs.log(f"parent wavefront_rd library built in "
           f"{kern.build_info.seconds:.2f} s")
    for line in kern.build_info.log.splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"  {line.strip()}")
    return kern


def launch_kw(kw: dict) -> dict:
    """`_launch`'s keywords from a plane case's."""
    out = dict(mode_set="dc_planar", bit_depth=8, use_dst=False,
               dequant_rescale=False, intra_smoothing=False, rdoq=False,
               scan="diag", rd_lambda_scale=1.0)
    out.update(kw)
    return out


def parent_vs_change(parent, dev, gpu: str) -> None:
    """Parent, change, change, parent through a CUDA graph on each plane
    case; both must give the same outputs."""
    rng = np.random.default_rng(cs.SEED + 1)
    cases = []
    for n, dst in ((4, True), (8, False), (16, False), (32, False)):
        y = cs.stacked_planes((cs.H, cs.W), 8, 1, n, dev, rng)
        for mode_set in cs.RD_SETS:
            cases.append((f"1080p luma N={n}{' DST' if dst else ''} "
                          f"{mode_set}", y, n,
                          dict(mode_set=mode_set, use_dst=dst)))
    cases += cs.rd_batches(dev, rng)
    for label, planes, n, kw in cases:
        kw = launch_kw(kw)
        new = lambda: krd._launch(planes, 22, n, **kw)[0]   # noqa: E731
        old = lambda: krd._launch(planes, 22, n, **kw,      # noqa: E731
                                  kern=parent)[0]
        a, b = new(), old()
        torch.cuda.synchronize()
        if cs.max_abs_err(a, b):
            raise SystemExit(f"{label}: the parent's and this tree's RD "
                             "kernels differ")
        order = (("parent", old), ("change", new), ("change", new),
                 ("parent", old))
        times = [(tag, cs.graph_ms(fn, iters=3, replays=3))
                 for tag, fn in order]
        par = min(ms for tag, ms in times if tag == "parent")
        chg = min(ms for tag, ms in times if tag == "change")
        ms_set = kw["mode_set"]
        sync_new = lambda: krd.barriers_only(planes, n, ms_set)  # noqa: E731
        sync_old = lambda: krd.barriers_only(  # noqa: E731
            planes, n, ms_set, kern=parent)
        blocks_new, blocks_old = sync_new(), sync_old()
        s_new = cs.graph_ms(sync_new, iters=3, replays=3)
        s_old = cs.graph_ms(sync_old, iters=3, replays=3)
        bsz, hp, wp = planes.shape
        depth = hp // n + wp // n - 1
        bound, by = cs.rd_bound(ms_set, n, bsz * hp * wp, bsz * depth)
        cs.log(f"[parent vs change] {label}: "
               + ", ".join(f"{tag} {ms:.4f}" for tag, ms in times)
               + f" ms (CUDA graph); change {par / chg:.2f}x the parent; "
               f"synchronisation alone: change {s_new:.4f} ms "
               f"({blocks_new} thread blocks, {100 * s_new / chg:.1f} %), "
               f"parent {s_old:.4f} ms ({blocks_old} thread blocks, "
               f"{100 * s_old / par:.1f} %); bound {1e3 * bound:.2f} us "
               f"({by}): change {100 * bound / chg:.3f} %, parent "
               f"{100 * bound / par:.3f} %; outputs equal [{gpu}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--times", action="store_true", help="run 6h too")
    ap.add_argument("--parent", type=Path,
                    help="a tree whose wavefront_rd.cu to time against "
                         "this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_wavefront_rd_phase: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    cs.log(gpu)
    for stem, info in cs.build.build_libraries().items():
        cs.log(f"{stem} library built in {info.seconds:.2f} s"
               f"{' (cached)' if info.cached else ''}")
        if stem == "wavefront_rd":
            for line in info.log.splitlines():
                if "registers" in line or "spill" in line:
                    cs.log(f"  {line.strip()}")
    parent = build_parent(args.parent) if args.parent else None
    cs.phase_wavefront_rd_vs_plain(dev)
    cs.phase_rd_prices(dev, gpu)
    if parent is not None:
        parent_vs_change(parent, dev, gpu)
    if args.times:
        cs.rd_times(dev, gpu)
    cs.log(f"torch_wavefront_rd_phase: passed in "
           f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
