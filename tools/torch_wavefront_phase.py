"""Run the wavefront kernel's phases of `chip_smoke.py` alone, and
compare the kernel with another tree's.

    python3 tools/torch_wavefront_phase.py           # checks only
    python3 tools/torch_wavefront_phase.py --times   # and 6c, 6g
    python3 tools/torch_wavefront_phase.py --parent build/parent

Builds the kernels (printing the wavefront, mode-search and decode
libraries' registers and spills), then runs `chip_smoke`'s checks of the
kernels that share the wavefront kernel's headers: 3b (the mode-search
kernel == its plain version), 3c (the wavefront kernel's two TPU bodies
== the plain loop), 3g (every body and switch of JAX's closed-loop XLA
scan == the plain loop, grids capped at 1 and 2, then at full size
three times: two 1080p luma planes and the sequence's luma and chroma
batches under RDOQ) and 3f (the decode kernel == its plain version, on
the seeded 1080p frame's mode-search stream).  With --times, 6c and
6g: the kernel's times per 1080p luma plane.

`--parent DIR` builds DIR's `nanohevc_tpu_torch/csrc/wavefront.cu` (the
parent commit unpacked there: `mkdir -p build/parent && git archive
HEAD | tar -x -C build/parent`) into `build/nanohevc_tpu_torch/parent`,
printing its registers and spills, and times it against this tree's
kernel in turns (parent, change, change, parent) through a CUDA graph,
after checking that both give the same recon, levels and modes: the
seeded 1080p luma plane at N 4 (DST), 8, 16 and 32 under DC/planar +
RDOQ in the diagonal and the mode scan, the search + RDOQ at N=8, 7d's
two RDOQ batches (8 luma planes of 1080p at N=8, 16 chroma planes of
540x960 at N=4, as EncoderConfig(rdoq=True) gives their arguments),
the two TPU bodies (K3's search, K4's DC/planar) without RDOQ at every
N, and S's fixed, pair, sweep and smoothed bodies without RDOQ at N 8
and 32.  It ends with the slowest change against its parent.  A DIR
from before the grid cap is launched through its own C interface (the
same arguments without max_grid).

Each timing line carries the card's name and power limit; exits
non-zero when there is no card or a check fails.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nanohevc_tpu_torch.kernels import wavefront as kwf  # noqa: E402

# The position of max_grid in this tree's nhv_wavefront_encode, which a
# tree from before the grid cap does not take.
MAX_GRID_ARG = 26


class ParentAbi:
    """A library from before the grid cap behind this tree's call: the
    same arguments without max_grid.  The work buffer this tree's
    wrapper allocates (the ticket, then a line of Wp words a block row
    boundary, zeroed) holds that tree's ticket and row flags on planes
    of two or more block rows."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def nhv_wavefront_encode(self, *args):
        return self._lib.nhv_wavefront_encode(
            *args[:MAX_GRID_ARG], *args[MAX_GRID_ARG + 1:])


def parent_signatures() -> dict:
    """This tree's signatures of the wavefront library, without max_grid."""
    sig = dict(cs.build.SIGNATURES["wavefront"])
    args = list(sig["nhv_wavefront_encode"])
    sig["nhv_wavefront_encode"] = args[:MAX_GRID_ARG] + args[MAX_GRID_ARG + 1:]
    return sig


def takes_grid_cap(csrc: Path) -> bool:
    return "max_grid" in (csrc / "wavefront.cu").read_text()


def parent_library(csrc: Path, out: Path, extra: dict | None = None):
    """nvcc of csrc/wavefront.cu (another tree's, or an edited copy) into
    `out` with this tree's flags; a KernelLibrary that this tree's
    `kwf._launch` can call.  `extra` adds entry points to declare."""
    cap = takes_grid_cap(csrc)
    sig = dict(cs.build.SIGNATURES["wavefront"] if cap
               else parent_signatures())
    sig.update(extra or {})
    kern = cs.build.KernelLibrary(
        "wavefront", kwf.constant_table(),
        cs.build.build_copy(csrc, "wavefront", out, sig))
    if not cap:
        kern.lib = ParentAbi(kern.lib)
    return kern


def kernel_label(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name, as
    in wavefront_kernel<8,1,0,1> (N, body, cost, RDOQ)."""
    m = re.match(r"_Z(\d+)", mangled)
    name = mangled[m.end():m.end() + int(m.group(1))] if m else mangled
    args = re.findall(r"L[ib](\d+)E", mangled)
    return f"{name}<{','.join(args)}>" if args else name


def log_registers(what: str, log: str) -> None:
    """One line a kernel of a ptxas -v log: registers, stack and spills."""
    kernel, parts = None, []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            if kernel:
                cs.log(f"  {what} {kernel}: {'; '.join(parts)}")
            kernel, parts = kernel_label(m.group(1)), []
        elif "registers" in line or "spill" in line:
            parts.append(line.split(":", 1)[-1].strip()
                         if "ptxas info" in line else line.strip())
    if kernel:
        cs.log(f"  {what} {kernel}: {'; '.join(parts)}")


def parent_cases(dev) -> list:
    """[(label, planes, n, keywords)] of the parent comparison."""
    rng = np.random.default_rng(cs.SEED + 1)
    planes = {n: cs.stacked_planes((cs.H, cs.W), 8, 1, n, dev, rng)
              for n in (4, 8, 16, 32)}
    sizes = ((4, True), (8, False), (16, False), (32, False))
    cases = []
    for scan in ("diag", "mode"):
        for n, dst in sizes:
            cases.append((f"DC/planar + RDOQ ({scan}) N={n}"
                          f"{' DST' if dst else ''}", planes[n], n,
                          dict(mode_set="dc_planar", decision="energy",
                               use_dst=dst, rdoq=True, scan=scan)))
    cases.append(("search + RDOQ (diag) N=8", planes[8], 8,
                  dict(mode_set="all", decision="satd", rdoq=True)))
    seq_cfg = cs.EncoderConfig(rdoq=True)       # 7d's closed-loop RDOQ run
    for is_luma, shape, batch in ((True, (cs.H, cs.W), cs.SEQ_BATCH),
                                  (False, (cs.H // 2, cs.W // 2),
                                   2 * cs.SEQ_BATCH)):
        args = cs.torch_wf.plane_args(seq_cfg, is_luma)
        kw = {k: args[k] for k in ("mode_set", "decision", "bit_depth",
                                   "use_dst", "dequant_rescale",
                                   "intra_smoothing", "rdoq", "scan")}
        cases.append((f"7d's {'luma' if is_luma else 'chroma'} RDOQ batch, "
                      f"{batch} {shape[0]}x{shape[1]} planes N={args['n']}",
                      cs.stacked_planes(shape, 8, batch, args["n"], dev, rng),
                      args["n"], kw))
    for body, (mode_set, decision) in (("K4 DC/planar", ("dc_planar",
                                                         "energy")),
                                       ("K3 search", ("all", "satd"))):
        for n, dst in sizes:
            cases.append((f"{body} N={n}{' DST' if dst else ''}", planes[n], n,
                          dict(mode_set=mode_set, decision=decision,
                               use_dst=dst)))
    for row in ("fixed", "pair", "sweep", "smoothing"):
        for n in (8, 32):
            cases.append((f"S {row} N={n}", planes[n], n,
                          cs.SCAN_ROWS[row][1]))
    return cases


def parent_vs_change(parent, dev, gpu: str) -> None:
    """Parent, change, change, parent through a CUDA graph on each case;
    both must give the same outputs."""
    mine = kwf.cuda_kernels()
    worst = (0.0, "")
    for label, planes, n, kw in parent_cases(dev):
        new = lambda: kwf._launch(mine, planes, 22, n, **kw)[0]   # noqa: E731
        old = lambda: kwf._launch(parent, planes, 22, n, **kw)[0]  # noqa: E731
        a, b = new(), old()
        torch.cuda.synchronize()
        if cs.max_abs_err(a, b):
            raise SystemExit(f"{label}: the parent's and this tree's "
                             "wavefront kernels differ")
        order = (("parent", old), ("change", new), ("change", new),
                 ("parent", old))
        times = [(tag, cs.graph_ms(fn, iters=3, replays=3))
                 for tag, fn in order]
        par = min(ms for tag, ms in times if tag == "parent")
        chg = min(ms for tag, ms in times if tag == "change")
        worst = max(worst, (chg / par, label))
        bsz, hp, wp = planes.shape
        depth = hp // n + wp // n - 1
        cs.log(f"[parent vs change] {label}: "
               + ", ".join(f"{tag} {ms:.4f}" for tag, ms in times)
               + f" ms (CUDA graph); change {par / chg:.2f}x the parent, "
               f"{1e3 * chg / (bsz * depth):.3f} us a block on the chain "
               f"(parent {1e3 * par / (bsz * depth):.3f}); outputs equal "
               f"[{gpu}]")
    cs.log(f"[parent vs change] slowest against its parent: {worst[1]}, "
           f"{100 * (worst[0] - 1):+.1f} % [{gpu}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--times", action="store_true", help="run 6c and 6g too")
    ap.add_argument("--parent", type=Path,
                    help="a tree whose wavefront.cu to time against this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_wavefront_phase: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    cs.log(gpu)
    for stem, info in cs.build.build_libraries().items():
        cs.log(f"{stem} library built in {info.seconds:.2f} s"
               f"{' (cached)' if info.cached else ''}")
        if stem in ("wavefront", "mode_search", "decode"):
            log_registers(stem, info.log)
    parent = None
    if args.parent:
        parent = parent_library(args.parent / "nanohevc_tpu_torch" / "csrc",
                                cs.build.BUILD_DIR / "parent")
        cs.log(f"parent wavefront library built in "
               f"{parent.build_info.seconds:.2f} s")
        log_registers("parent wavefront", parent.build_info.log)
    cs.phase_kernel_vs_plain(dev, "mode_search_encode_plane", "3b",
                             wide_bits=True)
    cs.phase_wavefront_vs_plain(dev)
    cs.phase_wavefront_scan_vs_plain(dev)
    frame = cs.make_frame(np.random.default_rng(cs.SEED))
    _, bits = cs.encode_frame_closed_loop(frame, cs.MODE_SEARCH, device=dev)
    cs.phase_decode_vs_plain(dev, bits, gpu)
    if parent is not None:
        parent_vs_change(parent, dev, gpu)
    if args.times:
        cs.wavefront_times(dev, gpu)
        cs.scan_times(dev, gpu)
    cs.log(f"torch_wavefront_phase: passed in "
           f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
