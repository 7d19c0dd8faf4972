"""Run the decode kernel's phases of `chip_smoke.py` (3f, 6d) alone, and
compare the kernel with another tree's.

    python3 tools/torch_decode_phase.py      # from the root of a checkout
    python3 tools/torch_decode_phase.py --parent build/parent [--tune]

Builds the kernels (printing the decode library's registers and spills),
encodes the seeded 1080p 4:2:0 frame closed loop on the card under the
default config and the mode search, decodes each stream with
`decode_frame` (3 launches of the decode kernel, == the recon), then
runs `chip_smoke.phase_decode_vs_plain` (3f: the kernel == its plain
version), `chip_smoke.decode_times` and `chip_smoke.decode_frame_split`
(6d: kernel times per N, bound, `decode_residual` beside it, the frame
call with its host parse and device busy share).

`--parent DIR` builds DIR's `nanohevc_tpu_torch/csrc/decode.cu` (a tree
from before the kernel's grid cap, whose C entry has no group or grid
arguments: unpack the parent commit there with `git archive`) and
times it against this tree's kernel on the 1080p search stream's luma
plane at N 4 (DST), 8, 16 and 32, and on a batch of 8 such planes at
N=8, in turns (parent, change, change, parent) through a CUDA graph,
after checking that both give the same pixels.  `--tune` times this
tree's kernel at each W (block rows a thread block, 1-8) on the same
planes.  Each line carries the card's name and power limit; exits
non-zero when there is no card or a check fails.
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
from nanohevc_tpu_torch.kernels import decode as kd  # noqa: E402

_I, _P = ctypes.c_int, ctypes.c_void_p


# The parent's C entry: residual, modes, batch, height, width, n,
# bit_depth, strong_thresh, filter_mask, recon, work, grids, stream,
# device.
PARENT_SIGNATURE = {"nhv_wavefront_decode": [_P, _P] + [_I] * 6
                    + [ctypes.c_ulonglong] + [_P] * 4 + [_I]}


def build_parent(tree: Path):
    """nvcc of TREE's decode.cu into build/parent (this tree's flags and
    generated headers); returns the loaded library, its table uploaded to
    card 0."""
    kern = cs.build.KernelLibrary(
        "decode", kd.cuda_kernels().table,
        cs.build.build_copy(tree / "nanohevc_tpu_torch" / "csrc", "decode",
                            cs.build.BUILD_DIR / "parent", PARENT_SIGNATURE))
    cs.log(f"parent decode library built in "
           f"{kern.build_info.seconds:.2f} s")
    for line in kern.build_info.log.splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"  {line.strip()}")
    kern.ensure_tables(0)
    return kern.lib


def parent_call(lib, res, md, n):
    """The parent's kernel on (B, Hp, Wp) residual planes, no smoothing,
    8 bits: one launch, its progress flags zeroed as its wrapper did."""
    b, hp, wp = res.shape
    recon = torch.empty_like(res)
    work = torch.zeros(1 + b * (hp // n), dtype=torch.int32,
                       device=res.device)
    grids = ctypes.c_int(0)
    rc = lib.nhv_wavefront_decode(
        res.data_ptr(), md.data_ptr(), b, hp, wp, n, 8, 0, 0,
        recon.data_ptr(), work.data_ptr(), ctypes.addressof(grids),
        torch.cuda.current_stream().cuda_stream, 0)
    if rc:
        raise RuntimeError(f"parent nhv_wavefront_decode: CUDA error {rc}")
    return recon


def search_planes(dev, frame, batch: int = 1) -> dict:
    """{N: (residual, modes, N, DST)} of the closed loop's search stream
    of the 1080p luma plane at N 4 (DST), 8, 16, 32, QP 22, and at N=8
    `batch` copies of it, a sequence chunk, under the key 'N=8 x batch'."""
    y = torch.from_numpy(frame.y.data.astype(np.int32))[None].to(dev)
    planes = {}
    for n, dst in cs.DECODE_SIZES:
        out = cs.encode_planes_closed_loop(y, 22, n=n, mode_set="all",
                                           decision="satd", use_dst=dst)
        hp, wp = -(-cs.H // n) * n, -(-cs.W // n) * n
        md = out["modes"].contiguous()
        res = cs.decode_residual(out["levels"], md, [22], n=n, hp=hp, wp=wp,
                                 use_dst=dst)
        planes[n] = (res, md, n, dst)
        if n == 8 and batch > 1:
            planes[f"N=8 x {batch}"] = (res.expand(batch, -1, -1).contiguous(),
                                        md.expand(batch, -1).contiguous(), n,
                                        dst)
    return planes


def chain_note(n: int, hp: int, wp: int, ms: float) -> str:
    depth = hp // n + wp // n - 1
    return f"{1e3 * ms / depth:.3f} us a block on the {depth}-block chain"


def parent_vs_change(lib, planes: dict, gpu: str) -> None:
    """Parent, change, change, parent through a CUDA graph, on each
    plane set; both must give the same pixels."""
    for key, (res, md, n, dst) in planes.items():
        new = lambda: kd.decode_blocks(res, md, n)   # noqa: E731
        old = lambda: parent_call(lib, res, md, n)   # noqa: E731
        if not torch.equal(new(), old()):
            raise SystemExit(f"{key}: the parent's and this tree's decode "
                             "kernels differ")
        order = (("parent", old), ("change", new), ("change", new),
                 ("parent", old))
        times = [(label, cs.graph_ms(fn)) for label, fn in order]
        b, hp, wp = res.shape
        bound, by = cs.decode_bound(n, md)
        par = [ms for label, ms in times if label == "parent"]
        chg = [ms for label, ms in times if label == "change"]
        cs.log(f"[parent vs change] decode_blocks {key if b > 1 else f'N={n}'}"
               f"{' DST' if dst else ''}, 1080p luma: "
               + ", ".join(f"{label} {ms:.4f}" for label, ms in times)
               + f" ms (CUDA graph); change {chain_note(n, hp, wp, min(chg))}"
               f" a plane, parent {chain_note(n, hp, wp, min(par))}; bound "
               f"{1e3 * bound:.2f} us ({by}): change "
               f"{100 * bound / min(chg):.2f} %, parent "
               f"{100 * bound / min(par):.2f} % [{gpu}]")


def tune(planes: dict, gpu: str) -> None:
    """This tree's kernel at each W (the C entry called at that W), each
    == the default's pixels."""
    lib = kd.cuda_kernels().lib
    for key, (res, md, n, dst) in planes.items():
        b, hp, wp = res.shape
        want = kd.decode_blocks(res, md, n)
        cells = []
        for rows in range(1, 9):
            call = lambda: kd._launch(   # noqa: E731
                lib, res, md, n, rows=rows)[0]
            if not torch.equal(call(), want):
                raise SystemExit(f"tune {key}: W={rows} differs from the "
                                 "default")
            cells.append(f"W={rows} {cs.graph_ms(call):.4f}")
        cs.log(f"[tune] decode_blocks {key if b > 1 else f'N={n}'}"
               f"{' DST' if dst else ''}, 1080p luma, ms (CUDA graph; "
               f"default W={kd.group_rows(n, hp, wp, 0)}): " + ", ".join(cells)
               + f" [{gpu}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="a tree whose decode.cu to time against this one")
    ap.add_argument("--tune", action="store_true",
                    help="time each W (block rows a thread block)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_phase: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    cs.log(gpu)
    info = cs.build.build_libraries()["decode"]
    cs.log(f"decode library built in {info.seconds:.2f} s"
           f"{' (cached)' if info.cached else ''}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"  {line.strip()}")
    lib = build_parent(args.parent) if args.parent else None
    frame = cs.make_frame(np.random.default_rng(cs.SEED))
    streams = {}
    for label, config in (("default", cs.EncoderConfig()),
                          ("mode search", cs.MODE_SEARCH)):
        recon, bits = cs.encode_frame_closed_loop(frame, config, device=dev)
        decoded = cs.counted_decode(f"{label} decode_frame", 3,
                                    lambda: cs.decode_frame(bits, device=dev))
        if not cs.same_frames(decoded, recon):
            raise SystemExit(f"{label}: decode_frame on the card != recon")
        cs.log(f"{label}: decode_frame on the card == recon, 3 launches")
        streams[label] = bits
    cs.phase_decode_vs_plain(dev, streams["mode search"], gpu)
    if lib is not None or args.tune:
        planes = search_planes(dev, frame, batch=cs.DECODE_CHUNK)
        if lib is not None:
            parent_vs_change(lib, planes, gpu)
        if args.tune:
            tune(planes, gpu)
    cs.decode_times(dev, frame, gpu)
    for label, bits in streams.items():
        cs.decode_frame_split(dev, bits, label, gpu)
    cs.log(f"torch_decode_phase: passed in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
