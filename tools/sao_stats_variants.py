"""Time the SAO estimate kernel (`csrc/sao.cu`: the statistics, then
the decision as their epilogue) against variants of its statistics'
design, on the card.

    python3 tools/sao_stats_variants.py      # from the root of a checkout

Variants, each built from an edited copy of this tree's `csrc/`
(`kernels/build.py::edited_copy`) and called through its own
`nhv_sao_estimate`:

- `threads 544` / `threads 288`: 16 or 8 counting warps a thread block
  instead of 31 (16: a tile of 64 x 64 in exactly 8 rounds of 512
  samples, 3 blocks a multiprocessor);
- `one tile a block`: no groups, so no decision overlaps another tile's
  counting.

Each is checked against this tree's kernel (the same statistics and
parameters) and timed through a CUDA graph on the padded 1080p luma and
chroma planes of the default config's closed-loop recon, CTB SAO at
tiles of 64 with the merge pass and per-plane SAO, in turns: kernel,
variants, kernel.  Every line carries the card's name and power limit.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nanohevc_tpu_torch.kernels import build  # noqa: E402
from nanohevc_tpu_torch.kernels import loop_filter as lf  # noqa: E402

THREADS = "constexpr int kStatThreads = 1024;"
GROUPS = "  const int per_group = fill < kMaxGroup ? fill : kMaxGroup;"
VARIANTS = {
    "threads 544": [("sao.cu", THREADS, THREADS.replace("1024", "544"))],
    "threads 288": [("sao.cu", THREADS, THREADS.replace("1024", "288"))],
    "one tile a block": [("sao.cu", GROUPS,
                          "  const int per_group = fill > 0 ? 1 : 1;")],
}


def estimate_call(lib, src, rec, frame: bool):
    """nhv_sao_estimate of a library: CTB SAO at tiles of 64 with the
    merge pass at QP 22, or per-plane SAO; (statistics, parameters)."""
    b, h, w = rec.shape
    nty, ntx = -(-h // 64), -(-w // 64)
    grid = () if frame else (nty, ntx)
    stats = torch.empty((b, nty, ntx, lf.STAT_INTS), dtype=torch.int32,
                        device=rec.device)
    maps = [torch.empty((b,) + grid + extra, dtype=torch.int32,
                        device=rec.device) for extra in ((), (), (4,))]
    counters, words, _, _ = lf._workspace(rec.device, b, b * nty * ntx)
    prices = (0.0,) * 4 if frame else lf.sao_prices(22)
    rc = lib.nhv_sao_estimate(src.data_ptr(), rec.data_ptr(), b, h, w, 6, 8,
                              0 if frame else 2, 7, *prices,
                              stats.data_ptr(), *(m.data_ptr() for m in maps),
                              counters.data_ptr(), words.data_ptr(),
                              torch.cuda.current_stream().cuda_stream, 0)
    if rc:
        raise RuntimeError(f"nhv_sao_estimate failed: CUDA error {rc}")
    return (stats,) + tuple(maps)


def main() -> int:
    if not torch.cuda.is_available():
        print("sao_stats_variants: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    cs.log(gpu)
    libs = {"kernel": lf.cuda_kernels("sao").lib}
    root = build.BUILD_DIR / "variants"
    for k, (name, edits) in enumerate(VARIANTS.items()):
        out = root / f"v{k}"
        lib, info = build.build_copy(build.edited_copy(out, edits), "sao",
                                     out)
        libs[name] = lib
        regs = [ln.strip() for ln in info.log.splitlines()
                if "registers" in ln]
        cs.log(f"built {name} in {info.seconds:.2f} s: {regs}")
    frame = cs.make_frame(np.random.default_rng(cs.SEED))
    for name, src, rec, _ in cs.filter_planes(dev, frame):
        deb = lf.deblock_planes(rec, 22, 8, name != "Y")
        for frame_sao in (False, True):
            want = estimate_call(libs["kernel"], src, deb, frame_sao)
            for label, lib in libs.items():
                if cs.differing(estimate_call(lib, src, deb, frame_sao),
                                want):
                    raise SystemExit(f"{label}: estimates differ on {name}")
            order = list(libs) + ["kernel"]
            times = {}
            for label in order:
                ms = cs.graph_ms(lambda lib=libs[label]: estimate_call(
                    lib, src, deb, frame_sao))
                times.setdefault(label, []).append(ms)
            what = "per-plane SAO" if frame_sao else "CTB SAO, merge"
            cs.log(f"{name} {tuple(rec.shape[1:])}, tile 64, {what}, ms "
                   f"(CUDA graph; outputs equal): " + ", ".join(
                       f"{k} {'/'.join(f'{t:.4f}' for t in v)}"
                       for k, v in times.items()) + f" [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
