"""Time the deblocking kernel (`csrc/deblock.cu`) against variants of
its design, on the card.

    python3 tools/deblock_variants.py      # from the root of a checkout

Variants, each built from an edited copy of this tree's `csrc/`
(`kernels/build.py::edited_copy`) and called through its own
`nhv_deblock`:

- `pitch 72`: shared rows of 72 words (an even number of 16-byte
  chunks), so the 8 rows of a quarter warp's octets share 4 chunk slots
  of the banks (2-way conflicts in the vertical pass);
- `register copies`: the tile copied through registers (16-byte global
  loads, then 16-byte shared stores) instead of cp.async;
- `scalar copies`: the tile copied a word at a time through registers
  (the path of planes whose width is no multiple of 4);
- `threads 128` / `threads 512`: the items of a pass in more or fewer
  rounds a thread block;
- `tile 64x64` / `tile 32x128`: larger tiles, a smaller halo share and
  fewer thread blocks.

Each is checked against this tree's kernel (the same pixels) and timed
through a CUDA graph on the padded 1080p Y / U / V planes of the
default config's closed-loop recon, in turns: kernel, variants, kernel.
Every line carries the card's name and power limit.
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

PITCH = "constexpr int kPitch = kCols + 4;"
PITCH_ASSERT = """static_assert(kPitch % 4 == 0 && (kPitch / 4) % 2 == 1,
              "an odd number of 16-byte chunks a shared row");"""
COPY = """      copy16(&s[r * kPitch + 4 * c],
             inside ? in + (long long)gy * width + gx : in, inside ? 16 : 0);"""
REGISTER_COPY = """      *reinterpret_cast<int4*>(&s[r * kPitch + 4 * c]) =
          inside ? *reinterpret_cast<const int4*>(in + (long long)gy * width +
                                                  gx)
                 : make_int4(0, 0, 0, 0);"""
VEC = """  const bool vec =
      width % 4 == 0 && reinterpret_cast<std::uintptr_t>(planes) % 16 == 0;"""
THREADS = "constexpr int kThreads = 256;"
TILE_H = "constexpr int kTileH = 32; "
TILE_W = "constexpr int kTileW = 64; "
VARIANTS = {
    "pitch 72": [("deblock.cu", PITCH, "constexpr int kPitch = kCols;"),
                 ("deblock.cu", PITCH_ASSERT, "")],
    "register copies": [("deblock.cu", COPY, REGISTER_COPY)],
    "scalar copies": [("deblock.cu", VEC, "  const bool vec = planes == "
                       "nullptr;")],
    "threads 128": [("deblock.cu", THREADS, THREADS.replace("256", "128"))],
    "threads 512": [("deblock.cu", THREADS, THREADS.replace("256", "512"))],
    "tile 64x64": [("deblock.cu", TILE_H, TILE_H.replace("32", "64"))],
    "tile 32x128": [("deblock.cu", TILE_W, TILE_W.replace("64", "128"))],
}


def deblock_call(lib, rec, chroma: bool):
    b, h, w = rec.shape
    out = torch.empty_like(rec)
    rc = lib.nhv_deblock(rec.data_ptr(), b, h, w, 8, int(chroma), 22, None,
                         out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream, 0)
    if rc:
        raise RuntimeError(f"nhv_deblock failed: CUDA error {rc}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("deblock_variants: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    cs.log(gpu)
    libs = {"kernel": lf.cuda_kernels("deblock").lib}
    root = build.BUILD_DIR / "variants"
    for k, (name, edits) in enumerate(VARIANTS.items()):
        out = root / f"deblock{k}"
        lib, info = build.build_copy(build.edited_copy(out, edits), "deblock",
                                     out)
        libs[name] = lib
        regs = [ln.strip() for ln in info.log.splitlines()
                if "registers" in ln]
        cs.log(f"built {name} in {info.seconds:.2f} s: {regs}")
    frame = cs.make_frame(np.random.default_rng(cs.SEED))
    for name, _, rec, chroma in cs.filter_planes(dev, frame):
        want = deblock_call(libs["kernel"], rec, chroma)
        for label, lib in libs.items():
            if not torch.equal(deblock_call(lib, rec, chroma), want):
                raise SystemExit(f"{label}: pixels differ on {name}")
        times = {}
        for label in list(libs) + ["kernel"]:
            ms = cs.graph_ms(lambda lib=libs[label]: deblock_call(
                lib, rec, chroma))
            times.setdefault(label, []).append(ms)
        cs.log(f"{name} {tuple(rec.shape[1:])}, ms (CUDA graph; outputs "
               f"equal): " + ", ".join(
                   f"{k} {'/'.join(f'{t:.4f}' for t in v)}"
                   for k, v in times.items()) + f" [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
