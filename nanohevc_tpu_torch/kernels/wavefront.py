"""Closed-loop (wavefront) encode of a batch of planes: CUDA kernel
wrapper and its plain PyTorch version.

Port of the three TPU kernels of the closed loop, as reached through
`nanohevc_tpu.models.wavefront.encode_planes_closed_loop`:

- `nanohevc_tpu/kernels/wavefront_slab.py` (`wavefront_encode_blocks`,
  K4): DC/planar by energy;
- `nanohevc_tpu/kernels/wavefront_mode_slab.py`
  (`wavefront_mode_search_blocks`, K3b) and
  `nanohevc_tpu/kernels/wavefront_mode_grouped.py`
  (`wavefront_mode_search_raster_grouped`, K3a): the 35-mode SATD
  search, which differ only in TPU layout;

and of the JAX package's closed-loop XLA scan (the `jax.lax.scan` of
that function), which codes everything else but the RD decision of
`dc_planar` and `all` (`kernels.wavefront_rd`): the mode sets `dc`,
`planar`, `dc_planar` and `all` under the decisions `energy`, `sad` and
`satd`, `dc` and `planar` under `rd` too (JAX's `decide_modes` returns
before it prices a fixed mode), luma reference smoothing, and RDOQ in
every scan with its lambda scale (`wavefront_covers`).

One kernel, `csrc/wavefront.cu`, serves all of them, templated on N,
on the body's shape (one fixed mode, DC/planar, the 35-mode sweep) and
on the cost; smoothing and RDOQ are switches.  Its header says how it
is laid out and what bounds it.

Blocks on one anti-diagonal (by + bx == d) depend only on earlier
diagonals, so the plain version walks the nby + nbx - 1 diagonals in
order and codes each diagonal's blocks of every plane of the batch at
once.  A block's references come from the reconstruction with the
clamps of `ops.extract_refs_at`, which on a zero-filled reconstruction
written one diagonal at a time is the closed loop's availability rule.
The kernel codes the same blocks in one launch, block row by block
row, each row one block behind the row above (each block's bottom line
handed down as self-announcing words); it writes the rule's extensions
instead of reading them, so the order gives the same result.  RDOQ prices each block with the static
rate table, alone, so neither the order nor the batch moves it.

`wavefront_encode_planes` dispatches on the device of its input: a
CPU tensor goes to `wavefront_encode_planes_reference`, a CUDA tensor
to the kernel (or an exception).  There is no fallback.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from nanohevc_tpu_torch import ops
from nanohevc_tpu_torch.kernels.mode_search import angle_table
from nanohevc_tpu_torch.kernels.slab_pipeline import BLOCK_SIZES, transform_table
from nanohevc_tpu_torch.ops.intra import mode_filter_flags
from nanohevc_tpu_torch.ops.mode_decision import decide_modes
from nanohevc_tpu_torch.params import encoder_tables, qp_scalars
from nanohevc_tpu_torch.utils.tracing import count, span

# The TPU kernels' two configurations, (mode_set, decision).
BODIES = {("dc_planar", "energy"): 0, ("all", "satd"): 1}
# The kernel's body shape of each mode set (0 one fixed mode, 1 the pair
# DC / planar, 2 the 35-mode sweep), the fixed body's mode, and its
# costs; decision="rd" has none (the fixed body, which reads no cost,
# takes it).
SHAPES = {"planar": 0, "dc": 0, "dc_planar": 1, "all": 2}
FIXED_MODES = {"planar": 0, "dc": 1}
COSTS = {"energy": 0, "sad": 1, "satd": 2}
SCANS = {"diag": 0, "horizontal": 1, "vertical": 2, "mode": 3}


def wavefront_supported(n: int, mode_set: str, decision: str,
                        use_dst: bool) -> bool:
    """Whether a TPU kernel of the closed loop takes this configuration:
    the union of the TPU kernels' checks, without their TPU batch rule.
    These are the configurations `allow_fast=True` admits."""
    return ((mode_set, decision) in BODIES and n in BLOCK_SIZES
            and (not use_dst or n == 4))


def wavefront_covers(n: int, mode_set: str, decision: str,
                     use_dst: bool) -> bool:
    """Whether the kernel codes this configuration: every mode set and
    per-block decision, `decision="rd"` with the fixed mode sets `dc`
    and `planar` only, at every N (DST at 4 only), with or without
    smoothing and RDOQ."""
    return (mode_set in SHAPES
            and (decision in COSTS
                 or (decision == "rd" and mode_set in FIXED_MODES))
            and n in BLOCK_SIZES and (not use_dst or n == 4))


def filter_mask(n: int, intra_smoothing: bool) -> int:
    """Bit m set where mode m reads the smoothed references: the form
    of `mode_filter_flags(n)` that the encode and decode kernels take (0
    without smoothing)."""
    if not intra_smoothing:
        return 0
    return sum(1 << int(m) for m in np.flatnonzero(mode_filter_flags(n)))


def diagonal_blocks(d: int, nby: int, nbx: int, device) -> tuple:
    """(by, bx) int64 tensors of the blocks on anti-diagonal d, by rising."""
    by = torch.arange(max(0, d - nbx + 1), min(nby, d + 1), device=device)
    return by, d - by


def code_residual(blocks: torch.Tensor, pred: torch.Tensor, qp: int, n: int,
                  *, use_dst: bool = False, bit_depth: int = 8,
                  dequant_rescale: bool = False, rdoq: bool = False,
                  scan: str = "diag", modes: torch.Tensor | None = None,
                  rd_lambda_scale: float = 1.0) -> tuple:
    """The closed loop's encode tail of (m, N, N) blocks and their
    predictions: forward transform, deadzone quantization (then RDOQ in
    the stream's scan order when `rdoq` is set, so that the recon, and
    the neighbours' references, come from the levels the stream
    carries), dequantization, inverse transform, clip.  Returns
    (levels (m, N, N) raster int32, recon (m, N, N) int32)."""
    coeff = ops.forward_transform(blocks - pred, use_dst)
    levels = ops.quantize(coeff, qp, n)
    if rdoq:
        from nanohevc_tpu_torch.ops.rdoq import rd_lambda_calibrated

        lam = rd_lambda_calibrated(qp, n, use_dst, dequant_rescale,
                                   rd_lambda_scale)
        gain = ops.rdoq_gain(n, use_dst, coeff.device).expand(coeff.shape)
        packed = ops.rdoq_levels(
            ops.scan_pack(coeff, scan, modes=modes),
            ops.scan_pack(levels, scan, modes=modes),
            ops.scan_pack(gain, scan, modes=modes),
            qp, n, lam, dequant_rescale=dequant_rescale)
        levels = ops.scan_unpack(packed, scan, modes=modes)
    res = ops.inverse_transform(
        ops.dequantize(levels, qp, n, rescale=dequant_rescale), use_dst)
    return levels, (pred + res).clamp(0, (1 << bit_depth) - 1)


def wavefront_encode_planes_reference(
        planes: torch.Tensor, qp: int, n: int, *,
        mode_set: str = "dc_planar", decision: str = "energy",
        bit_depth: int = 8, use_dst: bool = False,
        dequant_rescale: bool = False,
        intra_smoothing: bool = False, rdoq: bool = False,
        scan: str = "diag", rd_lambda_scale: float = 1.0) -> dict:
    """Plain PyTorch closed loop, on the input's device.

    (B, Hp, Wp) block-aligned int32 planes -> dict(recon (B, Hp, Wp)
    int32, levels (B, nb, N, N) int32 raster blocks, modes (B, nb)
    int32).  A loop over anti-diagonals on a zero-filled recon plane:
    `extract_refs_at` for the diagonal's blocks, `decide_modes` (any
    mode set and per-block decision it takes, smoothing included),
    `code_residual` (RDOQ included, in `scan` order, lambda scaled by
    rd_lambda_scale), then the blocks written back.  The RD decision of
    `dc_planar` and `all`, which prices a batch, runs in
    `kernels.wavefront_rd` instead.
    """
    b, hp, wp = planes.shape
    nby, nbx = hp // n, wp // n
    dev = planes.device
    src = planes.to(torch.int32).reshape(b, nby, n, nbx, n).permute(0, 1, 3, 2, 4)
    recon = torch.zeros((b, hp, wp), dtype=torch.int32, device=dev)
    rec_blocks = recon.view(b, nby, n, nbx, n).permute(0, 1, 3, 2, 4)
    levels = torch.empty((b, nby, nbx, n, n), dtype=torch.int32, device=dev)
    modes = torch.empty((b, nby, nbx), dtype=torch.int32, device=dev)
    boundary = 1 << (bit_depth - 1)
    for d in range(nby + nbx - 1):
        by, bx = diagonal_blocks(d, nby, nbx, dev)
        m = by.shape[0]
        blk = src[:, by, bx].reshape(b * m, n, n)
        refs = ops.extract_refs_at(recon, by, bx, n, boundary)
        pred, mode = decide_modes(blk, refs.reshape(b * m, 4 * n + 2), n,
                                  mode_set, decision, smoothing=intra_smoothing,
                                  bit_depth=bit_depth, qp=qp)
        lev, rec = code_residual(
            blk, pred, qp, n, use_dst=use_dst, bit_depth=bit_depth,
            dequant_rescale=dequant_rescale, rdoq=rdoq, scan=scan,
            modes=mode, rd_lambda_scale=rd_lambda_scale)
        rec_blocks[:, by, bx] = rec.reshape(b, m, n, n)
        levels[:, by, bx] = lev.reshape(b, m, n, n)
        modes[:, by, bx] = mode.reshape(b, m)
    return {"recon": recon, "levels": levels.reshape(b, nby * nbx, n, n),
            "modes": modes.reshape(b, nby * nbx)}


def constant_table() -> np.ndarray:
    """The kernel's constant table (layout in csrc/mode_sweep.cuh): the
    transform matrices, then the angular modes' angles."""
    return np.concatenate([transform_table(), angle_table()])


@lru_cache(maxsize=None)
def cuda_kernels():
    """Build (at first use) and load this kernel's CUDA library."""
    from nanohevc_tpu_torch.kernels.build import KernelLibrary

    return KernelLibrary("wavefront", constant_table())


@lru_cache(maxsize=None)
def _rdoq_table_array(n: int, use_dst: bool) -> np.ndarray:
    """The RDOQ tail's (7 N*N,) int32 table (csrc/rdoq_tail.cuh): float32
    bits of the transform gain by raster position, then of the default
    rate table's sig0, sig1 and last-position bits by scan position, then
    the scan position of each raster position for the diagonal,
    horizontal and vertical scans.  The values `ops.rdoq_levels` reads."""
    from nanohevc_tpu_torch.ops import rate
    from nanohevc_tpu_torch.ops.rdoq import _gain_matrix, _last_cost_vec

    nn = n * n
    table = rate.default_table(nn)
    pos = np.minimum(np.arange(nn), 31)
    key = (float(table.lastfull0), float(table.lastfull1),
           tuple(float(x) for x in table.lastp0),
           tuple(float(x) for x in table.lastp1))
    floats = np.concatenate([
        _gain_matrix(n, use_dst).reshape(nn),
        np.asarray(table.sig0)[pos].astype(np.float32),
        np.asarray(table.sig1)[pos].astype(np.float32),
        _last_cost_vec(nn, key),
    ]).astype(np.float32)
    tabs = encoder_tables(n)
    scans = [tabs[f"scan_{k}_inverse"].numpy() for k in
             ("diag", "horizontal", "vertical")]
    return np.concatenate([floats.view(np.int32)] + scans).astype(np.int32)


@lru_cache(maxsize=None)
def rdoq_tables(n: int, use_dst: bool, device: torch.device) -> torch.Tensor:
    """`_rdoq_table_array` on `device`, made once per (N, DST, device)."""
    return torch.from_numpy(_rdoq_table_array(n, use_dst)).to(device)


def rdoq_scalars(qp: int, n: int, use_dst: bool, dequant_rescale: bool,
                 rd_lambda_scale: float) -> np.ndarray:
    """The RDOQ tail's float32 scalars, as `ops.rdoq_levels` rounds
    them: lambda, lambda * cbf0 (one float32 product), cbf1, gt1_0,
    gt1_1, gt2_0, gt2_1."""
    from nanohevc_tpu_torch.ops import rate
    from nanohevc_tpu_torch.ops.rdoq import rd_lambda_calibrated

    t = rate.default_table(n * n)
    lam = rd_lambda_calibrated(qp, n, use_dst, dequant_rescale,
                               rd_lambda_scale)
    return np.array([lam, np.float32(lam) * np.float32(t.cbf0), t.cbf1,
                     t.gt1_0, t.gt1_1, t.gt2_0, t.gt2_1], dtype=np.float32)


def validate_planes(what: str, planes: torch.Tensor, n: int, bit_depth: int,
                    scan: str, covered: bool, config: str) -> None:
    """The closed-loop kernels' checks of their input: (B, Hp, Wp)
    contiguous block-aligned int32 planes on the CPU or a card, a
    configuration the kernel covers (`covered`, described by `config`),
    a known scan and bit depth."""
    if not isinstance(planes, torch.Tensor) or planes.dim() != 3:
        raise ValueError(f"{what} needs a 3-D (B, H, W) tensor")
    if planes.dtype != torch.int32:
        raise TypeError(f"{what} needs int32, got {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError(f"{what} needs contiguous planes")
    if not covered:
        raise ValueError(f"{what} does not cover {config}")
    if scan not in SCANS:
        raise ValueError(f"unknown scan: {scan!r}")
    if planes.shape[1] % n or planes.shape[2] % n:
        raise ValueError(f"{what} needs block-aligned planes, got "
                         f"{tuple(planes.shape[1:])} at N={n}")
    if not 1 <= bit_depth <= 16:
        raise ValueError(f"unsupported bit depth: {bit_depth}")
    if planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device: {planes.device}")


def work_ints(batch: int, hp: int, wp: int, n: int) -> int:
    """Zeroed int32 words the kernel needs: the ticket counter, then the
    edge buffer, a line of Wp words under each block row of each plane
    but the last (csrc/wavefront.cu, the hand-off)."""
    return 1 + batch * max(hp // n - 1, 0) * wp


def _outputs(planes: torch.Tensor, n: int) -> dict:
    """The kernel's outputs for (B, Hp, Wp) planes, unwritten: recon
    (every pixel written by the kernel), levels (B, nb, N, N), modes
    (B, nb)."""
    b, hp, wp = planes.shape
    nb = (hp // n) * (wp // n)
    dev = planes.device
    return {"recon": torch.empty_like(planes),
            "levels": torch.empty((b, nb, n, n), dtype=torch.int32,
                                  device=dev),
            "modes": torch.empty((b, nb), dtype=torch.int32, device=dev)}


def _launch(kern, planes: torch.Tensor, qp: int, n: int, *,
            mode_set: str = "dc_planar", decision: str = "energy",
            bit_depth: int = 8, use_dst: bool = False,
            dequant_rescale: bool = False, intra_smoothing: bool = False,
            rdoq: bool = False, scan: str = "diag",
            rd_lambda_scale: float = 1.0,
            max_grid: int = 0) -> tuple[dict, int]:
    """One launch of `kern`'s nhv_wavefront_encode (this package's
    library, or a tool's build of another tree or an edited copy) on
    the current stream, with a grid of at most max_grid thread blocks
    (0: no cap): (dict(recon, levels, modes), grids launched)."""
    b, hp, wp = planes.shape
    dev = planes.device
    out = _outputs(planes, n)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    kern.ensure_tables(index)
    q = qp_scalars(qp, n, bit_depth, dequant_rescale)
    smooth = intra_smoothing and n > 4
    # the strong filter's flatness threshold (N = 32 only), computed as
    # the plain version computes it
    thresh = 1 << (bit_depth - 5) if smooth and n == 32 else 0
    tables, scalars = None, None
    if rdoq:
        tables = rdoq_tables(n, use_dst, torch.device("cuda", index))
        scalars = rdoq_scalars(qp, n, use_dst, dequant_rescale,
                               rd_lambda_scale)
    work = torch.zeros(work_ints(b, hp, wp, n), dtype=torch.int32, device=dev)
    grids = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = kern.lib.nhv_wavefront_encode(
        planes.data_ptr(), b, hp, wp, n, SHAPES[mode_set],
        COSTS.get(decision, 0),
        FIXED_MODES.get(mode_set, 0), int(use_dst), *q, thresh,
        filter_mask(n, smooth), SCANS[scan] if rdoq else -1,
        tables.data_ptr() if rdoq else None,
        scalars.ctypes.data if rdoq else None, out["recon"].data_ptr(),
        out["levels"].data_ptr(), out["modes"].data_ptr(), work.data_ptr(),
        ctypes.addressof(grids), max_grid, stream, index,
    )
    if rc != 0:
        raise RuntimeError(f"nhv_wavefront_encode failed: CUDA error {rc}")
    return out, grids.value


def wavefront_encode_planes(planes: torch.Tensor, qp: int, n: int, *,
                            mode_set: str = "dc_planar",
                            decision: str = "energy", bit_depth: int = 8,
                            use_dst: bool = False,
                            dequant_rescale: bool = False,
                            intra_smoothing: bool = False,
                            rdoq: bool = False, scan: str = "diag",
                            rd_lambda_scale: float = 1.0,
                            _max_grid: int = 0) -> dict:
    """(B, Hp, Wp) block-aligned int32 planes -> dict(recon, levels,
    modes), as `wavefront_encode_planes_reference` describes, for the
    configurations `wavefront_covers` admits.

    qp is a static Python int.  On a CUDA tensor this runs the
    hand-written kernel, one persistent grid launch per call, on the
    current stream (no synchronisation), adds one to
    `wavefront_encode_planes.launches` and the grids the C call
    launched to `wavefront_encode_planes.grids`, and counts the launch
    in `wavefront_encode_planes.launches_by_config` under (mode_set,
    decision, smoothing, rdoq); while a torch profiler records, its host
    work is the span "wavefront.launch" and the blocks it codes are
    counted as "wavefront.blocks" (`utils.tracing`).  On a CPU tensor it
    runs the plain version.  `scan` matters under `rdoq` only (the
    levels come back in raster order).  `_max_grid`, a cap on the grid
    (0: none), is for the tests of the kernel's schedule on small grids.
    """
    kw = dict(mode_set=mode_set, decision=decision, bit_depth=bit_depth,
              use_dst=use_dst, dequant_rescale=dequant_rescale,
              intra_smoothing=intra_smoothing, rdoq=rdoq, scan=scan,
              rd_lambda_scale=rd_lambda_scale)
    if isinstance(planes, torch.Tensor) and planes.device.type == "cuda":
        return _encode_on_card(planes, qp, n, _max_grid, kw)
    _validate(planes, n, kw)
    return wavefront_encode_planes_reference(planes, qp, n, **kw)


def _validate(planes: torch.Tensor, n: int, kw: dict) -> None:
    mode_set, decision, use_dst = kw["mode_set"], kw["decision"], kw["use_dst"]
    validate_planes("wavefront_encode_planes", planes, n, kw["bit_depth"],
                    kw["scan"], wavefront_covers(n, mode_set, decision, use_dst),
                    f"n={n}, mode_set={mode_set!r}, decision={decision!r}, "
                    f"use_dst={use_dst}")


def _encode_on_card(planes: torch.Tensor, qp: int, n: int, max_grid: int,
                    kw: dict) -> dict:
    """The card's path of `wavefront_encode_planes`: checks, tables and
    one launch (the span "wavefront.launch"), then the counters."""
    with span("wavefront.launch"):
        _validate(planes, n, kw)
        if planes.numel() == 0:
            return _outputs(planes, n)
        out, grids = _launch(cuda_kernels(), planes, qp, n,
                             max_grid=max_grid, **kw)
    wavefront_encode_planes.launches += 1
    wavefront_encode_planes.grids += grids
    key = (kw["mode_set"], kw["decision"],
           kw["intra_smoothing"] and n > 4, bool(kw["rdoq"]))
    by_config = wavefront_encode_planes.launches_by_config
    by_config[key] = by_config.get(key, 0) + 1
    count("wavefront.blocks", out["modes"].numel())
    return out


wavefront_encode_planes.launches = 0
wavefront_encode_planes.grids = 0
# launches by (mode_set, decision, smoothing at n > 4, rdoq)
wavefront_encode_planes.launches_by_config = {}
