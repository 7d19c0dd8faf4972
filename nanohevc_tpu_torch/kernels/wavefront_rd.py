"""The closed loop under `decision="rd"`: CUDA kernel wrapper and its plain
PyTorch version.

Port of the RD branch of the JAX package's closed-loop XLA scan
(`nanohevc_tpu/models/wavefront.py`, `encode_planes_closed_loop`'s
`jax.lax.scan` with decision="rd", vmapped over frames; no Pallas
kernel): each frame's anti-diagonals in order, every diagonal deciding
all nby slots of JAX's skewed layout (the slots off the plane included)
by SSE + lambda * bits, the bits from the adaptive rate model over the
diagonal's candidates (`ops.rate`), plus lambda times each candidate's
exact MPM bits; then the chosen block's encode tail (RDOQ in `scan`
order when set).

One kernel, `csrc/wavefront_rd.cu`, codes the whole plane batch in one
persistent cooperative launch.  A thread block owns W consecutive slots
of a frame; the grid holds the thread blocks of F frames, F the whole
batch where it fits the card at once, and a block codes frames f0, f0 +
F, ... in turn (W and F chosen so that the grid is co-resident; the
launch is refused, and this wrapper raises, only where not one frame's
thread blocks fit).  Per diagonal it takes its first slot's top arm, corner and the
mode above from the tagged message of the block above, evaluates every
candidate of its slots (`csrc/row_tail.cuh`'s row-per-lane body) and
adds their bins to the frame's counters of that diagonal, each counter
counting its own arrivals; once every thread block of the frame has
added, it prices the counts on the card (`csrc/rate_model.cuh`, the
host's float32 arithmetic, each transcendental in float64 rounded
once), decides and codes its slots, sends its message to the block
below and builds its next references from windows of JAX's skewed
buffers kept in shared memory.  One synchronisation a frame and
diagonal, no grid barrier and no fence, frames never wait for one
another, no host round trip inside the launch.  It uses
`csrc/intra_smooth.cuh`, `mode_sweep.cuh`'s predictors, `row_tail.cuh`
(with `encode_tail.cuh`), `rate_model.cuh`, `rdoq_tail.cuh` and
`wavefront_sync.cuh`; its header says how it is laid out and what
bounds it.

`wavefront_rd_encode_planes` dispatches on the device of its input: a
CPU tensor goes to the plain loop, a CUDA tensor to the kernel (or an
exception).  There is no fallback.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from nanohevc_tpu_torch.kernels.mode_search import angle_table
from nanohevc_tpu_torch.kernels.slab_pipeline import BLOCK_SIZES, transform_table
from nanohevc_tpu_torch.kernels.wavefront import (
    SCANS,
    code_residual,
    filter_mask,
    rdoq_scalars,
    rdoq_tables,
    validate_planes,
)
from nanohevc_tpu_torch.ops import rate
from nanohevc_tpu_torch.ops.mode_decision import decide_modes
from nanohevc_tpu_torch.ops.mode_rate import mpm_mode_bits
from nanohevc_tpu_torch.params import qp_scalars

# The mode sets whose decision prices candidates: the pair DC / planar,
# and the 35 modes.
MODE_SETS = {"dc_planar": 0, "all": 1}


# cudaErrorCooperativeLaunchTooLarge: no grid of this geometry fits the
# card at once.
COOPERATIVE_TOO_LARGE = 720

# The rate model's float32 constants, as `ops.rate` rounds them:
# log(31/32) and log(2).
RATE_CONSTS = (float(np.float32(np.log(rate._GAMMA))),
               float(np.float32(rate._LN2)))


# --- the RD decision's slot batches -------------------------------------------
#
# The RD decision prices candidates with the adaptive rate model, whose
# statistics come from the whole batch it is given.  JAX decides each
# diagonal of a frame on all nby slots of its skewed layout, the slots
# off the plane included (they hold neighbouring rows' blocks and read
# references from the skewed buffers); these helpers rebuild that
# layout, so that every batch holds the same rows as JAX's.

def _skew_tables(nby: int, nbx: int) -> tuple:
    """(bx (ndiag, nby), valid (ndiag, nby)) of the skewed wavefront:
    slot by of diagonal d holds block (by, d - by)."""
    ndiag = nby + nbx - 1
    bx = np.arange(ndiag)[:, None] - np.arange(nby)[None, :]
    return bx, (bx >= 0) & (bx < nbx)


def _skew_blocks(raster: torch.Tensor, nby: int, nbx: int) -> torch.Tensor:
    """Raster (B, nby*nbx, ...) -> skewed (B, ndiag, nby, ...) by one pad
    and reshape: skewed[d, by] = raster[by, d - by] where valid, and the
    pad or a neighbouring row's block where not."""
    b = raster.shape[0]
    rest = tuple(raster.shape[2:])
    ndiag = nby + nbx - 1
    x = raster.reshape(b, nby, nbx, *rest)
    pad = x.new_zeros((b, nby, ndiag + 1 - nbx, *rest))
    x = torch.cat([x, pad], dim=2).reshape(b, nby * (ndiag + 1), *rest)
    return x[:, :nby * ndiag].reshape(b, nby, ndiag, *rest).transpose(1, 2)


def _deskew_blocks(skewed: torch.Tensor, nby: int, nbx: int) -> torch.Tensor:
    """Skewed (B, ndiag, nby, ...) -> raster (B, nby*nbx, ...), the
    inverse shear of `_skew_blocks`."""
    b, ndiag = skewed.shape[:2]
    rest = tuple(skewed.shape[3:])
    x = skewed.transpose(1, 2).reshape(b, nby * ndiag, *rest)
    x = torch.cat([x, x.new_zeros((b, nby, *rest))], dim=1)
    return x.reshape(b, nby, ndiag + 1, *rest)[:, :, :nbx].reshape(
        b, nby * nbx, *rest)


def _skew_buffers(nby: int, nbx: int, n: int, device) -> tuple:
    """Zero skewed boundary buffers (bottom rows, right columns): row by
    of the first holds recon row (by+1)*N-1 from column by*N+N+1; row
    bx+nby of the second holds recon column (bx+1)*N-1 from row
    bx*N+N+1.  Diagonal d then reads at offset d*N and writes at
    d*N+N+1 in every slot."""
    ndiag = nby + nbx - 1
    width = (ndiag + 2) * n + 2
    return (torch.zeros((nby, width), dtype=torch.int32, device=device),
            torch.zeros((ndiag + nby, width), dtype=torch.int32, device=device))


def _read_refs_skewed(s_bot: torch.Tensor, r_sp: torch.Tensor, d: int, n: int,
                      nby: int, boundary: int, bx: torch.Tensor) -> torch.Tensor:
    """(nby, 4N+2) references of diagonal d's slots from the skewed
    buffers, laid out as `ops.extract_refs_at` lays them out."""
    top_rows = s_bot[:, d * n:d * n + 2 * n + 1]
    top = torch.cat([torch.full_like(top_rows[:1], boundary), top_rows[:-1]])
    left = r_sp[d:d + nby, d * n:d * n + 2 * n + 1].flip(0)
    left = torch.where((bx == 0)[:, None], boundary, left)
    by = torch.arange(nby, device=bx.device)
    corner_edge = ((by == 0) | (bx == 0))[:, None]
    top = torch.cat([torch.where(corner_edge, boundary, top[:, :1]),
                     top[:, 1:]], dim=1)
    left = torch.cat([torch.where(corner_edge, boundary, left[:, :1]),
                      left[:, 1:]], dim=1)
    return torch.cat([top, left], dim=-1)


def _write_bufs_skewed(s_bot: torch.Tensor, r_sp: torch.Tensor,
                       rec: torch.Tensor, d: int, ok: torch.Tensor,
                       bx: torch.Tensor, n: int, nby: int, nbx: int) -> None:
    """Blend diagonal d's bottom rows and right columns into the buffers
    in place; valid slots write, with the N-wide tail replicating the
    last pixel at the plane's last block column (row), invalid slots
    keep the old contents.  The padded planes are block-aligned."""
    c0 = d * n + n + 1
    okc = ok[:, None]
    last_pix = rec[:, n - 1, n - 1:n]
    old_b = s_bot[:, c0:c0 + 2 * n]
    head = torch.where(okc, rec[:, n - 1, :], old_b[:, :n])
    tail = torch.where(okc & (bx == nbx - 1)[:, None], last_pix, old_b[:, n:])
    s_bot[:, c0:c0 + 2 * n] = torch.cat([head, tail], dim=1)
    old_r = r_sp[d + 1:d + 1 + nby, c0:c0 + 2 * n].flip(0)
    by = torch.arange(nby, device=rec.device)
    head = torch.where(okc, rec[:, :, n - 1], old_r[:, :n])
    tail = torch.where(okc & (by == nby - 1)[:, None], last_pix, old_r[:, n:])
    r_sp[d + 1:d + 1 + nby, c0:c0 + 2 * n] = torch.cat([head, tail], 1).flip(0)


def wavefront_rd_encode_planes_reference(
        planes: torch.Tensor, qp: int, n: int, *, mode_set: str,
        use_dst: bool, bit_depth: int, scan: str, dequant_rescale: bool,
        intra_smoothing: bool, rdoq: bool, rd_lambda_scale: float) -> dict:
    """The closed loop under decision="rd", frame by frame on JAX's
    slot batches: (B, Hp, Wp) block-aligned planes -> the dict of
    `kernels.wavefront.wavefront_encode_planes_reference`.  The plain
    version of `wavefront_rd_encode_planes`.

    Each diagonal decides all nby slots in one `decide_modes` call, with
    the exact MPM bits of the slots' left and above neighbours (the
    previous diagonal's modes, DC where unavailable); the lambda of the
    decision is unscaled and rd_lambda_scale reaches RDOQ only, as in
    JAX.
    """
    b, hp, wp = planes.shape
    nby, nbx = hp // n, wp // n
    ndiag = nby + nbx - 1
    dev = planes.device
    blocks = planes.reshape(b, nby, n, nbx, n).permute(0, 1, 3, 2, 4)
    blocks_sk = _skew_blocks(blocks.reshape(b, nby * nbx, n, n), nby, nbx)
    bx_t, ok_t = (torch.from_numpy(t).to(dev) for t in _skew_tables(nby, nbx))
    boundary = 1 << (bit_depth - 1)
    slot = torch.arange(nby, device=dev)
    dc = torch.ones(1, dtype=torch.int32, device=dev)
    frames = []
    for f in range(b):
        s_bot, r_sp = _skew_buffers(nby, nbx, n, dev)
        prev = dc.expand(nby)
        steps = []
        for d in range(ndiag):
            refs = _read_refs_skewed(s_bot, r_sp, d, n, nby, boundary, bx_t[d])
            mode_bits = mpm_mode_bits(torch.where(slot == d, 1, prev),
                                      torch.cat([dc, prev[:-1]]))
            pred, prev = decide_modes(
                blocks_sk[f, d], refs, n, mode_set, "rd",
                smoothing=intra_smoothing, bit_depth=bit_depth, qp=qp,
                use_dst=use_dst, dequant_rescale=dequant_rescale,
                mode_bits=mode_bits)
            levels, rec = code_residual(
                blocks_sk[f, d], pred, qp, n, use_dst=use_dst,
                bit_depth=bit_depth, dequant_rescale=dequant_rescale,
                rdoq=rdoq, scan=scan, modes=prev,
                rd_lambda_scale=rd_lambda_scale)
            _write_bufs_skewed(s_bot, r_sp, rec, d, ok_t[d], bx_t[d], n, nby,
                               nbx)
            steps.append((rec, levels, prev))
        frames.append([torch.stack(x) for x in zip(*steps)])
    rec, levels, modes = (_deskew_blocks(torch.stack(x), nby, nbx)
                          for x in zip(*frames))
    recon = rec.reshape(b, nby, nbx, n, n).permute(0, 1, 3, 2, 4).reshape(
        b, hp, wp)
    return {"recon": recon, "levels": levels, "modes": modes}


@lru_cache(maxsize=None)
def cuda_kernels():
    """Build (at first use) and load this kernel's CUDA library."""
    from nanohevc_tpu_torch.kernels.build import KernelLibrary

    return KernelLibrary("wavefront_rd",
                         np.concatenate([transform_table(), angle_table()]))


def _validate(planes: torch.Tensor, n: int, mode_set: str, use_dst: bool,
              bit_depth: int, scan: str) -> None:
    validate_planes(
        "wavefront_rd_encode_planes", planes, n, bit_depth, scan,
        mode_set in MODE_SETS and n in BLOCK_SIZES and (not use_dst or n == 4),
        f"n={n}, mode_set={mode_set!r} (it decides {sorted(MODE_SETS)}), "
        f"use_dst={use_dst}")


def _launch(planes: torch.Tensor, qp: int, n: int, mode_set: str,
            bit_depth: int, use_dst: bool, dequant_rescale: bool,
            intra_smoothing: bool, rdoq: bool, scan: str,
            rd_lambda_scale: float, kern=None) -> tuple:
    """One launch of the kernel on the planes' card: (the output dict,
    the grid's thread blocks, the frames F it holds at once).  `kern`, a KernelLibrary with this C
    entry, stands in for this package's library (another tree's build,
    timed against this one)."""
    b, hp, wp = planes.shape
    nb = (hp // n) * (wp // n)
    dev = planes.device
    out = {"recon": torch.empty_like(planes),   # every pixel is written
           "levels": torch.empty((b, nb, n, n), dtype=torch.int32,
                                 device=dev),
           "modes": torch.empty((b, nb), dtype=torch.int32, device=dev)}
    if b * nb == 0:
        return out, 0, 0
    kern = kern or cuda_kernels()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    kern.ensure_tables(index)
    all_modes = MODE_SETS[mode_set]
    words = kern.lib.nhv_wavefront_rd_work_ints(b, hp, wp, n, all_modes)
    if words < 0:
        raise ValueError(f"wavefront_rd_encode_planes: {b} planes of "
                         f"{hp}x{wp} at N={n} exceed the kernel's work buffer")
    work = torch.zeros(words, dtype=torch.int32, device=dev)
    q = qp_scalars(qp, n, bit_depth, dequant_rescale)
    smooth = intra_smoothing and n > 4
    thresh = 1 << (bit_depth - 5) if smooth and n == 32 else 0
    tables = rdoq_tables(n, use_dst, torch.device("cuda", index))
    scalars = (rdoq_scalars(qp, n, use_dst, dequant_rescale, rd_lambda_scale)
               if rdoq else None)
    info = (ctypes.c_int * 3)(0, 0, 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = kern.lib.nhv_wavefront_rd(
        planes.data_ptr(), b, hp, wp, n, all_modes, int(use_dst), *q, thresh,
        filter_mask(n, smooth), SCANS[scan] if rdoq else -1,
        tables.data_ptr(), scalars.ctypes.data if rdoq else None,
        float(rate._rd_lambda(qp, 1.0)), *RATE_CONSTS,
        out["recon"].data_ptr(), out["levels"].data_ptr(),
        out["modes"].data_ptr(), work.data_ptr(), ctypes.addressof(info),
        stream, index,
    )
    if rc == COOPERATIVE_TOO_LARGE:
        raise RuntimeError(f"nhv_wavefront_rd: the thread blocks of one "
                           f"{hp}x{wp} plane at N={n} cannot be co-resident "
                           f"on this card (CUDA error {rc})")
    if rc != 0:
        raise RuntimeError(f"nhv_wavefront_rd failed: CUDA error {rc}")
    return out, info[1], info[2]


def wavefront_rd_encode_planes(planes: torch.Tensor, qp: int, n: int, *,
                               mode_set: str = "dc_planar",
                               bit_depth: int = 8, use_dst: bool = False,
                               dequant_rescale: bool = False,
                               intra_smoothing: bool = False,
                               rdoq: bool = False, scan: str = "diag",
                               rd_lambda_scale: float = 1.0) -> dict:
    """(B, Hp, Wp) block-aligned int32 planes -> dict(recon (B, Hp, Wp),
    levels (B, nb, N, N) raster blocks, modes (B, nb)), all int32: the
    closed loop under decision="rd" with mode_set "dc_planar" or "all",
    each frame decided on its own slot batches.

    qp is a static Python int; the decision's lambda is unscaled and
    rd_lambda_scale reaches RDOQ only.  On a CUDA tensor this runs the
    hand-written kernel, one persistent cooperative launch per call, on
    the current stream (no synchronisation), adds one to
    `wavefront_rd_encode_planes.launches` and the grids it launched to
    `.grids`, and counts the launch in `.launches_by_config` under
    (mode_set, smoothing at n > 4, rdoq); on a CPU tensor it runs the
    plain loop `wavefront_rd_encode_planes_reference`.  `scan` matters
    under `rdoq` only (the levels come back in raster order).
    """
    _validate(planes, n, mode_set, use_dst, bit_depth, scan)
    kw = dict(mode_set=mode_set, bit_depth=bit_depth, use_dst=use_dst,
              dequant_rescale=dequant_rescale,
              intra_smoothing=intra_smoothing, rdoq=rdoq, scan=scan,
              rd_lambda_scale=rd_lambda_scale)
    if planes.device.type == "cpu":
        return wavefront_rd_encode_planes_reference(planes, int(qp), n, **kw)
    out, blocks, _ = _launch(planes, int(qp), n, **kw)
    if blocks:
        fn = wavefront_rd_encode_planes
        fn.launches += 1
        fn.grids += 1
        key = (mode_set, intra_smoothing and n > 4, bool(rdoq))
        fn.launches_by_config[key] = fn.launches_by_config.get(key, 0) + 1
    return out


wavefront_rd_encode_planes.launches = 0
wavefront_rd_encode_planes.grids = 0
# launches by (mode_set, smoothing at n > 4, rdoq)
wavefront_rd_encode_planes.launches_by_config = {}


def barriers_only(planes: torch.Tensor, n: int, mode_set: str,
                  kern=None) -> int:
    """Launch the encoder's grid (without RDOQ) for these CUDA planes
    through its synchronisation alone: per diagonal the message of the
    block above, the frame's counters and the message for the block
    below, with an empty body (what the kernel's synchronisation costs
    alone); writes no output and counts no launch.  Returns the grid's thread blocks.  `kern` as
    `_launch`'s."""
    _validate(planes, n, mode_set, False, 8, "diag")
    if planes.device.type != "cuda":
        raise ValueError("barriers_only runs on a CUDA card only")
    b, hp, wp = planes.shape
    dev = planes.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = (kern or cuda_kernels()).lib
    words = lib.nhv_wavefront_rd_work_ints(b, hp, wp, n, MODE_SETS[mode_set])
    if words < 0:
        raise ValueError(f"barriers_only: {b} planes of {hp}x{wp} at N={n} "
                         f"exceed the kernel's work buffer")
    work = torch.zeros(words, dtype=torch.int32, device=dev)
    info = (ctypes.c_int * 3)(0, 0, 0)
    rc = lib.nhv_wavefront_rd_barriers(
        b, hp, wp, n, MODE_SETS[mode_set], work.data_ptr(),
        ctypes.addressof(info), torch.cuda.current_stream(dev).cuda_stream,
        index)
    if rc != 0:
        raise RuntimeError(f"nhv_wavefront_rd_barriers failed: CUDA error "
                           f"{rc}")
    return info[1]


def device_prices(n1: torch.Tensor, n: torch.Tensor) -> tuple:
    """The kernel's per-context prices (ones, zeros) of the bin-count
    pairs (n1 ones of n bins), int32 CUDA tensors with n < 2^24, as
    float32 tensors on the card: the device function every context is
    priced with.  Its plain version is `ops.rate._prices` on the host."""
    if n1.device.type != "cuda" or n1.shape != n.shape or \
            n1.dtype != torch.int32 or n.dtype != torch.int32:
        raise ValueError("device_prices needs two int32 CUDA tensors of one "
                         "shape")
    n1, n = n1.contiguous(), n.contiguous()
    kern = cuda_kernels()
    dev = n1.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    c1 = torch.empty(n1.shape, dtype=torch.float32, device=dev)
    c0 = torch.empty_like(c1)
    rc = kern.lib.nhv_rd_prices(
        n1.data_ptr(), n.data_ptr(), n1.numel(), *RATE_CONSTS,
        c1.data_ptr(), c0.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, index)
    if rc != 0:
        raise RuntimeError(f"nhv_rd_prices failed: CUDA error {rc}")
    return c1, c0
