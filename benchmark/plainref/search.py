"""The closed-loop frame encode under a per-block decision over the 35
modes, as plain PyTorch: what the benchmark holds
`encode_frame_closed_loop` to under x265's fast presets (decision
"satd"; "sad" and "energy" too).

It follows the port's plain versions (`kernels/wavefront.py::
wavefront_encode_planes_reference` and `code_residual`,
`models/all_intra.py::decide_modes`, `encode_planes_closed_loop`'s
filters) through the frozen ops of this package, with these changes of
shape and none of arithmetic:

- the diagonal loop runs a batch of planes at once, on `encoder.py`'s
  skewed layout: each diagonal codes all nby slots, and the slots off
  the plane are coded and never written back.  A per-block decision
  reads no other block, so they move nothing; the references come from
  the skewed buffers, which give the closed loop's availability rule
  that the port reads through `ops.extract_refs_at`;
- the 35 candidates' costs are taken at once and the mode is their
  first minimum in the order planar, DC, 2..34, where the port keeps a
  running minimum over chunks of angular modes with strict `<`: both
  take the lowest mode among equal costs.

The costs are the port's exact integers, taken in float64 (exact for
them) where the port sums in int32 and runs its Hadamard passes as
float64 matmuls.  `cost_dtype` is the control's switch: torch.bfloat16
computes each candidate's cost in bfloat16 from the residual on (the
Hadamard passes, the magnitudes and the sum).
"""

from __future__ import annotations

import numpy as np
import torch

from plainref import ops
from plainref.encoder import (
    PLANES,
    _deskew_blocks,
    _read_refs,
    _skew_blocks,
    _skew_tables,
    _write_bufs,
    code_residual,
    pad_to_blocks,
    plane_args,
)
from plainref.ops.intra import PLANAR_MODE
from plainref.ops.sao import apply_sao_ctb
from plainref.ops.sao_ctb import estimate_sao_ctb

DECISIONS = ("energy", "sad", "satd")


def hadamard_matrix(n: int) -> np.ndarray:
    """Sylvester-ordered {-1, +1} Hadamard matrix, n a power of two."""
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def _costs(blocks: torch.Tensor, preds: torch.Tensor, decision: str,
           dtype: torch.dtype) -> torch.Tensor:
    """(nb, N, N) blocks, (nb, M, N, N) predictions -> (nb, M) costs,
    computed in `dtype` from the residual on: the residual's energy, its
    absolute sum (SAD), or the absolute sum of its Sylvester Hadamard
    transform (SATD).  float64 holds every term and sum exactly."""
    d = (blocks[:, None] - preds).to(dtype)
    if decision == "energy":
        return (d * d).sum(dim=(-2, -1))
    if decision == "satd":
        h = torch.as_tensor(hadamard_matrix(d.shape[-1]), dtype=dtype,
                            device=d.device)
        d = torch.matmul(torch.matmul(h, d), h.T)
    return d.abs().sum(dim=(-2, -1))


def decide_search(blocks: torch.Tensor, refs: torch.Tensor, n: int,
                  decision: str, *, smoothing: bool, bit_depth: int,
                  cost_dtype: torch.dtype = torch.float64) -> tuple:
    """The 35-mode search by `decision`, smoothing as the filter flags
    say: (pred (nb, N, N), mode (nb,) int32)."""
    flags = ops.mode_filter_flags(n) if smoothing else None
    refs_f = ops.smooth_refs(refs, n, bit_depth) if smoothing and n > 4 else refs
    dc = ops.dc_predict(refs, n)                     # DC always unfiltered
    pl = ops.planar_predict(
        refs_f if (flags is not None and flags[PLANAR_MODE]) else refs, n)
    routed = smoothing and n > 4
    refs_in = torch.cat([refs, refs_f], dim=1) if routed else refs
    preds = torch.cat([pl[:, None], dc[:, None], ops.angular_predict_modes(
        refs_in, n, ops.ALL_ANGULAR, routed)], dim=1)
    mode = _costs(blocks, preds, decision, cost_dtype).argmin(dim=1)  # ties: lowest
    pred = preds[torch.arange(blocks.shape[0], device=blocks.device), mode]
    return pred, mode.to(torch.int32)


def encode_planes_search(planes: torch.Tensor, qp: int, n: int, *,
                         decision: str, use_dst: bool, bit_depth: int,
                         scan: str, dequant_rescale: bool,
                         intra_smoothing: bool, rdoq: bool,
                         cost_dtype: torch.dtype = torch.float64) -> dict:
    """The closed loop of (P, Hp, Wp) block-aligned planes, all P at
    once -> {"recon" (P, Hp, Wp), "levels" (P, nb, N, N) raster, "modes"
    (P, nb)}."""
    b, hp, wp = planes.shape
    nby, nbx = hp // n, wp // n
    ndiag = nby + nbx - 1
    dev = planes.device
    blocks = planes.reshape(b, nby, n, nbx, n).permute(0, 1, 3, 2, 4)
    blocks_sk = _skew_blocks(blocks.reshape(b, nby * nbx, n, n), nby, nbx)
    bx_t, ok_t = (torch.from_numpy(t).to(dev) for t in _skew_tables(nby, nbx))
    boundary = 1 << (bit_depth - 1)
    width = (ndiag + 2) * n + 2
    s_bot = torch.zeros((b, nby, width), dtype=torch.int32, device=dev)
    r_sp = torch.zeros((b, ndiag + nby, width), dtype=torch.int32, device=dev)
    steps = []
    for d in range(ndiag):
        refs = _read_refs(s_bot, r_sp, d, n, nby, boundary, bx_t[d])
        blk = blocks_sk[:, d].reshape(b * nby, n, n)
        pred, mode = decide_search(
            blk, refs.reshape(b * nby, 4 * n + 2), n, decision,
            smoothing=intra_smoothing, bit_depth=bit_depth,
            cost_dtype=cost_dtype)
        levels, rec = code_residual(
            blk, pred, qp, n, use_dst=use_dst, bit_depth=bit_depth,
            dequant_rescale=dequant_rescale, rdoq=rdoq, scan=scan,
            modes=mode)
        rec = rec.reshape(b, nby, n, n)
        _write_bufs(s_bot, r_sp, rec, d, ok_t[d], bx_t[d], n, nby, nbx)
        steps.append((rec, levels.reshape(b, nby, n, n), mode.reshape(b, nby)))
    rec, levels, modes = (_deskew_blocks(torch.stack(x, dim=1), nby, nbx)
                          for x in zip(*steps))
    recon = rec.reshape(b, nby, nbx, n, n).permute(0, 1, 3, 2, 4).reshape(
        b, hp, wp)
    return {"recon": recon, "levels": levels, "modes": modes}


def check_config(cfg: dict) -> None:
    """This reference covers the closed loop's 35-mode search by a
    per-block decision on both plane kinds, with CTB SAO, deblocking and
    the CABAC container; it refuses anything else."""
    want = dict(sao=False, sao_ctb=True, deblock=True, entropy_coder="cabac",
                is_intra=True)
    bad = {k: cfg.get(k) for k, v in want.items() if cfg.get(k, v) != v}
    if (bad or cfg["decision"] not in DECISIONS or cfg["mode_set"] != "all"
            or cfg.get("chroma_mode_set") not in (None, "all")):
        raise ValueError(f"the search reference does not cover {bad or cfg}")


def encode_planes(planes: torch.Tensor, cfg: dict, is_luma: bool,
                  cost_dtype: torch.dtype = torch.float64) -> dict:
    """(P, H, W) planes of one kind -> the dict of `encoder.encode_planes`."""
    check_config(cfg)
    a = plane_args(cfg, is_luma)
    n, qp, bd = a["n"], int(cfg["qp"]), int(cfg["bit_depth"])
    b, h, w = planes.shape
    src = pad_to_blocks(planes.to(torch.int32), n)
    out = encode_planes_search(
        src, qp, n, decision=cfg["decision"], use_dst=a["use_dst"],
        bit_depth=bd, scan=cfg["scan"],
        dequant_rescale=bool(cfg["dequant_rescale"]),
        intra_smoothing=a["intra_smoothing"], rdoq=bool(cfg["rdoq"]),
        cost_dtype=cost_dtype)
    nb = out["modes"].shape[1]
    levels = ops.scan_pack(out["levels"].reshape(b * nb, n, n), cfg["scan"],
                           modes=out["modes"].reshape(b * nb))
    recon = ops.deblock_plane(out["recon"], qp, bit_depth=bd,
                              is_chroma=a["deblock_chroma"])
    tile = int(cfg["sao_tile"])
    sao = estimate_sao_ctb(src, recon, tile, qp, bd, 1.0, True)
    recon = apply_sao_ctb(recon, *sao, tile, bd)
    return {"recon": recon[:, :h, :w], "levels": levels.reshape(b, nb, n * n),
            "modes": out["modes"], "sao_ctb": sao, "n": n}


def encode_frames(frames: list, cfg: dict, device,
                  cost_dtype: torch.dtype = torch.float64) -> list:
    """Frames as (y, u, v) integer arrays -> one dict a frame, in the
    shapes of `encoder.encode_frames`.  Luma of every frame is coded in
    one batch, U and V of every frame in another."""
    k = len(frames)
    luma = torch.from_numpy(np.stack([f[0] for f in frames]).astype(
        np.int32)).to(device)
    chroma = torch.from_numpy(np.stack(
        [f[1] for f in frames] + [f[2] for f in frames]).astype(
            np.int32)).to(device)
    both = encode_planes(chroma, cfg, False, cost_dtype)
    parts = {"Y": (encode_planes(luma, cfg, True, cost_dtype), range(k)),
             "U": (both, range(k)), "V": (both, range(k, 2 * k))}
    tile = int(cfg["sao_tile"])
    out = [{"recon": {}, "levels": {}, "modes": {}, "sao_ctb": {}}
           for _ in range(k)]
    for name in PLANES:
        res, rows = parts[name]
        host = {key: res[key].cpu().numpy()
                for key in ("recon", "levels", "modes")}
        sao = tuple(x.cpu().numpy() for x in res["sao_ctb"])
        for f, r in enumerate(rows):
            out[f]["recon"][name] = host["recon"][r].astype(np.int16)
            out[f]["levels"][name] = (host["levels"][r].astype(np.int32),
                                      res["n"])
            out[f]["modes"][name] = host["modes"][r].astype(np.int32)
            out[f]["sao_ctb"][name] = (tile,) + tuple(x[r] for x in sao)
    return out
