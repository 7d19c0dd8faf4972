"""The closed-loop frame encode under decision="rd", as plain PyTorch:
what the benchmark holds `encode_frame_closed_loop` to.

It follows the port's plain versions (`models/wavefront.py::
_encode_planes_rd`, `models/all_intra.py::decide_modes`,
`kernels/wavefront.py::code_residual`, `encode_planes_closed_loop`'s
filters) through the frozen ops of this package, with one change of
shape and none of arithmetic: the diagonal loop runs a batch of planes
at once.  The RD decision prices each diagonal's candidates with the
adaptive rate model, from the counts of that plane's diagonal alone
(all nby slots of the skewed layout, the off-plane slots included), so
the counts, the prices and the bits are taken per plane (`group_*`),
in the frozen model's float32 order; every other step is per block.

`cost_dtype` is the control's switch: torch.bfloat16 adds each
candidate's distortion and lambda-weighted bits in bfloat16 in place of
float32, the precision the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from plainref import ops
from plainref.ops import rate
from plainref.ops.intra import DC_MODE, PLANAR_MODE, _by_mode
from plainref.ops.mode_rate import mpm_mode_bits
from plainref.ops.rate import _rd_lambda
from plainref.ops.rdoq import rd_lambda_calibrated
from plainref.ops.sao import apply_sao_ctb
from plainref.ops.sao_ctb import estimate_sao_ctb

PLANES = ("Y", "U", "V")

# Elements (block x mode x pixel) a chunk of angular candidates holds.
_SEARCH_CHUNK_ELEMS = 1 << 23


# --- the adaptive rate model, per plane of a batch ----------------------------

def group_counts(packed: torch.Tensor) -> torch.Tensor:
    """(G, R, ncoef) scan-packed levels -> (G, K) int64: the frozen
    `rate.adaptive_counts` of each group's R rows."""
    a = packed.to(torch.int32).abs()
    sig = a > 0
    ncoef = packed.shape[-1]
    dev = packed.device
    coded = sig.any(dim=-1)
    lastidx, klen, max_len = rate._last_info(sig, ncoef)
    full = coded & (lastidx == ncoef - 1)
    nf = (coded & ~full)[..., None]
    idx = torch.arange(max_len, device=dev)
    emitted = coded[..., None] & (
        torch.arange(ncoef, device=dev) < lastidx[..., None])
    pos = torch.arange(ncoef, device=dev).clamp(max=31)

    def by_context(per_position):
        return torch.zeros((packed.shape[0], 32), dtype=torch.int64,
                           device=dev).index_add_(1, pos, per_position)

    return torch.cat([
        torch.stack([torch.ones_like(coded).sum(1), coded.sum(1),
                     full.sum(1)], 1),
        (nf & (klen[..., None] > idx)).sum(1),
        (nf & (klen[..., None] >= idx)).sum(1),
        by_context((sig & emitted).sum(1)), by_context(emitted.sum(1)),
        torch.stack([sig.sum((1, 2)), (a > 1).sum((1, 2)),
                     (a > 2).sum((1, 2))], 1),
    ], 1)


_SCALARS = ("cbf1", "cbf0", "lf1", "lf0", "g11", "g10", "g21", "g20")


def group_prices(counts: torch.Tensor, ncoef: int) -> dict:
    """(G, K) counts -> each group's float32 prices, as the frozen
    `rate.adaptive_prices` computes them (host numpy, elementwise):
    vectors (G, L) and scalars (G, 1), tensors on the counts' device."""
    c = counts.cpu().numpy().astype(np.float32)
    g = c.shape[0]
    m = rate._max_len(ncoef)
    col = lambda k: c[:, k:k + 1]  # noqa: E731
    n1 = np.concatenate([col(1), col(2), c[:, 3:3 + m],
                         c[:, 3 + 2 * m:35 + 2 * m], col(68 + 2 * m),
                         col(69 + 2 * m)], 1)
    n = np.concatenate([col(0), col(1), c[:, 3 + m:3 + 2 * m],
                        c[:, 35 + 2 * m:67 + 2 * m], col(67 + 2 * m),
                        col(68 + 2 * m)], 1)
    p1, p0 = rate._prices(n1.astype(np.float32), n.astype(np.float32))
    cum1 = np.zeros((g, m + 1), np.float32)
    for i in range(m):
        cum1[:, i + 1] = cum1[:, i] + p1[:, 2 + i]
    arrays = {"sig1": p1[:, 2 + m:34 + m], "sig0": p0[:, 2 + m:34 + m],
              "cum1": cum1,
              "lp0": np.concatenate([p0[:, 2:2 + m],
                                     np.zeros((g, 1), np.float32)], 1)}
    scalars = (p1[:, 0], p0[:, 0], p1[:, 1], p0[:, 1], p1[:, -2], p0[:, -2],
               p1[:, -1], p0[:, -1])
    arrays.update({k: v[:, None] for k, v in zip(_SCALARS, scalars)})
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
        counts.device) for k, v in arrays.items()}


def group_bits(packed: torch.Tensor, p: dict) -> torch.Tensor:
    """(G, R, ncoef) scan-packed levels -> (G, R) float32 bits at each
    group's prices, the frozen `rate.adaptive_bits` term by term."""
    a = packed.to(torch.int32).abs()
    sig = a > 0
    ncoef = packed.shape[-1]
    dev = packed.device
    pos = torch.arange(ncoef, device=dev).clamp(max=31)
    coded = sig.any(dim=-1)
    lastidx, klen, max_len = rate._last_info(sig, ncoef)
    full = coded & (lastidx == ncoef - 1)
    prefix = torch.gather(p["cum1"], 1, klen) + torch.where(
        klen < max_len, torch.gather(p["lp0"], 1, klen), 0.0)
    last_cost = torch.where(full, p["lf1"],
                            p["lf0"] + prefix + klen.to(torch.float32))
    emitted = coded[..., None] & (
        torch.arange(ncoef, device=dev) < lastidx[..., None])
    cost_sig = torch.where(emitted,
                           torch.where(sig, p["sig1"][:, pos][:, None],
                                       p["sig0"][:, pos][:, None]),
                           0.0)
    s = {k: p[k][..., None] for k in ("g11", "g10", "g21", "g20")}
    per = cost_sig + torch.where(
        sig,
        torch.where(a > 1,
                    s["g11"] + torch.where(a > 2, s["g21"] + rate.eg0_bits(a),
                                           s["g20"]),
                    s["g10"]) + 1.0,
        0.0)
    return torch.where(coded, p["cbf1"] + last_cost + rate.ordered_sum(per),
                       p["cbf0"])


# --- the RD decision ----------------------------------------------------------

def _clip(x: torch.Tensor, bit_depth: int) -> torch.Tensor:
    return x.clamp(0, (1 << bit_depth) - 1)


def _weigh(dist: torch.Tensor, lam: float, bits: torch.Tensor,
           cost_dtype: torch.dtype) -> torch.Tensor:
    """dist + lam * bits, in float32 as the configuration states, or in
    the control's lower precision."""
    if cost_dtype == torch.float32:
        return dist + lam * bits
    return (dist.to(cost_dtype) + lam * bits.to(cost_dtype)).to(torch.float32)


def _rd_parts(blocks, preds, n, qp, use_dst, bit_depth, dequant_rescale):
    """Each candidate's SSE (float32) and diag-packed levels through the
    transform, quantization and reconstruction chain, candidate-major
    within a block (the frozen `all_intra._rd_parts`)."""
    nb, m = preds.shape[:2]
    flat_pred = preds.reshape(nb * m, n, n)
    blk = blocks[:, None].expand(preds.shape).reshape(nb * m, n, n)
    levels = ops.quantize(ops.forward_transform(blk - flat_pred, use_dst),
                          qp, n, True)
    rec_res = ops.inverse_transform(
        ops.dequantize(levels, qp, n, rescale=dequant_rescale), use_dst)
    recon = _clip(flat_pred + rec_res, bit_depth)
    diff = (blk - recon).to(torch.int64)
    sse = (diff * diff).sum(dim=(1, 2)).to(torch.float32)
    return sse, ops.scan_pack(levels, "diag")


def _rd_costs(blocks, preds, n, qp, use_dst, bit_depth, dequant_rescale,
              groups, cost_dtype):
    """(nb, M) costs of M candidates a block, each group of nb / groups
    consecutive blocks priced from its own counts."""
    nb, m = preds.shape[:2]
    sse, packed = _rd_parts(blocks, preds, n, qp, use_dst, bit_depth,
                            dequant_rescale)
    packed = packed.reshape(groups, -1, packed.shape[-1])
    bits = group_bits(packed, group_prices(group_counts(packed),
                                           packed.shape[-1]))
    lam = float(_rd_lambda(qp, 1.0))
    return _weigh(sse, lam, bits.reshape(-1), cost_dtype).reshape(nb, m)


def _rd_angular_costs(blocks, refs_in, n, routed, qp, use_dst, bit_depth,
                      dequant_rescale, groups, cost_dtype):
    """(nb, 33) costs of the angular modes, in chunks of modes: every
    chunk's bins counted first, each group priced once."""
    nb = blocks.shape[0]
    ncoef = n * n
    step = max(1, _SEARCH_CHUNK_ELEMS // max(1, nb * n * n))
    chunks = [ops.ALL_ANGULAR[s:s + step]
              for s in range(0, len(ops.ALL_ANGULAR), step)]

    def parts(modes):
        preds = ops.angular_predict_modes(refs_in, n, modes, routed)
        sse, packed = _rd_parts(blocks, preds, n, qp, use_dst, bit_depth,
                                dequant_rescale)
        return sse, packed.reshape(groups, -1, ncoef)

    kept = None
    counts = 0
    for modes in chunks:
        kept = parts(modes)
        counts = counts + group_counts(kept[1])
    prices = group_prices(counts, ncoef)
    lam = float(_rd_lambda(qp, 1.0))
    costs = []
    for modes in chunks:
        sse, packed = kept if len(chunks) == 1 else parts(modes)
        bits = group_bits(packed, prices).reshape(-1)
        costs.append(_weigh(sse, lam, bits, cost_dtype).reshape(nb, len(modes)))
    return torch.cat(costs, dim=1)


def decide_rd(blocks, refs, n, mode_set, *, smoothing, bit_depth, qp,
              use_dst, dequant_rescale, mode_bits, groups, cost_dtype):
    """The RD decision of `mode_set` ("dc_planar" or "all") with the
    exact MPM bits of each block: (pred (nb, N, N), mode (nb,) int32)."""
    flags = ops.mode_filter_flags(n) if smoothing else None
    refs_f = ops.smooth_refs(refs, n, bit_depth) if smoothing and n > 4 else refs
    dc = ops.dc_predict(refs, n)
    pl = ops.planar_predict(
        refs_f if (flags is not None and flags[PLANAR_MODE]) else refs, n)
    both = _rd_costs(blocks, torch.stack([dc, pl], dim=1), n, qp, use_dst,
                     bit_depth, dequant_rescale, groups, cost_dtype)
    cost_dc, cost_pl = both[:, 0], both[:, 1]
    lam = float(_rd_lambda(qp, 1.0))
    if mode_set == "dc_planar":
        cost_dc = _weigh(cost_dc, lam, mode_bits[:, DC_MODE], cost_dtype)
        cost_pl = _weigh(cost_pl, lam, mode_bits[:, PLANAR_MODE], cost_dtype)
        dc_wins = cost_dc <= cost_pl
        pred = torch.where(dc_wins[:, None, None], dc, pl)
        return pred, torch.where(dc_wins, DC_MODE, PLANAR_MODE).to(torch.int32)
    routed = smoothing and n > 4
    refs_in = torch.cat([refs, refs_f], dim=1) if routed else refs
    costs = torch.cat([cost_pl[:, None], cost_dc[:, None],
                       _rd_angular_costs(blocks, refs_in, n, routed, qp,
                                         use_dst, bit_depth, dequant_rescale,
                                         groups, cost_dtype)], dim=1)
    costs = _weigh(costs, lam, mode_bits, cost_dtype)
    best_mode = costs.argmin(dim=1).to(torch.int32)      # ties -> lowest
    ang = _by_mode(refs_in, n, best_mode, routed)
    sel = best_mode[:, None, None]
    pred = torch.where(sel == PLANAR_MODE, pl,
                       torch.where(sel == DC_MODE, dc, ang))
    return pred, best_mode


def code_residual(blocks, pred, qp, n, *, use_dst, bit_depth,
                  dequant_rescale, rdoq, scan, modes):
    """The chosen blocks' tail: transform, deadzone quantization, RDOQ
    in the stream's scan order, dequantization, inverse transform, clip
    -> (levels (m, N, N) raster, recon (m, N, N))."""
    coeff = ops.forward_transform(blocks - pred, use_dst)
    levels = ops.quantize(coeff, qp, n)
    if rdoq:
        lam = rd_lambda_calibrated(qp, n, use_dst, dequant_rescale, 1.0)
        gain = ops.rdoq_gain(n, use_dst, coeff.device).expand(coeff.shape)
        packed = ops.rdoq_levels(
            ops.scan_pack(coeff, scan, modes=modes),
            ops.scan_pack(levels, scan, modes=modes),
            ops.scan_pack(gain, scan, modes=modes),
            qp, n, lam, dequant_rescale=dequant_rescale)
        levels = ops.scan_unpack(packed, scan, modes=modes)
    res = ops.inverse_transform(
        ops.dequantize(levels, qp, n, rescale=dequant_rescale), use_dst)
    return levels, _clip(pred + res, bit_depth)


# --- the skewed wavefront over a batch of planes ------------------------------

def _skew_tables(nby: int, nbx: int) -> tuple:
    ndiag = nby + nbx - 1
    bx = np.arange(ndiag)[:, None] - np.arange(nby)[None, :]
    return bx, (bx >= 0) & (bx < nbx)


def _skew_blocks(raster: torch.Tensor, nby: int, nbx: int) -> torch.Tensor:
    """Raster (P, nby*nbx, ...) -> skewed (P, ndiag, nby, ...):
    skewed[d, by] = raster[by, d - by] where valid."""
    b = raster.shape[0]
    rest = tuple(raster.shape[2:])
    ndiag = nby + nbx - 1
    x = raster.reshape(b, nby, nbx, *rest)
    pad = x.new_zeros((b, nby, ndiag + 1 - nbx, *rest))
    x = torch.cat([x, pad], dim=2).reshape(b, nby * (ndiag + 1), *rest)
    return x[:, :nby * ndiag].reshape(b, nby, ndiag, *rest).transpose(1, 2)


def _deskew_blocks(skewed: torch.Tensor, nby: int, nbx: int) -> torch.Tensor:
    b, ndiag = skewed.shape[:2]
    rest = tuple(skewed.shape[3:])
    x = skewed.transpose(1, 2).reshape(b, nby * ndiag, *rest)
    x = torch.cat([x, x.new_zeros((b, nby, *rest))], dim=1)
    return x.reshape(b, nby, ndiag + 1, *rest)[:, :, :nbx].reshape(
        b, nby * nbx, *rest)


def _read_refs(s_bot, r_sp, d, n, nby, boundary, bx):
    """(P, nby, 4N+2) references of diagonal d's slots from the skewed
    bottom-row and right-column buffers."""
    top_rows = s_bot[:, :, d * n:d * n + 2 * n + 1]
    top = torch.cat([torch.full_like(top_rows[:, :1], boundary),
                     top_rows[:, :-1]], dim=1)
    left = r_sp[:, d:d + nby, d * n:d * n + 2 * n + 1].flip(1)
    left = torch.where((bx == 0)[:, None], boundary, left)
    by = torch.arange(nby, device=bx.device)
    edge = ((by == 0) | (bx == 0))[:, None]
    top = torch.cat([torch.where(edge, boundary, top[..., :1]),
                     top[..., 1:]], dim=-1)
    left = torch.cat([torch.where(edge, boundary, left[..., :1]),
                      left[..., 1:]], dim=-1)
    return torch.cat([top, left], dim=-1)


def _write_bufs(s_bot, r_sp, rec, d, ok, bx, n, nby, nbx):
    """Diagonal d's bottom rows and right columns into the buffers, the
    N-wide tail replicating the last pixel at the plane's last block
    column (row); invalid slots keep the old contents."""
    c0 = d * n + n + 1
    okc = ok[:, None]
    last_pix = rec[:, :, n - 1, n - 1:n]
    old_b = s_bot[:, :, c0:c0 + 2 * n]
    head = torch.where(okc, rec[:, :, n - 1, :], old_b[..., :n])
    tail = torch.where(okc & (bx == nbx - 1)[:, None], last_pix,
                       old_b[..., n:])
    s_bot[:, :, c0:c0 + 2 * n] = torch.cat([head, tail], dim=-1)
    old_r = r_sp[:, d + 1:d + 1 + nby, c0:c0 + 2 * n].flip(1)
    by = torch.arange(nby, device=rec.device)
    head = torch.where(okc, rec[:, :, :, n - 1], old_r[..., :n])
    tail = torch.where(okc & (by == nby - 1)[:, None], last_pix,
                       old_r[..., n:])
    r_sp[:, d + 1:d + 1 + nby, c0:c0 + 2 * n] = torch.cat(
        [head, tail], dim=-1).flip(1)


def encode_planes_rd(planes: torch.Tensor, qp: int, n: int, *, mode_set: str,
                     use_dst: bool, bit_depth: int, scan: str,
                     dequant_rescale: bool, intra_smoothing: bool, rdoq: bool,
                     cost_dtype: torch.dtype = torch.float32) -> dict:
    """The closed loop under decision="rd" of (P, Hp, Wp) block-aligned
    planes, all P at once -> {"recon" (P, Hp, Wp), "levels" (P, nb, N,
    N) raster, "modes" (P, nb)}."""
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
    slot = torch.arange(nby, device=dev)
    ones = torch.ones((b, 1), dtype=torch.int32, device=dev)
    prev = ones.expand(b, nby)
    steps = []
    for d in range(ndiag):
        refs = _read_refs(s_bot, r_sp, d, n, nby, boundary, bx_t[d])
        left = torch.where(slot == d, 1, prev)
        above = torch.cat([ones, prev[:, :-1]], dim=1)
        mode_bits = mpm_mode_bits(left.reshape(-1), above.reshape(-1))
        blk = blocks_sk[:, d].reshape(b * nby, n, n)
        pred, mode = decide_rd(
            blk, refs.reshape(b * nby, 4 * n + 2), n, mode_set,
            smoothing=intra_smoothing, bit_depth=bit_depth, qp=qp,
            use_dst=use_dst, dequant_rescale=dequant_rescale,
            mode_bits=mode_bits, groups=b, cost_dtype=cost_dtype)
        levels, rec = code_residual(
            blk, pred, qp, n, use_dst=use_dst, bit_depth=bit_depth,
            dequant_rescale=dequant_rescale, rdoq=rdoq, scan=scan,
            modes=mode)
        rec = rec.reshape(b, nby, n, n)
        _write_bufs(s_bot, r_sp, rec, d, ok_t[d], bx_t[d], n, nby, nbx)
        prev = mode.reshape(b, nby)
        steps.append((rec, levels.reshape(b, nby, n, n), prev))
    rec, levels, modes = (_deskew_blocks(torch.stack(x, dim=1), nby, nbx)
                          for x in zip(*steps))
    recon = rec.reshape(b, nby, nbx, n, n).permute(0, 1, 3, 2, 4).reshape(
        b, hp, wp)
    return {"recon": recon, "levels": levels, "modes": modes}


def pad_to_blocks(planes: torch.Tensor, n: int) -> torch.Tensor:
    """(P, H, W) -> (P, Hp, Wp), block multiples, by edge replication."""
    b, h, w = planes.shape
    hp, wp = -(-h // n) * n, -(-w // n) * n
    if hp != h:
        planes = torch.cat(
            [planes, planes[:, h - 1:h, :].expand(b, hp - h, w)], dim=1)
    if wp != w:
        planes = torch.cat(
            [planes, planes[:, :, w - 1:w].expand(b, hp, wp - w)], dim=2)
    return planes.contiguous()


# --- frames -------------------------------------------------------------------

def plane_args(cfg: dict, is_luma: bool) -> dict:
    """Per-plane settings of an encoder configuration (the keys of
    `EncoderConfig`): chroma at half the block size (at least 4) with
    the chroma mode set, DST at 4x4 luma, smoothing on luma only."""
    n = cfg["block_size"] if is_luma else max(4, cfg["block_size"] // 2)
    mode_set = cfg["mode_set"] if is_luma else (
        cfg.get("chroma_mode_set") or cfg["mode_set"])
    return dict(n=n, mode_set=mode_set, use_dst=is_luma and n == 4,
                intra_smoothing=bool(cfg["intra_smoothing"]) and is_luma,
                deblock_chroma=not is_luma)


def check_config(cfg: dict) -> None:
    """The reference covers the closed loop's RD decision with CTB SAO,
    deblocking and the CABAC container; it refuses anything else."""
    want = dict(decision="rd", sao=False, sao_ctb=True, deblock=True,
                entropy_coder="cabac", is_intra=True)
    bad = {k: cfg.get(k) for k, v in want.items() if cfg.get(k, v) != v}
    if bad or cfg["mode_set"] not in ("dc_planar", "all"):
        raise ValueError(f"the plain reference does not cover {bad or cfg}")


def encode_planes(planes: torch.Tensor, cfg: dict, is_luma: bool,
                  cost_dtype: torch.dtype = torch.float32) -> dict:
    """(P, H, W) planes of one kind (luma or chroma) -> {"recon" (P, H,
    W), "levels" (P, nb, N*N) scan-packed, "modes" (P, nb), "sao_ctb"
    (type (P, nty, ntx), band, offsets (P, nty, ntx, 4))}."""
    check_config(cfg)
    a = plane_args(cfg, is_luma)
    n, qp, bd = a["n"], int(cfg["qp"]), int(cfg["bit_depth"])
    b, h, w = planes.shape
    src = pad_to_blocks(planes.to(torch.int32), n)
    out = encode_planes_rd(
        src, qp, n, mode_set=a["mode_set"], use_dst=a["use_dst"],
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
                  cost_dtype: torch.dtype = torch.float32) -> list:
    """Frames as (y, u, v) integer arrays -> one dict a frame, in the
    shapes `encode_frame_closed_loop` hands its bitstream writer:
    "recon" {plane: int16 array}, "levels" {plane: (int32 (nb, N*N),
    N)}, "modes" {plane: int32 (nb,)}, "sao_ctb" {plane: (tile, type,
    band, offsets)}.  Luma of every frame is coded in one batch, U and V
    of every frame in another."""
    k = len(frames)
    luma = torch.from_numpy(np.stack([f[0] for f in frames]).astype(
        np.int32)).to(device)
    chroma = torch.from_numpy(np.stack(
        [f[1] for f in frames] + [f[2] for f in frames]).astype(
            np.int32)).to(device)
    parts = {"Y": (encode_planes(luma, cfg, True, cost_dtype), range(k))}
    del luma
    both = encode_planes(chroma, cfg, False, cost_dtype)
    parts["U"] = (both, range(k))
    parts["V"] = (both, range(k, 2 * k))
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
