# Frozen copy of nanohevc_tpu_torch/ops/rate.py for the benchmark's plain reference
# (only the import lines differ); later changes to the port do not reach it.
"""Rate models of the residual syntax, port of `nanohevc_tpu/ops/rate.py`.

Two models price the bits of a block's scan-packed levels, as the JAX
package defines them:

- `model_bits`: static contexts, bins priced from a calibrated
  `RateTable` (`ops/rate_tables.py`, one per coefficient count);
- `model_bits_adaptive`: every context's bin probability counted over
  the batch it is given, prices scaled to the adaptive coder's code
  length (`_ctx_total`).  Which rows form the batch is part of the
  result; `adaptive_counts` (integer counts, additive over sub-batches),
  `adaptive_prices` and `adaptive_bits` let a caller count a batch in
  pieces and price it once.

The arithmetic is float32, as in JAX, and gives the same bits on the
CPU and on a CUDA card:

- elementwise operations follow the JAX expressions one by one (a
  Python constant there is a weak-typed float32, so it is rounded to
  float32 here too), and none is fused into a multiply-add;
- sums and prefix sums along the coefficient axis take XLA's CPU order
  (`ordered_sum`, `ordered_cumsum`) from elementwise adds;
- the per-context prices are computed on the host in numpy float32,
  each transcendental in float64 and rounded once: they may differ from
  XLA's float32 `log2`/`log`/`pow` in the last place;
- the EG0 term's floor(log2) of an integer reproduces XLA's value
  (`eg0_floor_log2`), four deviations from the true floor included.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch


# float32 bit patterns of JAX's exp2((qp - 12) / 3) at QP 0..51 (XLA's
# float32 exp2, which is not the correctly rounded value at every QP:
# at QP 51 it is 2^13 plus 4 ulps).
_RD_EXP2_BITS = np.array([
    0x3d800000, 0x3da14518, 0x3dcb2ff5, 0x3e000000, 0x3e214518, 0x3e4b2ff5,
    0x3e800000, 0x3ea14518, 0x3ecb2ff5, 0x3f000000, 0x3f214518, 0x3f4b2ff5,
    0x3f800000, 0x3fa14518, 0x3fcb2ff5, 0x40000000, 0x40214518, 0x404b2ff5,
    0x40800000, 0x40a14518, 0x40cb2ff5, 0x41000000, 0x41214518, 0x414b2ff5,
    0x41800000, 0x41a14518, 0x41cb2ff5, 0x42000000, 0x42214518, 0x424b2ff5,
    0x42800000, 0x42a14518, 0x42cb2ff5, 0x43000000, 0x43214518, 0x434b2ff5,
    0x43800000, 0x43a14518, 0x43cb2ff5, 0x44000000, 0x44214518, 0x444b2ff5,
    0x44800000, 0x44a14518, 0x44cb2ff5, 0x45000000, 0x45214518, 0x454b2ffc,
    0x45800000, 0x45a14513, 0x45cb2ff6, 0x46000004,
], dtype=np.uint32).view(np.float32)


def _rd_lambda(qp: int, rd_lambda_scale: float) -> np.float32:
    """HEVC-style lambda(QP) = 0.57 * 2^((QP-12)/3), scaled, as JAX's
    float32 product gives it: float32(scale * 0.57) * exp2 from the
    table above (QP outside 0..51: exp2 in float64, rounded once).

    One definition for the mode decision, the cbf decision, the
    mode-rate term and CTB SAO's RD choice (`ops/sao_ctb.py`), so every
    RD mechanism prices bits alike.
    """
    qp = int(qp)
    e = (_RD_EXP2_BITS[qp] if 0 <= qp < len(_RD_EXP2_BITS)
         else np.float32(2.0 ** ((qp - 12) / 3)))
    return np.float32(np.float32(rd_lambda_scale * 0.57) * e)


@dataclass(frozen=True)
class RateTable:
    """Static-context bin costs, all in bits (floats).

    sig0/sig1: cost of sig_coeff_flag = 0/1 at scan context 0..31;
    cbf0/cbf1, gt1_*, gt2_*, lastfull_*: scalar bin costs;
    lastp0/lastp1: last-position truncated-unary prefix bins 0..10.
    """

    sig0: tuple
    sig1: tuple
    cbf0: float
    cbf1: float
    gt1_0: float
    gt1_1: float
    gt2_0: float
    gt2_1: float
    lastfull0: float = 1.0
    lastfull1: float = 1.0
    lastp0: tuple = (1.0,) * 11
    lastp1: tuple = (1.0,) * 11


def calibrate_rate_table(levels: np.ndarray) -> RateTable:
    """Measure empirical bin probabilities of the residual syntax.

    levels: (nb, ncoef) int32 scan-ordered training data.  Costs are
    -log2(p) with +1 Laplace smoothing (host numpy, as in JAX).
    """
    a = np.abs(levels.astype(np.int64))
    sig = a > 0
    nb, ncoef = a.shape
    coded = sig.any(axis=1)

    def cost(ones: float, total: float) -> tuple:
        p1 = (ones + 1.0) / (total + 2.0)
        return -np.log2(p1), -np.log2(1.0 - p1)

    cbf1_cost, cbf0_cost = cost(coded.sum(), nb)

    lastidx = ncoef - 1 - np.argmax(sig[:, ::-1], axis=1)
    full = coded & (lastidx == ncoef - 1)
    lf1, lf0 = cost(full.sum(), coded.sum())
    max_len = int(np.floor(np.log2(max(ncoef - 1, 2))))
    klen = np.zeros(nb, np.int64)
    for k in range(1, max_len + 1):
        klen += (lastidx + 1) >= (1 << k)
    nf = coded & ~full
    lastp0 = np.ones(11)
    lastp1 = np.ones(11)
    for i in range(max_len):
        total = (nf & (klen >= i)).sum()
        ones = (nf & (klen > i)).sum()
        l1, l0 = cost(ones, total)
        lastp1[i], lastp0[i] = l1, l0

    emitted = coded[:, None] & (np.arange(ncoef)[None, :] < lastidx[:, None])
    pos = np.minimum(np.arange(ncoef), 31)
    sig1 = np.zeros(32)
    sig0 = np.zeros(32)
    for c in range(32):
        cols = pos == c
        m = emitted[:, cols]
        total = m.sum()
        ones = (sig[:, cols] & m).sum()
        s1, s0 = cost(ones, total)
        sig1[c], sig0[c] = s1, s0

    sig_vals = a[sig]
    gt1 = sig_vals > 1
    g11, g10 = cost(gt1.sum(), sig_vals.size)
    gt2_vals = sig_vals[gt1]
    g21, g20 = cost((gt2_vals > 2).sum(), max(gt2_vals.size, 1))
    return RateTable(
        sig0=tuple(sig0), sig1=tuple(sig1),
        cbf0=float(cbf0_cost), cbf1=float(cbf1_cost),
        gt1_0=float(g10), gt1_1=float(g11),
        gt2_0=float(g20), gt2_1=float(g21),
        lastfull0=float(lf0), lastfull1=float(lf1),
        lastp0=tuple(lastp0), lastp1=tuple(lastp1),
    )


def default_table(ncoef: int) -> RateTable:
    """The committed calibrated table for a coefficient count (the
    largest one for a count without its own)."""
    from plainref.ops.rate_tables import DEFAULT_TABLES

    if ncoef in DEFAULT_TABLES:
        return DEFAULT_TABLES[ncoef]
    return DEFAULT_TABLES[max(DEFAULT_TABLES)]


# --- float32 helpers ----------------------------------------------------------

def f32(value) -> float:
    """`value` rounded to float32, as a Python float.

    A float32 tensor op with such a scalar runs in float32 on CPU and
    card alike (the scalar converts to float32 exactly), as JAX's
    weak-typed Python constants do; unlike a 0-d tensor it costs no
    copy to the card.
    """
    return float(np.float32(value))


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Float32 sum over the last axis in XLA's CPU order: runs of 32
    terms summed left to right, then the runs' sums left to right.

    That is JAX's `sum(axis=-1)` bit for bit at 32 terms or fewer and at
    multiples of 32 (every coefficient count here), and, being
    elementwise adds only, the same on any device.
    """
    n = x.shape[-1]
    runs = x.reshape(*x.shape[:-1], -1, 32) if n > 32 and n % 32 == 0 \
        else x.unsqueeze(-2)
    return _left_to_right(_left_to_right(runs))


def _left_to_right(x: torch.Tensor) -> torch.Tensor:
    """Float32 sum over the last axis, strictly left to right."""
    terms = x.unbind(-1)
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _scan_left_to_right(x: torch.Tensor) -> list:
    """Float32 inclusive prefix sums over the last axis, strictly left
    to right, as a list of the prefixes."""
    terms = x.unbind(-1)
    out = [terms[0]]
    for t in terms[1:]:
        out.append(out[-1] + t)
    return out


def ordered_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Float32 inclusive prefix sums over the last axis in XLA's CPU
    order: prefix i sums runs of 16 terms left to right, then the runs'
    sums left to right (JAX's `cumsum` bit for bit at 16 terms or fewer
    and at multiples of 16 up to prefix 288), from elementwise adds
    only."""
    n = x.shape[-1]
    if n <= 16 or n % 16:
        return torch.stack(_scan_left_to_right(x), -1)
    scan = torch.stack(_scan_left_to_right(x.reshape(*x.shape[:-1], n // 16,
                                                     16)), -1)  # (..., R, 16)
    carry = torch.stack(_scan_left_to_right(scan[..., :-1, 15]), -1)
    rest = carry[..., None] + scan[..., 1:, :]
    return torch.cat([scan[..., :1, :], rest], -2).reshape(x.shape)


# XLA's float32 floor(log2(k)) differs from the true floor at these
# integers k < 2^22: its log2 lands just below 13 and 15, and rounds up
# to 21 and 22.
_FLOOR_LOG2_LOW = (8192, 32768)
_FLOOR_LOG2_HIGH = (2097151, 4194303)


@lru_cache(maxsize=None)
def _deviations(device: torch.device) -> tuple:
    return tuple(torch.tensor(v, dtype=torch.int32, device=device)
                 for v in (_FLOOR_LOG2_LOW, _FLOOR_LOG2_HIGH))


def eg0_floor_log2(k: torch.Tensor) -> torch.Tensor:
    """floor(log2(float32(k))) of integers k >= 1 as JAX computes it,
    as float32: the exponent of k in float64 (exact up to 2^53) with
    XLA's deviations below 2^22.  Levels stay below 2^15 (the int32
    quantizer's bound), far inside that range."""
    low, high = _deviations(k.device)
    e = (k.to(torch.float64).view(torch.int64) >> 52) - 1023
    e = e - torch.isin(k, low).to(e.dtype) + torch.isin(k, high).to(e.dtype)
    return e.to(torch.float32)


def eg0_bits(a: torch.Tensor) -> torch.Tensor:
    """2 * floor(log2(max(|l| - 2, 1))) + 1: the EG0 remainder's bins
    of a level of magnitude a (used where a > 2), float32."""
    return 2.0 * eg0_floor_log2((a - 2).clamp(min=1)) + 1.0


def _max_len(ncoef: int) -> int:
    """The last position's prefix bound: floor(log2(ncoef - 1))."""
    return int(np.floor(np.log2(max(ncoef - 1, 2))))


def _last_info(sig: torch.Tensor, ncoef: int):
    """Per-row last significant index and its prefix bit length.

    Returns (lastidx (nb,), klen (nb,), max_len): lastidx is ncoef - 1
    where a row has no significant level (as JAX's argmax gives);
    klen = bit_length(lastidx + 1) - 1, bounded by max_len because the
    full-block case is escaped.
    """
    idx = torch.arange(ncoef, device=sig.device)
    last = torch.where(sig, idx, -1).amax(dim=-1)
    lastidx = torch.where(last < 0, ncoef - 1, last)
    x = lastidx + 1
    max_len = _max_len(ncoef)
    klen = torch.zeros_like(lastidx)
    for k in range(1, max_len + 1):
        klen = klen + (x >= (1 << k)).to(klen.dtype)
    return lastidx, klen, max_len


# --- the static model ---------------------------------------------------------

@lru_cache(maxsize=None)
def table_tensors(table: RateTable, ncoef: int, device: torch.device) -> dict:
    """A table's sig costs per scan position (ncoef,) and its
    last-position prefix sums, float32 on `device`, made once."""
    pos = np.minimum(np.arange(ncoef), 31)
    arrays = {"sig0": np.asarray(table.sig0)[pos],
              "sig1": np.asarray(table.sig1)[pos],
              "cum1": np.concatenate([[0.0], np.cumsum(table.lastp1)]),
              "lp0": np.asarray(table.lastp0)}
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in arrays.items()}


def model_bits(packed: torch.Tensor, table: RateTable | None = None
               ) -> torch.Tensor:
    """(nb, ncoef) scan-packed levels -> (nb,) float32 bits under a
    static `RateTable` (default: the calibrated table of ncoef)."""
    ncoef = packed.shape[-1]
    if table is None:
        table = default_table(ncoef)
    dev = packed.device
    t = table_tensors(table, ncoef, dev)
    a = packed.to(torch.int32).abs()
    sig = a > 0

    lastidx, klen, max_len = _last_info(sig, ncoef)
    full = lastidx == ncoef - 1
    prefix = t["cum1"][klen] + torch.where(klen < max_len, t["lp0"][klen], 0.0)
    last_cost = torch.where(
        full, f32(table.lastfull1),
        f32(table.lastfull0) + prefix + klen.to(torch.float32))

    emitted = torch.arange(ncoef, device=dev)[None, :] < lastidx[:, None]
    cost_sig = torch.where(emitted, torch.where(sig, t["sig1"], t["sig0"]), 0.0)
    per = cost_sig + torch.where(
        sig,
        torch.where(a > 1,
                    f32(table.gt1_1) + torch.where(
                        a > 2, f32(table.gt2_1) + eg0_bits(a),
                        f32(table.gt2_0)),
                    f32(table.gt1_0)) + 1.0,
        0.0)
    return torch.where(sig.any(dim=-1),
                       f32(table.cbf1) + last_cost + ordered_sum(per),
                       f32(table.cbf0))


# --- the adaptive model -------------------------------------------------------

# The coder's context estimator decays with gamma = 1 - 2^-5 per
# opposing bin (nanohevc_runtime.cpp Context::update, shift 5).
_GAMMA = 31.0 / 32.0
_LN2 = float(np.log(2.0))
_F = np.float32


def _rounded(fn, x: np.ndarray) -> np.ndarray:
    """A transcendental of float32 values taken in float64 and rounded
    once to float32."""
    return fn(np.asarray(x, np.float64)).astype(np.float32)


def _ctx_total(n1: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Approximate total adaptive-coder bits of contexts that saw n
    bins, n1 of them ones (float32 arrays): a convergence transient of
    t* = log_gamma(p_hat / 0.5) bins priced by the decay curve, then
    (n - t*) bins at the empirical entropy."""
    n1 = np.asarray(n1, np.float32)
    n = np.asarray(n, np.float32)
    n0 = n - n1
    p_hat = (n1 + _F(0.5)) / (n + _F(1.0))
    t_star = np.clip(
        _rounded(np.log, np.maximum(p_hat, _F(1e-6)) / _F(0.5))
        / _F(np.log(_GAMMA)), _F(0.0), n)
    trans = (_F(0.5) * (_F(1.0) - _rounded(lambda t: _GAMMA ** t, t_star))
             / _F(1.0 - _GAMMA)) / _F(_LN2)
    ent = -(np.where(n1 > 0, n1 * _rounded(np.log2, p_hat), _F(0.0))
            + np.where(n0 > 0, n0 * _rounded(np.log2, _F(1.0) - p_hat),
                       _F(0.0))) / np.maximum(n, _F(1.0))
    steady = np.maximum(n - t_star, _F(0.0)) * ent
    return np.where(n > 0, trans + steady, _F(0.0)).astype(np.float32)


def _prices(n1: np.ndarray, n: np.ndarray):
    """Per-bin costs (ones, zeros) of each context, scaled so that the
    context totals match `_ctx_total` (float32 arrays)."""
    n1 = np.asarray(n1, np.float32)
    n = np.asarray(n, np.float32)
    p1 = (n1 + _F(0.5)) / (n + _F(1.0))
    c1 = -_rounded(np.log2, p1)
    c0 = -_rounded(np.log2, _F(1.0) - p1)
    emp = n1 * c1 + (n - n1) * c0
    scale = np.where(emp > 0, _ctx_total(n1, n) / np.maximum(emp, _F(1e-9)),
                     _F(1.0)).astype(np.float32)
    return (c1 * scale).astype(np.float32), (c0 * scale).astype(np.float32)


def adaptive_counts(packed: torch.Tensor) -> torch.Tensor:
    """The adaptive model's bin counts of a batch, exact int64, on the
    batch's device; counts of several sub-batches add up to the counts
    of their union.  Layout: rows, coded rows, full rows, prefix ones
    and totals (max_len each), sig ones and totals (32 contexts each),
    significant, > 1 and > 2 levels."""
    a = packed.to(torch.int32).abs()
    sig = a > 0
    ncoef = packed.shape[-1]
    dev = packed.device
    coded = sig.any(dim=-1)
    lastidx, klen, max_len = _last_info(sig, ncoef)
    full = coded & (lastidx == ncoef - 1)
    nf = (coded & ~full)[:, None]
    idx = torch.arange(max_len, device=dev)
    emitted = coded[:, None] & (
        torch.arange(ncoef, device=dev)[None, :] < lastidx[:, None])
    pos = torch.arange(ncoef, device=dev).clamp(max=31)

    def by_context(per_position):
        return torch.zeros(32, dtype=torch.int64, device=dev).index_add_(
            0, pos, per_position)

    return torch.cat([
        torch.stack([torch.ones_like(coded).sum(), coded.sum(), full.sum()]),
        (nf & (klen[:, None] > idx)).sum(dim=0),
        (nf & (klen[:, None] >= idx)).sum(dim=0),
        by_context((sig & emitted).sum(dim=0)), by_context(emitted.sum(dim=0)),
        torch.stack([sig.sum(), (a > 1).sum(), (a > 2).sum()]),
    ])


_SCALAR_PRICES = ("cbf1", "cbf0", "lf1", "lf0", "g11", "g10", "g21", "g20")


def adaptive_prices(counts: torch.Tensor, ncoef: int) -> dict:
    """Float32 prices of every context from `adaptive_counts`, computed
    on the host (the same bits whatever device the batch lies on): the
    scalar prices as Python floats, the vectors as tensors on the
    counts' device (one copy up)."""
    c = counts.cpu().numpy().astype(np.float32)  # exact below 2^24, as in JAX
    m = _max_len(ncoef)
    nb, n_coded, n_full = c[0], c[1], c[2]
    one_i, tot_i = c[3:3 + m], c[3 + m:3 + 2 * m]
    ones, totals = c[3 + 2 * m:35 + 2 * m], c[35 + 2 * m:67 + 2 * m]
    n_sig, n_gt1, n_gt2 = c[67 + 2 * m:]
    n1 = np.concatenate([[n_coded, n_full], one_i, ones, [n_gt1, n_gt2]])
    n = np.concatenate([[nb, n_coded], tot_i, totals, [n_sig, n_gt1]])
    p1, p0 = _prices(n1.astype(np.float32), n.astype(np.float32))
    cum1 = np.zeros(m + 1, np.float32)            # a sequential float32 scan
    for i in range(m):
        cum1[i + 1] = cum1[i] + p1[2 + i]
    vectors = {"sig1": p1[2 + m:34 + m], "sig0": p0[2 + m:34 + m],
               "cum1": cum1, "lp0": np.append(p0[2:2 + m], np.float32(0))}
    flat = torch.from_numpy(np.concatenate(list(vectors.values())).astype(
        np.float32)).to(counts.device)
    out = dict(zip(vectors, torch.split(flat, [v.size for v in vectors.values()])))
    scalars = (p1[0], p0[0], p1[1], p0[1], p1[-2], p0[-2], p1[-1], p0[-1])
    out.update({k: float(v) for k, v in zip(_SCALAR_PRICES, scalars)})
    return out


def adaptive_bits(packed: torch.Tensor, prices: dict) -> torch.Tensor:
    """(nb, ncoef) scan-packed levels -> (nb,) float32 bits at the
    given `adaptive_prices`."""
    a = packed.to(torch.int32).abs()
    sig = a > 0
    ncoef = packed.shape[-1]
    dev = packed.device
    pos = torch.arange(ncoef, device=dev).clamp(max=31)
    coded = sig.any(dim=-1)
    lastidx, klen, max_len = _last_info(sig, ncoef)
    full = coded & (lastidx == ncoef - 1)
    p = prices
    prefix = p["cum1"][klen] + torch.where(klen < max_len, p["lp0"][klen], 0.0)
    last_cost = torch.where(full, p["lf1"],
                            p["lf0"] + prefix + klen.to(torch.float32))
    emitted = coded[:, None] & (
        torch.arange(ncoef, device=dev)[None, :] < lastidx[:, None])
    cost_sig = torch.where(emitted,
                           torch.where(sig, p["sig1"][pos], p["sig0"][pos]),
                           0.0)
    per = cost_sig + torch.where(
        sig,
        torch.where(a > 1,
                    p["g11"] + torch.where(a > 2, p["g21"] + eg0_bits(a),
                                           p["g20"]),
                    p["g10"]) + 1.0,
        0.0)
    return torch.where(coded, p["cbf1"] + last_cost + ordered_sum(per),
                       p["cbf0"])


def model_bits_adaptive(packed: torch.Tensor) -> torch.Tensor:
    """Per-batch adaptive rate model: (nb, ncoef) packed -> (nb,) bits,
    each context priced from this batch's own statistics."""
    prices = adaptive_prices(adaptive_counts(packed), packed.shape[-1])
    return adaptive_bits(packed, prices)
