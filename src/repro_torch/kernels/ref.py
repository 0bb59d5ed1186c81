"""Plain PyTorch versions of every kernel in this package.

These define the semantics. The CUDA kernels must match them: exactly for
the integer kernels, within the stated tolerance for `tensor_stats` and
flash attention. They run on any device; on the CPU they are what `ops`
dispatches to.
"""
from __future__ import annotations

import math

import torch

from ..core import u64 as U

I64 = torch.int64
F32 = torch.float32
STAT_KEYS = ("mean", "rms", "min", "max", "absmax")
EVENT_WIDTH = 16

FX_SHIFT = 16
FX_ONE = 1 << FX_SHIFT
FX_MAX = (1 << 62) - 1


def to_fx(x):
    """f32 -> saturating Q47.16 fixed-point i64 (NaN -> 0). The clip comes
    before the cast: in f32 the bound rounds to 2**62, inside i64 range,
    whereas an out-of-range float->int cast is undefined. The row epilogue
    of `csrc/tensor_stats.cu` computes the same bits."""
    x = torch.as_tensor(x).to(F32)
    v = torch.where(torch.isnan(x), torch.zeros_like(x), x) * float(FX_ONE)
    v = v.clamp(-float(FX_MAX), float(FX_MAX))
    return v.to(I64)


# --------------------------------------------------------------------------
# tensor_stats: one-pass fused summary of an arbitrary tensor
# --------------------------------------------------------------------------

def tensor_stats(x) -> dict:
    """f32 scalars mean/rms/min/max/absmax over FINITE elements and i64
    nan/inf counts. Empty or all-non-finite tensors give zeros."""
    xf = x.to(F32).reshape(-1)
    if xf.numel() == 0:
        z = torch.zeros((), dtype=F32, device=x.device)
        zi = torch.zeros((), dtype=I64, device=x.device)
        return {**{k: z for k in STAT_KEYS}, "nan_cnt": zi, "inf_cnt": zi}
    nan = torch.isnan(xf)
    inf = torch.isinf(xf)
    bad = nan | inf
    n_ok = torch.clamp_min((~bad).sum().to(F32), 1.0)
    z = torch.where(bad, torch.zeros_like(xf), xf)
    s = z.sum()
    ss = (z * z).sum()
    mn = torch.where(bad, torch.full_like(xf, float("inf")), xf).min()
    mx = torch.where(bad, torch.full_like(xf, float("-inf")), xf).max()
    any_ok = (~bad).any()
    mn = torch.where(any_ok, mn, torch.zeros_like(mn))
    mx = torch.where(any_ok, mx, torch.zeros_like(mx))
    return {
        "mean": s / n_ok,
        "rms": torch.sqrt(ss / n_ok),
        "min": mn,
        "max": mx,
        "absmax": torch.maximum(mn.abs(), mx.abs()),
        "nan_cnt": nan.sum().to(I64),
        "inf_cnt": inf.sum().to(I64),
    }


def tensor_stats_row(x, site_id: int, kind: int, layer: int):
    """The collector's event row of `x`, i64[16]: site, kind, layer, 0
    (the step, filled in later), numel, the five stats in Q47.16, the NaN
    and Inf counts, four zeros (`core/events.py`'s row layout)."""
    st = tensor_stats(x)
    head = torch.tensor([site_id, kind, layer, 0, x.numel()], dtype=I64,
                        device=x.device)
    fx = to_fx(torch.stack([st[k] for k in STAT_KEYS]))
    cnt = torch.stack([st["nan_cnt"], st["inf_cnt"]])
    return torch.cat([head, fx, cnt,
                      torch.zeros(EVENT_WIDTH - 12, dtype=I64,
                                  device=x.device)])


def log2_histogram(x, n_bins: int = 64):
    """bcc-style log2 histogram of |x| in Q47.16 fixed point, i64[n_bins]:
    bin 0 for a zero fixed-point value, else min(n_bins - 1, the count of
    powers 2**k <= v for k < 63), i.e. v's bit length. The steps are the
    JAX package's: |x| in f32 with non-finite values as 0, the clip to
    [0, 2**62] in f32 before the cast. The count is a binary search over
    the 63 powers, so no [numel, 63] comparison is materialised."""
    v = torch.as_tensor(x).to(F32).reshape(-1).abs()
    v = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
    fx = (v * float(FX_ONE)).clamp(0.0, float(2**62)).to(I64)
    pow2 = torch.tensor([1 << k for k in range(63)], dtype=I64,
                        device=fx.device)
    count = torch.searchsorted(pow2, fx, right=True)
    bins = torch.where(fx <= 0, torch.zeros_like(count),
                       count.clamp(max=n_bins - 1))
    return torch.bincount(bins, minlength=n_bins)


# --------------------------------------------------------------------------
# hash_fetch_add_batch: sequential batched open-addressing fetch-add
# --------------------------------------------------------------------------

def hash_fetch_add_batch(keys_tbl, used_tbl, vals_tbl, keys, deltas, valid):
    """Apply fetch-add(key[i], delta[i]) for each valid event IN ORDER.
    Semantics identical to maps.t_hash_fetch_add applied sequentially.
    Returns new (keys, used, values); the inputs are not written."""
    n = keys_tbl.shape[0]
    kt, ut, vt = keys_tbl.clone(), used_tbl.clone(), vals_tbl.clone()
    ar = torch.arange(n, dtype=I64, device=kt.device)
    big = torch.full_like(ar, n)
    starts = U.hash_home(keys, n)
    one = torch.ones((), dtype=I64, device=kt.device)
    for b in range(keys.shape[0]):
        key, delta, ok = keys[b], deltas[b], valid[b]
        order = (starts[b] + ar) % n
        u_o = ut[order]
        occupied = u_o == 1           # tri-state used: 2 = tombstone
        match = occupied & (kt[order] == key)
        fm = torch.where(match, ar, big).min()
        ff = torch.where(~occupied, ar, big).min()
        fe = torch.where(u_o == 0, ar, big).min()
        found = (fm < n) & (fm < fe)
        has_free = ff < n
        tgt = torch.where(found, order[fm.clamp(0, n - 1)],
                          order[ff.clamp(0, n - 1)])
        do = ok & (found | has_free)
        newv = torch.where(found, vt[tgt] + delta, delta)
        kt[tgt] = torch.where(do, key, kt[tgt])
        ut[tgt] = torch.where(do, one, ut[tgt])
        vt[tgt] = torch.where(do, newv, vt[tgt])
    return kt, ut, vt


# --------------------------------------------------------------------------
# ringbuf_emit_batch: append valid rows at head, head advances per valid row
# --------------------------------------------------------------------------

def ringbuf_emit_batch(data, head, dropped, rows, valid):
    """data: i64[cap, W]; head, dropped: i64[1]; rows: i64[B, W]; valid:
    bool[B]. Returns new (data, head, dropped); the inputs are not
    written. Each valid row is one `maps.t_ringbuf_emit`: it lands at head
    % cap, and it laps (overwrites an unread record, dropped + 1) when the
    head is at or past cap."""
    cap = data.shape[0]
    d = data.clone()
    h = head.clone()
    dr = dropped.clone()
    for b in range(rows.shape[0]):
        ok = valid[b]
        slot = h[0] % cap
        d[slot] = torch.where(ok, rows[b], d[slot])
        dr = dr + (ok & (h[0] >= cap)).to(I64)
        h = h + ok.to(I64)
    return d, h, dr


# --------------------------------------------------------------------------
# flash attention: causal GQA attention in the kernel layout
# --------------------------------------------------------------------------

NEG = -1e30                   # the masked score of the Pallas kernels
FLASH_ROWS = 1024             # q rows per chunk: bounds the [BH, rows, Skv]
                              # score tensors


def _kv_per_q_head(t, rep):
    """[BKH, Skv, hd] -> f32 [BKH * rep, Skv, hd]: q head bh reads kv head
    bh // rep."""
    return t.to(F32).repeat_interleave(rep, dim=0)


def _scores(qc, ke, q0, causal, scale):
    """Scaled scores of q rows q0.. against every key, -1e30 where the
    causal mask hides the key."""
    s = torch.matmul(qc, ke.transpose(1, 2)) * scale
    if causal:
        qpos = q0 + torch.arange(qc.shape[1], device=qc.device)[:, None]
        kpos = torch.arange(ke.shape[1], device=qc.device)[None, :]
        s = torch.where(qpos >= kpos, s, NEG)
    return s


def flash_fwd(q, k, v, causal=True, rep=1, scale=0.0):
    """q [BH, Sq, hd]; k, v [BH // rep, Skv, hd]. Returns (o like q,
    lse f32 [BH, Sq]): the arithmetic of the Pallas forward body in f32,
    with the softmax of each row taken over all its keys at once. scale:
    the softmax's (0: 1/sqrt(hd))."""
    BH, Sq, hd = q.shape
    scale = scale or 1.0 / math.sqrt(hd)
    ke, ve = _kv_per_q_head(k, rep), _kv_per_q_head(v, rep)
    o = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=F32, device=q.device)
    for q0 in range(0, Sq, FLASH_ROWS):
        sl = slice(q0, min(q0 + FLASH_ROWS, Sq))
        s = _scores(q[:, sl].to(F32), ke, q0, causal, scale)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
        o[:, sl] = (torch.matmul(p, ve) / l).to(q.dtype)
        lse[:, sl] = (m + torch.log(l))[..., 0]
    return o, lse


def flash_bwd(q, k, v, o, lse, do, causal=True, rep=1, scale=0.0):
    """Gradients (dq, dk, dv) of the forward above for the output gradient
    `do`, in the inputs' types: p from `lse`, `delta = sum(do * o)` in f32
    over the stored o, dk and dv per q head summed over the rep group, as
    `flash_bwd` of the Pallas package does."""
    BH, Sq, hd = q.shape
    BKH, Skv, _ = k.shape
    scale = scale or 1.0 / math.sqrt(hd)
    delta = (do.to(F32) * o.to(F32)).sum(dim=-1)            # [BH, Sq]
    ke, ve = _kv_per_q_head(k, rep), _kv_per_q_head(v, rep)
    dq = torch.empty_like(q)
    dk_h = torch.zeros((BH, Skv, hd), dtype=F32, device=q.device)
    dv_h = torch.zeros_like(dk_h)
    for q0 in range(0, Sq, FLASH_ROWS):
        sl = slice(q0, min(q0 + FLASH_ROWS, Sq))
        qc, doc = q[:, sl].to(F32), do[:, sl].to(F32)
        s = _scores(qc, ke, q0, causal, scale)
        p = torch.exp(s - lse[:, sl, None])
        dv_h += torch.matmul(p.transpose(1, 2), doc)
        dp = torch.matmul(doc, ve.transpose(1, 2))
        ds = p * (dp - delta[:, sl, None]) * scale
        dk_h += torch.matmul(ds.transpose(1, 2), qc)
        dq[:, sl] = torch.matmul(ds, ke).to(q.dtype)
    dk = dk_h.to(k.dtype).reshape(BKH, rep, Skv, hd).sum(dim=1).to(k.dtype)
    dv = dv_h.to(v.dtype).reshape(BKH, rep, Skv, hd).sum(dim=1).to(v.dtype)
    return dq, dk, dv
