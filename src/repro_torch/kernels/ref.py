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

def ringbuf_emit_batch(data, head, rows, valid):
    """data: i64[cap, W]; head: i64[1]; rows: i64[B, W]; valid: bool[B].
    Returns new (data, head); the inputs are not written."""
    cap = data.shape[0]
    d = data.clone()
    h = head.clone()
    for b in range(rows.shape[0]):
        ok = valid[b]
        slot = h[0] % cap
        d[slot] = torch.where(ok, rows[b], d[slot])
        h = h + ok.to(I64)
    return d, h


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


def flash_fwd(q, k, v, causal=True, rep=1):
    """q [BH, Sq, hd]; k, v [BH // rep, Skv, hd]. Returns (o like q,
    lse f32 [BH, Sq]): the arithmetic of the Pallas forward body in f32,
    with the softmax of each row taken over all its keys at once."""
    BH, Sq, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
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


def flash_bwd(q, k, v, o, lse, do, causal=True, rep=1):
    """Gradients (dq, dk, dv) of the forward above for the output gradient
    `do`, in the inputs' types: p from `lse`, `delta = sum(do * o)` in f32
    over the stored o, dk and dv per q head summed over the rep group, as
    `flash_bwd` of the Pallas package does."""
    BH, Sq, hd = q.shape
    BKH, Skv, _ = k.shape
    scale = 1.0 / math.sqrt(hd)
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
