"""Serving driver: batched requests against the reduced (smoke) config of
an architecture with optional bpftime instrumentation, on the GPU by
default. Also holds the serving probe sets that the tests and the card
tests attach.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 8 --max-new 8 [--admit-limit 12] [--device cpu]

Every decoder family serves (dense, MoE, SSM, hybrid, and the VLM
text-only). The SSD prefill of mamba2 and jamba takes only prompts whose
length is a multiple of the smoke config's chunk (2), as the JAX launcher
does: with the default requests both stop on the third, a 3-token prompt.
The engine builds a prefill batch from tokens alone, so the
encoder-decoder family (seamless-m4t-medium) stops on its first prefill
with KeyError: 'enc_embeds', as the JAX launcher does; that family serves
through `registry.prefill_fn` with `enc_embeds` and `serve/steps.py`.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def admit_filter_text(limit: int) -> str:
    """The sys_serve_admit filter: reject prompts longer than `limit`."""
    return f"""
        ldxdw r6, [r1+ctx:arg1]
        jle r6, {limit}, ok
        mov r1, 429
        call override_return
        ok:
        mov r0, 0
        exit
    """


# The instrumentation the serving path is exercised with: per-layer ARRAY
# and HASH counters on block entry, a LOG2HIST of each block's output rms,
# and a RINGBUF record (step, numel, rms, absmax) of every logits tensor.
# Each entry: (name, asm text, (map name, kind, max_entries, rec_width),
# target).
_COUNT = """
    ldxdw r6, [r1+ctx:layer]
    stxdw [r10-8], r6
    lddw r1, map:{map}
    mov r2, r10
    add r2, -8
    mov r3, 1
    call map_fetch_add
    mov r0, 0
    exit
"""
_HIST_RMS = """
    ldxdw r2, [r1+ctx:rms]
    lddw r1, map:{map}
    call hist_add
    mov r0, 0
    exit
"""
_RB_LOGITS = """
    ldxdw r6, [r1+ctx:step]
    stxdw [r10-32], r6
    ldxdw r6, [r1+ctx:numel]
    stxdw [r10-24], r6
    ldxdw r6, [r1+ctx:rms]
    stxdw [r10-16], r6
    ldxdw r6, [r1+ctx:absmax]
    stxdw [r10-8], r6
    lddw r1, map:{map}
    mov r2, r10
    add r2, -32
    mov r3, 32
    mov r4, 0
    call ringbuf_output
    mov r0, 0
    exit
"""
SERVE_PROBES = [
    ("sv_count", _COUNT.format(map="sv_layer_counts"),
     ("sv_layer_counts", "array", 128, 4), "uprobe:block"),
    ("sv_hash", _COUNT.format(map="sv_key_hash"),
     ("sv_key_hash", "hash", 256, 4), "uprobe:block"),
    ("sv_hist", _HIST_RMS.format(map="sv_rms_hist"),
     ("sv_rms_hist", "log2hist", 64, 4), "uretprobe:block"),
    ("sv_rb", _RB_LOGITS.format(map="sv_logits_rb"),
     ("sv_logits_rb", "ringbuf", 64, 4), "probe:logits"),
]


# The router's health (examples/moe_balance.py): the moe.load site is the
# per-expert token count of one router call, so ctx:max is the busiest
# expert's load (a LOG2HIST of it shows imbalance); moe.drops is the count
# of assignments past capacity, ctx:mean of a one-element tensor, summed
# in an ARRAY slot.
_BALANCE = """
    ldxdw r2, [r1+ctx:max]
    lddw r1, map:load_hist
    call hist_add
    mov r0, 0
    exit
"""
_DROPS = """
    ldxdw r6, [r1+ctx:mean]
    mov r7, 0
    stxdw [r10-8], r7
    lddw r1, map:total_drops
    mov r2, r10
    add r2, -8
    arsh r6, 16
    mov r3, r6
    call map_fetch_add
    mov r0, 0
    exit
"""
MOE_PROBES = [
    ("moe_balance", _BALANCE, ("load_hist", "log2hist", 64, 4),
     "probe:moe.load"),
    ("moe_drops", _DROPS, ("total_drops", "array", 4, 4), "probe:moe.drops"),
]
# A LOG2HIST of each mamba mixer's output rms.
SSM_PROBES = [
    ("ssm_hist", _HIST_RMS.format(map="ssm_rms_hist"),
     ("ssm_rms_hist", "log2hist", 64, 4), "probe:ssm.out"),
]

# The encoder-decoder family's sites: an rms LOG2HIST of the frame
# embeddings (enc.in) and of each encoder layer's output (enc.block), a
# per-layer HASH counter of the encoder layers, all filled by a probed
# prefill; and a RINGBUF record of each decode step's logits
# (decode.logits). SERVE_PROBES' block and logits sites never fire here.
ENCDEC_PROBES = [
    ("ed_in_hist", _HIST_RMS.format(map="ed_in_rms_hist"),
     ("ed_in_rms_hist", "log2hist", 64, 4), "probe:enc.in"),
    ("ed_hist", _HIST_RMS.format(map="ed_rms_hist"),
     ("ed_rms_hist", "log2hist", 64, 4), "uretprobe:enc.block"),
    ("ed_hash", _COUNT.format(map="ed_layer_hash"),
     ("ed_layer_hash", "hash", 64, 4), "uretprobe:enc.block"),
    ("ed_rb", _RB_LOGITS.format(map="ed_logits_rb"),
     ("ed_logits_rb", "ringbuf", 64, 4), "probe:decode.logits"),
]


def family_probes(cfg) -> list:
    """ENCDEC_PROBES for the encoder-decoder family; otherwise
    SERVE_PROBES, plus MOE_PROBES where a layer routes to experts and
    SSM_PROBES where a layer is a mamba mixer."""
    if cfg.family == "encdec":
        return ENCDEC_PROBES
    layers = range(cfg.superblock)
    return (SERVE_PROBES
            + (MOE_PROBES if any(cfg.ffn_kind(j) == "moe" for j in layers)
               else [])
            + (SSM_PROBES if any(cfg.block_kind(j) == "mamba"
                                 for j in layers) else []))


# The live-lane programs the card tests hot-attach while serving, each on
# a map of its own and on integer fields only: a per-layer ARRAY counter
# (a vec slot), a RINGBUF record of each logits event (a sequential slot),
# a LOG2HIST of block sizes (a vec slot), and a per-layer HASH counter (the
# one that is promoted to the fused lane). LIVE_ARM are the sites a
# serving step collects for them before anything is attached.
_RB_LIVE = """
    ldxdw r6, [r1+ctx:step]
    stxdw [r10-32], r6
    ldxdw r6, [r1+ctx:numel]
    stxdw [r10-24], r6
    ldxdw r6, [r1+ctx:layer]
    stxdw [r10-16], r6
    ldxdw r6, [r1+ctx:kind]
    stxdw [r10-8], r6
    lddw r1, map:lv_logits_rb
    mov r2, r10
    add r2, -32
    mov r3, 32
    mov r4, 0
    call ringbuf_output
    mov r0, 0
    exit
"""
_HIST_NUMEL = """
    ldxdw r2, [r1+ctx:numel]
    lddw r1, map:lv_numel_hist
    call hist_add
    mov r0, 0
    exit
"""
LIVE_PROBES = [
    ("lv_count", _COUNT.format(map="lv_layer_counts"),
     ("lv_layer_counts", "array", 128, 4), "uprobe:block"),
    ("lv_rb", _RB_LIVE, ("lv_logits_rb", "ringbuf", 64, 4), "probe:logits"),
    ("lv_hist", _HIST_NUMEL, ("lv_numel_hist", "log2hist", 64, 4),
     "uretprobe:block"),
    ("lv_hash", _COUNT.format(map="lv_key_hash"),
     ("lv_key_hash", "hash", 256, 4), "uprobe:block"),
]
LIVE_ARM = ("uprobe:block", "uretprobe:block", "probe:logits")


def load_live_probes(rt) -> dict:
    """Create LIVE_PROBES' maps and load the programs into `rt` (attached
    nowhere); returns {name: pid}. Call before `enable_live_attach`, so the
    live table knows the maps."""
    from ..core.maps import MapKind, MapSpec
    pids = {}
    for name, text, (mname, kind, n, w), _ in LIVE_PROBES:
        spec = MapSpec(mname, MapKind(kind), n, rec_width=w)
        rt.create_map(spec)
        pids[name] = rt.load_asm(name, text, [spec], "uprobe")
    return pids


def attach_serve_probes(rt, probes=SERVE_PROBES):
    """Load `probes` (SERVE_PROBES by default) into `rt` and attach them on
    the fused lane; returns the links."""
    from ..core.maps import MapKind, MapSpec
    links = []
    for name, text, (mname, kind, n, w), target in probes:
        pid = rt.load_asm(name, text,
                          [MapSpec(mname, MapKind(kind), n, rec_width=w)],
                          "uprobe")
        links.append(rt.attach(pid, target, mode="fused"))
    return links


def make_requests(n: int, max_new: int, vocab_size: int, seed: int = 0):
    from ..serve.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab_size,
                                        int(rng.integers(3, 24))).tolist(),
                    max_new=max_new)
            for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--admit-limit", type=int, default=0,
                    help="reject prompts longer than this via eBPF filter")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs import registry
    from ..core.runtime import BpftimeRuntime
    from ..device import resolve
    from ..models import registry as MR
    from ..serve.engine import ServeEngine

    dev = resolve(args.device)
    rt = None
    if args.admit_limit:
        rt = BpftimeRuntime()
        pid = rt.load_asm("admit", admit_filter_text(args.admit_limit), [],
                          "filter")
        rt.attach(pid, "filter:sys_serve_admit")

    cfg = registry.smoke(args.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = MR.init_params(cfg, gen, dev)
    engine = ServeEngine(params, cfg, slots=args.slots,
                         max_seq=args.max_seq, runtime=rt, device=dev)
    reqs = make_requests(args.requests, args.max_new, cfg.vocab_size)
    engine.submit_all(reqs)
    done = sum(1 for r in reqs if r.done and not r.rejected)
    rej = sum(1 for r in reqs if r.rejected)
    print(f"served {done}, rejected {rej}, decode steps "
          f"{engine.step_count}")
    for r in reqs[:4]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out[:8]}"
              f"{' (rejected)' if r.rejected else ''}")


if __name__ == "__main__":
    main()
