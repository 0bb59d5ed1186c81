"""The layer pattern of a configuration's model section: which mixer and
which feed-forward each position of a superblock runs, and where a probe
site's events land. The rules are the port's (`ModelConfig.block_kind`
and `ffn_kind`, with its defaults), written here from the model section's
keys so that the harness imports nothing of the port to read them.

The port stacks `superblock` consecutive layers as one unit and loops
over `num_layers // superblock` of them; a probe row carries the index of
its superblock as its layer id."""
from __future__ import annotations


def superblock(m: dict) -> int:
    return m.get("superblock", 1)


def stacked(m: dict) -> int:
    """Superblocks in the stack: each position's leaves have this lead
    dim."""
    sb = superblock(m)
    if m["num_layers"] % sb:
        raise ValueError(f"num_layers {m['num_layers']} is not a multiple "
                         f"of superblock {sb}")
    return m["num_layers"] // sb


def block_kind(m: dict, j: int) -> str:
    """"attn" or "mamba" at superblock position j."""
    if m["family"] == "ssm":
        return "mamba"
    every = m.get("attn_every", 0)
    if m["family"] == "hybrid" and every:
        return "attn" if j % every == m.get("attn_offset", 4) else "mamba"
    return "attn"


def ffn_kind(m: dict, j: int) -> str:
    """"moe", "dense" or "none" at superblock position j."""
    if m["family"] == "ssm":
        return "none"
    if m.get("num_experts", 0) and \
            j % m.get("moe_every", 1) == m.get("moe_offset", 0):
        return "moe"
    return "dense"


# the layer kinds a probe site's count may name
KINDS = {
    "num_layers": lambda m, j: True,
    "attn_layers": lambda m, j: block_kind(m, j) == "attn",
    "mamba_layers": lambda m, j: block_kind(m, j) == "mamba",
    "moe_layers": lambda m, j: ffn_kind(m, j) == "moe",
}


def site_layout(config: dict, site: str) -> tuple[int, int]:
    """(ids, events at each) of the events a decode step collects at
    `site`, from the configuration's "probe_sites": a number n, or the
    name of another key of the model section, gives n events at ids
    0..n-1; "num_layers" or a layer kind of KINDS gives, at each
    superblock's id, one event for each position of that kind."""
    n = config["probe_sites"][site]
    m = config["model"]
    if n in KINDS:
        return stacked(m), sum(1 for j in range(superblock(m))
                               if KINDS[n](m, j))
    return (n if isinstance(n, int) else m[n]), 1
