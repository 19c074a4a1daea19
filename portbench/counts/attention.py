"""K3's calls in the SD x4 request and their bound.

The UNet's self-attentions run on K3 (cross-attention over the 77-token
context does not): per pass, ``layers_per_block`` in each cross-attention
down block, ``layers_per_block + 1`` in each up block and one in the mid
block, at that level's tokens, with ``attention_head_dim`` heads (the SD
x4 config counts heads there). The VAE decoder's mid-block attention is
one more call: one head of the deepest width over the latent's pixels.
Bound: 4 S^2 d per head in FLOPs (two products), q, k, v read and o
written once in bf16."""

from __future__ import annotations

from portbench.peaks import bound_s


def unet_calls(ucfg: dict, h: int, w: int) -> list[tuple[int, int, int]]:
    """(heads, tokens, head dim) of each K3 call of one UNet pass on an
    (h, w) sample."""
    chans = ucfg["block_out_channels"]
    heads = ucfg["attention_head_dim"]
    heads = [heads] * len(chans) if isinstance(heads, int) else list(heads)
    L = ucfg["layers_per_block"]
    calls = []
    for lvl, btype in enumerate(ucfg["down_block_types"]):
        if btype == "CrossAttnDownBlock2D":
            s = (h >> lvl) * (w >> lvl)
            calls += [(heads[lvl], s, chans[lvl] // heads[lvl])] * L
    deep = len(chans) - 1
    s = (h >> deep) * (w >> deep)
    calls.append((heads[deep], s, chans[deep] // heads[deep]))
    for ui, btype in enumerate(ucfg["up_block_types"]):
        lvl = deep - ui
        if btype == "CrossAttnUpBlock2D":
            s = (h >> lvl) * (w >> lvl)
            calls += [(heads[lvl], s, chans[lvl] // heads[lvl])] * (L + 1)
    return calls


def vae_call(vcfg: dict, h: int, w: int) -> tuple[int, int, int]:
    return (1, h * w, vcfg["block_out_channels"][-1])


def call_bound_s(heads: int, s: int, d: int) -> float:
    return bound_s(4.0 * heads * s * s * d, 4 * 2.0 * heads * s * d)


def request_bound_s(ucfg: dict, vcfg: dict, h: int, w: int,
                    passes: int) -> tuple[float, int]:
    """(bound in seconds, number of K3 calls) of one request's K3 work:
    ``passes`` UNet passes and one VAE decode."""
    calls = unet_calls(ucfg, h, w)
    total = passes * sum(call_bound_s(*c) for c in calls)
    return total + call_bound_s(*vae_call(vcfg, h, w)), passes * len(calls) + 1
