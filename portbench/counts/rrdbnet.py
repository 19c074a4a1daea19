"""RRDBNet's work, from its widths: multiply-adds per pixel, and the
bound of the K1 step's bf16 RDB (a frozen copy of ``chip_smoke.py``'s
``rdb_bf16_bytes`` / ``rdb_bf16_bound`` arithmetic, in seconds).

Each input is read once and each output written once; the count is of
the work the inputs need, not of what a kernel happens to do."""

from __future__ import annotations

from portbench.peaks import bound_s


def rdb_macs_per_pixel(nf: int, g: int) -> int:
    """One RDB: five 3x3 convs, Cin nf + k g -> g (k < 4) or nf."""
    cins = [nf + k * g for k in range(5)]
    couts = [g, g, g, g, nf]
    return 9 * sum(c * o for c, o in zip(cins, couts))


def macs_per_input_pixel(cfg: dict) -> int:
    """The whole x4 network over one input pixel (no halo, no padding):
    conv_first and conv_body at 1x, the trunk's 3 x num_block RDBs, conv_up1
    at 2x (4 output pixels), conv_up2 and conv_hr at 4x (16), conv_last at
    4x."""
    nf, g, nb = cfg["num_feat"], cfg["num_grow_ch"], cfg["num_block"]
    cin = cfg["num_in_ch"] * {1: 16, 2: 4, 4: 1}[cfg["scale"]]
    s2 = cfg["scale"] ** 2
    head = 9 * (cin * nf + nf * nf)
    up = 9 * nf * nf * (4 + s2 + s2) + 9 * nf * cfg["num_out_ch"] * s2
    return head + 3 * nb * rdb_macs_per_pixel(nf, g) + up


def rdb_bf16_bound_s(pix: int, nf: int, g: int, skip: bool = False) -> float:
    """The bound of one bf16 RDB, the function the K1 step's five launches
    compute: its operations at the bf16 peak against x (and the RRDB skip)
    read once and out written once in bf16, with the weights (bf16) and
    biases (fp32)."""
    cins = [nf, g, g, g, g]
    couts = [4 * g + nf - k * g for k in range(5)]
    macs = sum(c * o for c, o in zip(cins, couts))
    params = 18.0 * macs + 4.0 * (4 * g + nf)
    return bound_s(2.0 * pix * 9 * macs, (2 + skip) * 2.0 * pix * nf + params)


def tile_chunks(h: int, w: int, tile: int, batch: int) -> list[int]:
    """Tiles a chunk of the overlap-halo tiler: the image padded to a
    multiple of ``tile``, cut into tiles, run ``batch`` at a time."""
    n = (-(-h // tile)) * (-(-w // tile))
    return [min(batch, n - s) for s in range(0, n, batch)]


def trunk_bound_s(tiles: int, side: int, cfg: dict) -> float:
    """The K1 step's bound for one forward over ``tiles`` tiles of side
    ``side`` (tile + 2 halo): 3 x num_block RDBs, the third of each RRDB
    with the residual folded in."""
    pix = tiles * side * side
    nf, g = cfg["num_feat"], cfg["num_grow_ch"]
    one = (2 * rdb_bf16_bound_s(pix, nf, g)
           + rdb_bf16_bound_s(pix, nf, g, skip=True))
    return cfg["num_block"] * one
