"""The K1 step's share of its roofline, %: the bound of the bf16 RDBs
that the traced window's tile batches need (``counts/rrdbnet``), over the
device time of the step's kernels. Nothing when the trace holds another
number of step launches than the forwards need (345 a forward; a lost
kernel event would raise the share)."""

PATTERNS = ("rdb_bf16_step_kernel",)


def read(ctx):
    rr = ctx.count("rrdbnet")
    ecfg, pcfg = ctx.config["esrgan"], ctx.config["pipeline"]
    tile, halo = int(pcfg["max_tile_size"]), int(pcfg["tile_halo"])
    bound, launches = 0.0, 0
    for r in ctx.traced:
        for n in rr.tile_chunks(r["h"], r["w"], tile, int(pcfg["tile_batch"])):
            bound += rr.trunk_bound_s(n, tile + 2 * halo, ecfg)
            launches += 15 * ecfg["num_block"]
    ks = ctx.trace.kernels(PATTERNS)
    if not ks or len(ks) != launches:
        return None
    return 100.0 * bound / ctx.trace.device_s(ks)
