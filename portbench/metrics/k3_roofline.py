"""K3's share of its roofline, %: the bound of the attention calls that
the UNet's attentions and the VAE's mid-block attention make at the
traced window's shapes (``counts/attention``), over the device time of
K3's kernels. Nothing when the trace holds another number of K3 launches
than those calls."""

PATTERNS = ("flash_narrow", "flash_wide")


def read(ctx):
    att = ctx.count("attention")
    d = ctx.config.get("diffusion")
    if d is None:
        return None
    bound, calls = 0.0, 0
    for r in ctx.traced:
        b, n = att.request_bound_s(d["unet"], d["vae"], r["h"], r["w"],
                                   2 * int(d["steps"]))
        bound, calls = bound + b, calls + n
    ks = ctx.trace.kernels(PATTERNS)
    if not ks or len(ks) != calls:
        return None
    return 100.0 * bound / ctx.trace.device_s(ks)
