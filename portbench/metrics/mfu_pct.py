"""The whole request's share of the chip's bf16 peak, %: the model FLOPs
that the requests completed in the measured window (untraced) need, over
(the time from the window's start to the last completion x 989 TFLOP/s),
the span that ``mp_out_per_s`` divides by.
The FLOPs count RRDBNet once over each input pixel (no halo or padding),
SegFormer-b0 at its 512-px input, and with the diffusion branch the text
encoder (two prompts), two UNet passes a step and the VAE decode."""

from portbench.peaks import PEAK_BF16_FLOPS

_cache: dict = {}


def request_flops(ctx, h, w):
    key = (h, w)
    if key in _cache:
        return _cache[key]
    rr, mf = ctx.count("rrdbnet"), ctx.count("model_flops")
    cfg, wts = ctx.config, ctx.weights
    flops = 2.0 * rr.macs_per_input_pixel(cfg["esrgan"]) * h * w
    if "segformer" in wts:
        flops += mf.segformer_flops(wts["segformer"], cfg["segformer"], 512)
    d = cfg.get("diffusion")
    if d is not None and "unet" in wts:
        flops += mf.clip_flops(wts["text_encoder"], d["text_encoder"], 2)
        flops += 2 * int(d["steps"]) * mf.unet_pass_flops(
            wts["unet"], d["unet"], h, w)
        flops += mf.vae_decode_flops(wts["vae"], d["vae"], h, w)
    _cache[key] = flops
    return flops


def read(ctx):
    done = ctx.window.done
    if not done:
        return None
    total = sum(request_flops(ctx, r["h"], r["w"]) for r in done)
    span = done[-1]["t_end"] - ctx.window.t0
    return 100.0 * total / (span * PEAK_BF16_FLOPS)
