"""Device ms a request of the kernels launched inside ``nesr/diffusion``
(text encoder, the 20-step CFG loop, the VAE decode), over the traced
window's requests."""


def read(ctx):
    if "nesr/diffusion" not in ctx.trace.ranges:
        return None
    ks = ctx.trace.kernels(stage="nesr/diffusion")
    return ctx.per_traced_ms(ctx.trace.device_s(ks)) if ks else None
