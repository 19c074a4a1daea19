"""Device ms a request of the kernels launched inside the pipeline's
ESRGAN stage: ``nesr/esrgan+post/streamed`` (the streamed final, ESRGAN
and the per-tile sharpening) or ``nesr/esrgan`` (the stage chain),
whichever the trace holds; over the traced window's requests."""

STAGES = ("nesr/esrgan+post/streamed", "nesr/esrgan")


def read(ctx):
    for stage in STAGES:
        if stage in ctx.trace.ranges:
            ks = ctx.trace.kernels(stage=stage)
            return ctx.per_traced_ms(ctx.trace.device_s(ks)) if ks else None
    return None
