"""ms of the host's dispatch of one CFG step of the denoise loop (both
UNet passes, the guidance, the scheduler update): the StageTimer's
``diffusion/step`` span (host clock, never synchronised) over its count in
the measured window (untraced)."""


def read(ctx):
    total, n = ctx.stages.get("diffusion/step", (0.0, 0))
    return 1e3 * total / n if n else None
