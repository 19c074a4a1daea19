"""ms a request in the StageTimer's ``diffusion`` stage. Under stage
overlap neither end is synchronised, so this is the host's dispatch of
the branch (its device work is waited for later); over the measured
window's requests, which the profiler does not slow."""


def read(ctx):
    total = ctx.stages.get("diffusion", (0.0, 0))[0]
    return ctx.per_request_ms(total) if total > 0 else None
