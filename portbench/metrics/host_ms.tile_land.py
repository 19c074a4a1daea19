"""ms a request that the streamed final's fetch threads spent landing
chunks in the host canvas: the StageTimer's ``tiling/land`` total (host
clock, on the fetch threads, after each chunk's copy has run) over the
measured window's requests (untraced)."""


def read(ctx):
    total = ctx.stages.get("tiling/land", (0.0, 0))[0]
    return ctx.per_request_ms(total) if total > 0 else None
