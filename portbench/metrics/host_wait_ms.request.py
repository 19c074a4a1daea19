"""ms a request that the request's thread spent blocked in the StageTimer's
own device synchronizations (the stages' waits at their synced ends):
``sync`` over the measured window's requests (untraced)."""


def read(ctx):
    total = ctx.stages.get("sync", (0.0, 0))[0]
    return ctx.per_request_ms(total) if total > 0 else None
