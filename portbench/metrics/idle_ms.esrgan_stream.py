"""ms a request in which the compute stream sat idle inside the streamed
final, untraced: the StageTimer's ``esrgan+post/streamed`` stage on the
device's clock (``device/`` totals: timing events on the compute stream,
read after the request's last wait) less its ``tiling/grid`` and
``tiling/chunk`` spans, over the streamed stages of the measured window.
What is left is the stream waiting on the host inside the stage: the
copies' issue, the waits on a landing slot and on the last landings
(``tiling/drain``)."""

PARTS = ("device/tiling/grid", "device/tiling/chunk")


def read(ctx):
    seconds, n = ctx.stages.get("device/esrgan+post/streamed", (0.0, 0))
    if not n:
        return None
    work = sum(ctx.stages.get(k, (0.0, 0))[0] for k in PARTS)
    return 1e3 * (seconds - work) / n
