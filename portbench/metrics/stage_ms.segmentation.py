"""ms a request in SegFormer-b0 and the masked sharpening: the
StageTimer's ``segmentation`` total over the measured window's requests
(untraced; both ends synchronised)."""


def read(ctx):
    total = ctx.stages.get("segmentation", (0.0, 0))[0]
    return ctx.per_request_ms(total) if total > 0 else None
