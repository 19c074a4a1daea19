"""ms a request in the pre-stages (NL-means denoise, CLAHE contrast):
the StageTimer's ``pre/denoise`` + ``pre/contrast`` totals over the
measured window's requests (untraced); both ends of each stage are
synchronised, so this is the stages' wall time with their device work."""


def read(ctx):
    total = sum(ctx.stages.get(k, (0.0, 0))[0]
                for k in ("pre/denoise", "pre/contrast"))
    return ctx.per_request_ms(total) if total > 0 else None
