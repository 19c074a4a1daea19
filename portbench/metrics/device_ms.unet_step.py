"""ms of one CFG step of the denoise loop on the device's timeline: the
StageTimer's ``device/diffusion/step`` (timing events on the stream around
the step, read after the request's last wait) over its count in the
measured window (untraced). Well above ``host_ms.unet_step`` the device
paces the step. Close to it, the two cannot say who paces: a full launch
queue holds the host to the device's pace, and a host-paced step stretches
the device's events too; the device's busy time inside the step decides."""


def read(ctx):
    total, n = ctx.stages.get("device/diffusion/step", (0.0, 0))
    return 1e3 * total / n if n else None
