"""Process start to the first timed request: imports, the kernel library,
the weights made on the device, warm-up (host clock)."""


def value(window):
    return window.setup_s
