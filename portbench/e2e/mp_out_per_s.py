"""Output megapixels of every request completed in the window, over the
time from the window's start to the last completion (host clock)."""


def value(window):
    done = window.done
    if not done:
        return None
    mp = sum(r["out_w"] * r["out_h"] for r in done) / 1e6
    return mp / (done[-1]["t_end"] - window.t0)
