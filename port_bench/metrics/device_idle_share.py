"""100 x (1 - the union of the device's activity intervals over the
traced window's host seconds)."""


def read(ctx):
    win = ctx["trace"]
    if win is None:
        return None
    return 100.0 * (1.0 - win.busy_s / win.window_s)
