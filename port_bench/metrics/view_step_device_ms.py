"""Milliseconds in which the device was busy (the union of its activity
intervals in the trace) per view step, over the epochs a ``--trace 0``
run traces once its host window has closed: the device's cost of a view
step, into which the host's pace does not enter."""


def read(ctx):
    win = ctx.get("device_window")
    if win is None or not ctx.get("device_steps"):
        return None
    return 1e3 * win.busy_s / ctx["device_steps"]
