"""Rendered pixels of every view step completed in the window, over the
window's host seconds, in millions: the trainer's epoch-line rate taken
over the whole window."""


def read(ctx):
    if ctx["trace"] is not None:
        return None
    return ctx["view_steps"] * ctx["pixels_per_step"] / ctx["window_s"] / 1e6
