"""Seconds from the start of the run's script to the window's first step:
imports, the scene, the state, the step, the kernels' builds and loads and
the warm-up epochs."""


def read(ctx):
    return ctx["setup_s"]
