"""Host kernel-launch records of the traced window over its view steps:
the trainer's launches a step (``train/trainer.py`` ``view_step``, with
the orientation block on fired steps)."""


def read(ctx):
    win = ctx["trace"]
    if win is None or not ctx["view_steps"]:
        return None
    return win.launches / ctx["view_steps"]
