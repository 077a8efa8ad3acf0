"""Replay speed: every frame completed in the window over the window's wall
time (host clock; each frame ends in a synchronise)."""


def read(run):
    if not run.frame_s or run.window_s <= 0:
        return None
    return len(run.frame_s) / run.window_s
