"""Frames registered and stacked a second, from frames resident on the
card to the stack on the host: every frame of the window's sequences over
the host-clock time from the window's opening to the end of its last
sequence."""


def read(run):
    return run.window.rate()
