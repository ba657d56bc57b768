"""Frames a second from opening the SER file to the stacked image in host
memory: every frame of the window's sequences over the host-clock time
from the window's opening to the end of its last sequence."""


def read(run):
    return run.window.rate()
