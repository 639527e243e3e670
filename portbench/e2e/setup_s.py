"""Seconds of set-up: from the process's start to the window's (imports, the
kernels' build or load, the points, the warm-up)."""


def read(window):
    return window.setup_s
