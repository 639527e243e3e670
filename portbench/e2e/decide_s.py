"""Seconds a decision: the window's seconds over the decisions it completed."""


def read(window):
    return window.seconds / len(window.units)
