"""Lloyd iterations a second: every iteration the window's solves completed
over the window's seconds (from the first send to the last answer)."""


def read(window):
    return sum(u["iters"] for u in window.units) / window.seconds
