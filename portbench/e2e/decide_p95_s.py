"""The 95th percentile of every decision's seconds from send to categories
on the host (``statistics.quantiles``, inclusive), each timed by the pair
of CUDA events around it (the host clock off the card)."""

import statistics


def read(window):
    times = [u.get("latency", u["done"] - u["send"]) for u in window.units]
    if len(times) < 2:
        return times[0] if times else None
    return statistics.quantiles(times, n=20, method="inclusive")[18]
