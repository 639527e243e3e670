"""Mean seconds of ``kmeans_full`` a decision (the init and the Lloyd
loop), the benchmark's span around the call, synchronised in the traced
run."""

LAYER = "ops/kmeans"


def read(ctx):
    return ctx.mean_span("kmeans_s")
