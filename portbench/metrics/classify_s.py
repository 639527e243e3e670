"""Mean seconds of ``classify`` a decision with the categories' copy to the
host, the benchmark's span from the synchronised end of ``kmeans_full``."""

LAYER = "ops/scoring"


def read(ctx):
    return ctx.mean_span("classify_s")
