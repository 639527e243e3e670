"""Share of the traced window in which no device activity ran."""

LAYER = "device"


def read(ctx):
    return ctx.idle_share()
