"""The share of the profiled dispatches' window with no device event (busy is
the union of the device events' intervals) (%)."""


def read(ctx):
    tw = ctx.get("trace")
    if ctx.get("kind") != "serve" or tw is None or tw["idle"] is None:
        return None
    return 100.0 * tw["idle"]
