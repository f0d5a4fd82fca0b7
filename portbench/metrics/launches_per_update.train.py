"""Kernel launches in the profiled updates over their number."""


def read(ctx):
    tw = ctx.get("trace")
    if ctx.get("kind") != "train" or tw is None or tw["idle"] is None or not ctx["profiled"]:
        return None
    return tw["launches"] / len(ctx["profiled"])
