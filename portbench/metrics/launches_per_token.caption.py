"""Kernel launches in the profiled dispatches over the output tokens those
dispatches returned (the final EOS not counted)."""


def read(ctx):
    tw = ctx.get("trace")
    if ctx.get("kind") != "serve" or tw is None or tw["idle"] is None:
        return None
    tokens = sum(p["tokens"] for p in ctx["profiled"])
    return tw["launches"] / tokens if tokens else None
