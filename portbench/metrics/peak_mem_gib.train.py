"""``torch.cuda.max_memory_allocated()`` over the window, after a reset at
its start (GiB)."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("on_card"):
        return None
    return ctx["window_peak_bytes"] / 2 ** 30
