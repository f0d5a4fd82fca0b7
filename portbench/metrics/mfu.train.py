"""Model FLOP of the window's updates (portbench/flops.py, from the real
tokens' shapes) over the window's time and the H100's bf16 peak (%)."""

from portbench import flops


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("on_card"):
        return None
    return 100.0 * ctx["flops"] / ctx["window_s"] / flops.PEAK_BF16_FLOPS
