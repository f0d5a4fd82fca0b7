"""The flash forward's (B3) share of its roofline in the profiled
dispatches: the sum of its bound times at each encoder layer's shape (the
padded batch and source of the dispatch) over the sum of its kernel times
(%). Decode steps read a KV cache and take no attention kernel; where the
trace holds another number of B3 launches nothing is read."""

from portbench import flops


def read(ctx):
    tw = ctx.get("trace")
    if ctx.get("kind") != "serve" or tw is None or tw["idle"] is None:
        return None
    cfg = ctx["cfg"]
    H = cfg["encoder_attention_heads"]
    D = cfg["encoder_embed_dim"] // H
    L = cfg["encoder_layers"]
    bound = sum(L * flops.bound_s(*flops.flash_fwd_cost(p["batch"], p["src"], p["src"], H, D, H))
                for p in ctx["profiled"])
    ops = [op for op in tw["ops"] if op["kind"] == "B3"]
    if len(ops) != L * len(ctx["profiled"]):
        return None
    spent = sum(op["dur"] for op in ops) / 1e6
    return 100.0 * bound / spent if spent > 0 else None
