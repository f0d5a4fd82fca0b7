"""The flash kernels' share of their roofline in the profiled updates: the
sum of the bound times of B3 (the forward, with its fp32 output copy) and
of the flash backward at each call's shape, over the sum of their kernel
times (%). The calls are the encoder's self-attention and the decoder's
cross-attention of every layer; where the trace holds another number of B3
launches the shapes are not known and nothing is read."""

from portbench import flops


def read(ctx):
    tw = ctx.get("trace")
    if ctx.get("kind") != "train" or tw is None or tw["idle"] is None:
        return None
    cfg = ctx["cfg"]
    H = cfg["encoder_attention_heads"]
    D = cfg["encoder_embed_dim"] // H
    bound, calls = 0.0, 0
    for u in ctx["profiled"]:
        B, Ts, Tt = u["batch"], u["src"], u["tgt"]
        for Tq, Tk, layers in ((Ts, Ts, cfg["encoder_layers"]), (Tt, Ts, cfg["decoder_layers"])):
            bound += layers * (flops.bound_s(*flops.flash_fwd_cost(B, Tq, Tk, H, D, H, out32=True))
                               + flops.bound_s(*flops.flash_bwd_cost(B, Tq, Tk, H, D, H)))
            calls += layers
    ops = [op for op in tw["ops"] if op["kind"] in ("B3", "flash-bwd")]
    if sum(op["kind"] == "B3" for op in ops) != calls:
        return None
    spent = sum(op["dur"] for op in ops) / 1e6
    return 100.0 * bound / spent if spent > 0 else None
