"""Requests per dispatch over the server's ``max_batch``, from
``InferenceServer.stats()`` counters taken as differences over the window
(%)."""


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    s0, s1 = ctx["stats0"], ctx["stats1"]
    batches = s1["batches"] - s0["batches"]
    if batches <= 0:
        return None
    batched = s1["mean_batch_occupancy"] * s1["batches"] - s0["mean_batch_occupancy"] * s0["batches"]
    return 100.0 * batched / batches / ctx["traffic"]["max_batch"]
