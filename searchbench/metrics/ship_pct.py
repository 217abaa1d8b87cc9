"""Planner: the blocks the fused chains shipped to the card (`wand_p1` +
`wand_p2`) over the blocks whose upper bound they computed
(`ub_blocks`), in percent, over the traced batches. The port's tracer
counts these `plan_stats` keys as `plan_stats.<key>`, each increment with
its time, and the reader sums those inside the batches' wall; nothing
where the program counts no `ub_blocks`."""

KEYS = ("ub_blocks", "wand_p1", "wand_p2")


def read(trace):
    from tantivy_tpu_torch.utils.trace import tracer

    counted = getattr(tracer, "counted", None)
    if counted is None:
        return None
    total = {key: sum(counted(f"plan_stats.{key}", b["t0"], b["t1"])
                      for b in trace["batches"]) for key in KEYS}
    if not total["ub_blocks"]:
        return None
    return (100.0 * (total["wand_p1"] + total["wand_p2"])
            / total["ub_blocks"])
