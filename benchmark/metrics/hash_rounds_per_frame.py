"""hash_rounds_per_frame: the hash map's probe and claim rounds a frame
(`core/hashmap.py`'s `find` and `activate` loops, each round past the
early-exit test): the program's counters `hash.probe_rounds` and
`hash.claim_rounds` over the steps traced with its span recorder on
(`benchmark/spans.py`)."""


def read(ctx):
    counts = ctx.get("span_counts", {})
    names = ("hash.probe_rounds", "hash.claim_rounds")
    if not any(k in counts for k in names):
        return None
    return sum(counts.get(k, 0) for k in names) / ctx["span_steps"]
