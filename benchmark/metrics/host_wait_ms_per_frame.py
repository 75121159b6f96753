"""host_wait_ms_per_frame: the host's time blocked on the card a frame:
the program's `host_read.<site>` spans (every float(), bool() and .item()
of a device value on the frame step), summed over the steps traced with
its span recorder on (`benchmark/spans.py`), per step."""


def read(ctx):
    spans = ctx.get("spans")
    if not spans:
        return None
    ns = sum(s[2] - s[1] for s in spans if s[0].startswith("host_read."))
    return ns / 1e6 / ctx["span_steps"]
