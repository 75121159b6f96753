"""host_reads_per_frame: the device values the host waits to read a frame
(`aten::_local_scalar_dense`: every float(), bool() and .item() of a
device tensor), counted in the profiler's trace of the host's operators over the
`host_trace_steps` steps that follow the device trace."""


def read(ctx):
    if "host_reads" not in ctx:
        return None
    return ctx["host_reads"] / ctx["host_steps"]
