"""Device time a video of the bottleneck epilogue kernel's launches
(`bn_epilogue_kernel`, the port's inference BatchNorm + residual add +
ReLU pass), read from the trace by name as `conv_pct.test` reads the
convolutions.  None where the program launches no such kernel."""

KERNEL = "bn_epilogue_kernel"


def read(run):
    if run.trace is None or not run.counters.get("videos"):
        return None
    events = run.trace.in_window("kernel", KERNEL)
    if not events:
        return None
    return sum(e[3] - e[2] for e in events) * 1e-6 / run.counters["videos"]
