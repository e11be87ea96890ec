"""device_idle (%, device trace): the share of the traced window in
which no kernel, copy or memset runs on any stream of the card (the
union over streams, msabench/tracing.py)."""


def read(run):
    if run.trace is None or run.trace.window is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())
