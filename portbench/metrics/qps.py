"""qps: queries answered over the window's wall time (host clock), the
whole window: from the first call's issue to the last call's answers on
the host."""


def read(run):
    return run.queries / run.window_s
