"""build_s: the program's own build seconds, the sum of
`KBest.build_times` (each stage ends in a device sync)."""


def read(run):
    return sum(run.build_times.values()) if run.build_times else None
