"""reorder_s.graph: the graph build's host MST reorder, seconds
(`KBest.build_times["reorder"]`)."""


def read(run):
    return run.build_times.get("reorder")
