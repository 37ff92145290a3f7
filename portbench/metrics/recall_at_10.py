"""recall_at_10: |returned ids ∩ the reference's exact top-10| / 10 over
every query answered in the window (pb.check)."""


def read(run):
    return run.verdict["recall"]
