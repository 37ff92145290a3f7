"""setup_s: seconds from the process's start (run.py's first line) to
the window's start: imports, the card's start, the corpus and queries,
the kernels' build (the first run of a checkout), the index build and
the warm-up calls."""


def read(run):
    return run.setup_s
