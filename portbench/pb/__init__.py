"""The port benchmark's yardstick: what run.py composes (see harness.py)."""
