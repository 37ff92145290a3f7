"""Seeded violations for docs_xref: this cites DESIGN.md §9, which does
not exist, and the fixture's DESIGN.md skips §3."""
