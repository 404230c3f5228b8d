"""Data-parallel training over ranks (port of ``parallel/``)."""
