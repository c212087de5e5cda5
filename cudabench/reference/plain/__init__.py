"""Frozen plain routes of the port (see ``cudabench/reference``)."""
