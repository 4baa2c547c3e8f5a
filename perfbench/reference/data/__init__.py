"""Frozen reference copy; see ``perfbench/reference/__init__.py``."""
