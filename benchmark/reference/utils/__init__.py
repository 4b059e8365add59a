"""Frozen plain copy (see reference/__init__.py)."""
