"""Terrain-aware kinematic motion optimization."""
