"""Rotation algebra, heightfield terrain, checkpoints, logging and
profiling."""
