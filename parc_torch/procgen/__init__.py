"""Terrain paths: the A* planner and MDM rollouts along its paths."""
