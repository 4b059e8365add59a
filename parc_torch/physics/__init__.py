"""Articulated rigid-body physics and the control-step kernel."""
