"""Motion metrics, clip converters, the physics-fidelity harness and MDM
validation."""
