"""Policy networks, observation normalizer, distributions, TD(lambda), the
PPO agent and its training iteration, and network diagnostics."""
