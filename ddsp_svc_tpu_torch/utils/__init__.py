"""Config, device policy and the flax -> torch weight bridge."""
