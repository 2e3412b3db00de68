"""Plain references: torch and numpy only, nothing of the port, nothing of
JAX."""
