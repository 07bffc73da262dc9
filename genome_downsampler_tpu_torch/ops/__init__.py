"""Device ops of the port: coverage, kernel build, blocked sweep and
selection passes."""
