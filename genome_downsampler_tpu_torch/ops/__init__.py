"""Device ops of the port: coverage, kernel build, the dense sweep and the
blocked sweep and selection passes."""
