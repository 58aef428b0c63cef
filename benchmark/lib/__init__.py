"""The benchmark's yardstick: the harness, traffic generation, the
arithmetic of rooflines and peaks, and the reduction of traces to metrics.
Nothing here imports the program except the drivers in ``traffic/``."""
