"""Traffic drivers: each runs a cell's set-up, its measured window and its
check against the plain reference, from the cell's parameter file."""
