"""The benchmark's yardstick: cell specs, seeded weights and traffic, the
counting functions, the trace reduction and the run itself."""
