"""The general harness: registry, traffic, weights, the system under test, tracing, the check and a run."""
