"""The harness: it finds a cell's files by the names in ``BENCHMARK.json``,
makes the inputs from the seed, drives the port, times the window, reads
the metrics and decides ``correct``."""
