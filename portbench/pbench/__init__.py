"""The port's benchmark harness: the general parts that every cell shares.

``spec`` reads ``BENCHMARK.json`` and finds a cell's configuration,
traffic mix, driver and metric readers by name; ``traffic`` makes every
mix from its data file and the seed; ``trace`` holds the harness's spans
and reads the profiler's device trace; ``roofline`` holds the published
peaks and the bytes each kernel's work needs.
"""
