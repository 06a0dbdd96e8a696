"""The benchmark harness: scenes, traffic, timing, traces, rooflines and the output check."""
