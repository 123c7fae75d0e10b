"""The benchmark's general machinery: seeds, traffic, the window, tracing,
the result line."""
