"""The plain references that decide ``correct``: straightforward float64
PyTorch, following the published mathematics, importing nothing of the
program (``stheno_torch``) nor the JAX package, and taking nothing the
program made. They take the benchmark's inputs (the data, and the seeds of
the random draws the benchmark hands the program) and the program's
answers, which they only judge. ``check(config, traffic, seed, inputs,
answers, device)`` returns the numbers compared, each a gap that must not
exceed its limit in ``limits/<cell>.json``."""
