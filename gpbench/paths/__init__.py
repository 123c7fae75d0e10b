"""The program side of each configuration's path: a ``Session`` that makes
the benchmark's inputs from the seed, builds and warms the program in
set-up, runs one unit of traffic at a time in the window, hands over the
answers the check compares, and frees the program's state.

Each module here is the only part of the benchmark that imports the
program (``stheno_torch``); the plain references in ``reference/`` import
nothing of it."""
