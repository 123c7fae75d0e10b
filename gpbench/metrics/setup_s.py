"""setup_s: process start (the first line of run.py) until the window
opens: imports, the CUDA context, loading (and in a checkout's first run
building) the kernel library, making the data, the program's set-up and
the warm-up of every shape the traffic uses. Host clock."""


def read(run):
    return run.setup_s
