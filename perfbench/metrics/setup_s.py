"""setup_s: seconds from the process's start to the window's start: imports,
the kernel libraries, the matrices, the program's decode bases and the
warm-up dispatches (host clock)."""


def read(run):
    return run.setup_s
