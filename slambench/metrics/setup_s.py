"""Process start to the first timed frame: imports, the kernels' load (and
build, in a fresh checkout), the sequence's generation, the system's
construction and the cell's set-up frames."""


def read(run):
    return run.setup_s
