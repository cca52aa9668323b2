"""Process start to the window's opening: imports, the kernels' build or
load, weights and index made from the seed, the program's set-up and the
warm-up of every shape the cell uses."""


def read(run):
    return run.setup_s
