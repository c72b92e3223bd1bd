"""Seconds from the process's start to the feeder's accepting the timed CLI
call's connection, less the generation of the inputs: imports, the CUDA
context, loading (on a checkout's first run, building) the kernels, and the
warm-up CLI call."""


def read(run):
    return run.setup_s
