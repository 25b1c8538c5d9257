"""Seconds from the process's start to the window's start: importing torch
and the port, drawing and writing the corpus, linking the pairs, drawing
and loading the weights, building the kernels where the checkout has not
yet built them, and the warm-up call."""


def read(run):
    return run.setup_s
