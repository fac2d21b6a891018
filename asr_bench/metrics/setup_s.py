"""Process start to the first image handed to the timed ``serve`` call:
imports, weights, scenes, the stencil and the warm step (host clock)."""


def read(run):
    return run.setup_s
