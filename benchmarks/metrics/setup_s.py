"""setup_s (s): from the process's start to the first timed call: imports,
the kernels' build or load, weights and corpus made on the card, the
engine's ``_finish_cache``, and the warm-up calls of the cell's shapes."""


def read(run):
    return run.setup_s
