"""setup_s (s, host clock): from the harness's import to the window:
the port's import, its libraries built or loaded, the families made
from the seed and one warm alignment of a reduced family."""


def read(run):
    return run.setup_s
