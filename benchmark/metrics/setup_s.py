"""setup_s: host clock from the process's start to the window's start:
imports, the world, the engine's set-up, the warm-up calls."""


def read(run):
    return run.setup_s
