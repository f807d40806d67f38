"""Set-up: from the process's start to the window's start (host clock):
loading the kernels, canonicalizing the problem and the cold solve."""


def read(run):
    return run.setup_s
