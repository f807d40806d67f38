"""Set-up's canonicalization (``sparse.canonicalize_sparse``: the pattern
analysis, RCM or nested dissection, the colourings): host clock around the
call, ended by a synchronize."""


def read(run):
    return run.canon_s
