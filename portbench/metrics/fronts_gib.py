"""Memory of the multifrontal fronts: ``NDInfo.total_slots`` (the slots of
every front of every level) times the element size, in GiB.  Nothing to read
on a backend without fronts."""


def read(run):
    slots = getattr(run.info, "total_slots", None)
    return slots * run.dtype_bytes / 2 ** 30 if slots else None
