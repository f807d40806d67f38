"""Share of the multifrontal fronts' slots that hold padding, in percent:
100 (1 - ``NDInfo.used_slots`` / ``NDInfo.total_slots``), where the used
slots are the fronts' own (p + u)^2 summed over fronts and the total pads
every front of a level to the level's widest.  A program without the
``used_slots`` counter gives the same sum from its analysis' index arrays
(``elim_gid``, ``bd_gid``: own unknowns, the padding unknown N).  Nothing
to read on a backend without fronts."""


def _used_slots(info):
    used = getattr(info, "used_slots", None)
    if used is not None:
        return used
    return sum(int((((eg < info.N).sum(1) + (bg < info.N).sum(1)) ** 2).sum())
               for eg, bg in zip(info.elim_gid, info.bd_gid))


def read(run):
    total = getattr(run.info, "total_slots", None)
    return 100.0 * (1.0 - _used_slots(run.info) / total) if total else None
