"""Host microseconds per read of the polish pileup's walk over the moves the
DP returned: the ``poa.walk`` span over the ``poa.reads`` count
(``ops/poa.pileup_stats``) that the program puts in ``stage_walls``, each
summed over the libraries.  None where no read was counted."""


def read(rec):
    walk = sum(lib.walls.get("poa.walk", 0.0) for lib in rec.libraries)
    reads = sum(lib.walls.get("poa.reads", 0) for lib in rec.libraries)
    return 1e6 * walk / reads if reads else None
