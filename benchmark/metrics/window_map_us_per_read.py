"""Host microseconds per read of the polish windows at centres of 2 kb or
more: the ``poa.window`` span over the ``poa.window_reads`` count
(``ops/poa.polish_round``) that the program puts in ``stage_walls``, each
summed over the libraries.  None where no read was counted."""


def read(rec):
    wall = sum(lib.walls.get("poa.window", 0.0) for lib in rec.libraries)
    reads = sum(lib.walls.get("poa.window_reads", 0) for lib in rec.libraries)
    return 1e6 * wall / reads if reads else None
