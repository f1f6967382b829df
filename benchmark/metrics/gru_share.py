"""Share of the window, in %, spent in the GRU polisher's forward pass
(``models/polisher.forward_logits``: the features' upload, the network on
the device and the logits' copy back): the program's ``polisher.forward``
span in ``stage_walls``, summed over the libraries; None where it is
absent."""

KEYS = ("polisher.forward",)


def read(rec):
    walls = [lib.walls[k] for lib in rec.libraries for k in KEYS
             if k in lib.walls]
    if not walls or rec.window_s <= 0:
        return None
    return 100.0 * sum(walls) / rec.window_s
