"""100 x the foothold targets that the spiral search moved off their own
Raibert cell or found no valid cell for, over the targets it searched, over
the run so far: the program's device counters
(``control/cmpc_variant.FOOTHOLD_MOVED`` and ``FOOTHOLD_SEARCHED``, which
every replay adds to).  None where the program keeps no such counter."""


def read(ctx):
    from quad_periodic_mpc_tpu_torch.control import cmpc_variant

    if not hasattr(cmpc_variant, "foothold_counts"):
        return None
    moved, searched = cmpc_variant.foothold_counts()
    return 100.0 * moved / searched if searched else None
