"""Device ms a replayed terrain period under the spans ``terrain.command``
(the MPC tick's body-height command from the map), ``terrain.foothold``
(the spiral foothold search of every swing update, inside
``mpc.swing_update``) and ``terrain.ground`` (the plant's ground clamp,
inside ``srb_sim.step``), from the graph's segment map and the profiled
device rows.  None where the period has none of the three spans."""

from port_bench.lib import spans

NAMES = ("terrain.command", "terrain.foothold", "terrain.ground")


def read(ctx):
    reps = spans.replays(ctx)
    if reps is None or not any(n in path.split("/") for r in reps for path in r.us
                               for n in NAMES):
        return None
    return sum(spans.under(r.us, n) for r in reps for n in NAMES) / 1e3 / ctx.profiled_units
