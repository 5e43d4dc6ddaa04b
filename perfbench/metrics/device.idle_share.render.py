"""The device's idle share of rendering, in %: 1 minus the union of every
device op's interval in the traced frames over the wall time the same
frames take untraced (from the window's untraced frames, run before
them), so the profiler's own host time is not counted as idle."""
from perfbench import stats


def read(rec):
    if rec.loop not in ("progressive", "sharded") or rec.untraced_s <= 0 or not rec.device:
        return None
    return 100.0 * stats.idle_share([(ts, ts + d) for _, ts, d in rec.device],
                                    rec.untraced_s * 1e6)
