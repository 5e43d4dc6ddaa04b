"""Progressive BDPT: the ``progressive`` loop (``Renderer.step(1)`` in a
closed loop, its window, its traced record under the loop name
``"progressive"``, its query counters) with the mix's ``integrator`` in the
configuration's render settings, checked against the reference's BDPT
(``refside_bdpt.BDPTReference``) over every frame the window drove.

End to end: the progressive loop's, and ``peak_mem_gib``, the device's peak
allocation over the run before the check (``memory_peak_bytes`` over 2^30).
"""
from __future__ import annotations

from ..refside_bdpt import BDPTReference
from . import Outcome, progressive


def _bdpt(ctx, precision=None):
    """``ctx`` with the mix's integrator and the BDPT reference."""
    ctx.config["render"] = {**ctx.config["render"], "integrator": dict(ctx.traffic["integrator"])}
    ctx.reference = BDPTReference(precision)
    return ctx


def run(ctx) -> Outcome:
    out = progressive.run(_bdpt(ctx, ctx.reference.precision))
    out.end_to_end["peak_mem_gib"] = out.memory_peak_bytes / 2**30
    return out


def control(ctx, low, frames: int) -> dict:
    """The compared numbers with the BDPT reference at ``low.precision`` in
    the program's place, over ``frames`` samples from the seed's first."""
    return progressive.control(_bdpt(ctx), BDPTReference(low.precision), frames)
