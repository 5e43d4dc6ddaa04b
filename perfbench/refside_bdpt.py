"""The reference side of a BDPT cell's check: ``refside.Reference`` with the
reference's BDPT film (``reference/bdpt_render.film_at_bdpt``) as its
``film``, in float32 or, for the control, rounded to ``precision`` through
``refside.RoundTo``.  It imports nothing of the program."""
from __future__ import annotations

from .reference import bdpt_render
from .refside import Reference


class BDPTReference(Reference):
    def film(self, spec, render: dict, pixels, frames):
        """(P, 3) progressive BDPT film at ``pixels`` after samples ``frames``."""
        return self._run(bdpt_render.film_at_bdpt, spec, render, pixels.device, pixels, frames)
