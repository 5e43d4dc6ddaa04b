"""The comparison that decides ``correct``: numbers from the program's
output against the plain reference's, each with its limit
(``limits/<workload>.json``)."""
from __future__ import annotations

import math

import torch

# a pixel agrees within |p - r| <= RTOL * |r| + ATOL, every channel.  A
# sample whose path takes another turn on a rounding difference (a texel
# boundary, a grazing edge) moves its pixel's mean by its radiance over the
# frame count; 1e-2 lets that pass from about a hundred frames on, and the
# bfloat16 control's drift through every op does not
RTOL, ATOL = 1e-2, 1e-3


def pixels_off(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of the (P, 3) pixels where the program's value departs from the
    reference's by more than RTOL * |ref| + ATOL in some channel, or is not
    finite."""
    prog, ref = prog.double(), ref.double()
    bad = ~torch.isfinite(prog).all(-1)
    bad |= ((prog - ref).abs() > RTOL * ref.abs() + ATOL).any(-1)
    return float(bad.double().mean())


def mean_rel(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The relative departure of the sampled pixels' mean from the
    reference's (a bias over the image); not finite where the program's
    pixels are not."""
    p, r = prog.double().mean(), ref.double().mean()
    return float((p - r).abs() / r.abs().clamp_min(1e-30))


def describe(prog: torch.Tensor, ref: torch.Tensor) -> dict:
    """Diagnostics printed beside the checks: the largest departure, the
    share off at a tenth of the tolerance, the median pixel's relative
    departure."""
    p, r = prog.double(), ref.double()
    d = (p - r).abs()
    rel = (d / (r.abs() + ATOL)).amax(-1)
    return {"max_abs": float(d.max()), "ref_mean": float(r.mean()),
            "off_1e-3": float((d > 1e-3 * r.abs() + 1e-4).any(-1).double().mean()),
            "median_rel": float(rel.median())}


def judge(values: dict, limits: dict) -> dict:
    """{name: {"value": v, "limit": l}} for every limited number, a number
    that is not finite (or was never read) as None."""
    def finite(v):
        return v if v is not None and math.isfinite(v) else None
    return {k: {"value": finite(values.get(k)), "limit": limits[k]["limit"]} for k in limits}


def passed(checked: dict) -> bool:
    """Every number read, and at most its limit."""
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checked.values())
