"""The device's idle share of rendering left while the host runs BDPT's
stages, in %: ``device.idle_share.render`` times the share of the traced
window's idle time whose gaps start inside the program's ``mcrt.bdpt.*``
spans (renderer and integrator layer)."""
from perfbench import program_spans


def read(rec):
    return program_spans.idle_share(rec, "mcrt.bdpt")
