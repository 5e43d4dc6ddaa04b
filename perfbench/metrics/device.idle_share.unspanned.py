"""The device's idle share of rendering left while the host is inside no
program span, in %: ``device.idle_share.render`` times the share of the
traced window's idle time whose gaps start outside every ``mcrt.*`` span
(the loop's own Python, and what the spans miss; device layer)."""
from perfbench import program_spans


def read(rec):
    return program_spans.idle_share(rec, program_spans.UNSPANNED)
