"""Shading's dispatch work a sample per pixel: the top-level host ops (each
enclosed by no other host op) that start inside the program's
``mcrt.shade`` spans and their parts, over the samples the traced window
completed (renderer and integrator layer; the ops a fused shade kernel or
a CUDA graph of the frame would cut)."""
from perfbench import program_spans


def read(rec):
    return program_spans.ops_per_spp(rec, "mcrt.shade")
