"""BDPT's dispatch work a sample per pixel: the top-level host ops that
start inside the program's ``mcrt.bdpt.*`` spans (the two walks' shading,
the four strategy families, the staging of the shadow rays and the t=1
splat; the queries' own glue counts under ``mcrt.query``), over the
samples the traced window completed (renderer and integrator layer; the
ops a CUDA graph of BDPT's eager stages would cut)."""
from perfbench import program_spans


def read(rec):
    return program_spans.ops_per_spp(rec, "mcrt.bdpt")
