"""The query glue's dispatch work a sample per pixel: the top-level host ops
that start inside the program's ``mcrt.query.*`` spans (the ray table's
packing, the coherence sort, the visit lists, the unsort and the hit
record around the kernels), over the samples the traced window completed
(queries layer)."""
from perfbench import program_spans


def read(rec):
    return program_spans.ops_per_spp(rec, "mcrt.query")
