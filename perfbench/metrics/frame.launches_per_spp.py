"""Device kernels launched a sample per pixel: every kernel event of the
traced progressive window over the samples it completed (renderer and
integrator layer; the count a CUDA graph or fused shading would cut)."""


def read(rec):
    if rec.loop not in ("progressive", "sharded") or not rec.samples or not rec.kernels:
        return None
    return len(rec.kernels) / rec.samples
