"""The benchmark's plain reference of the path tracer.

A frozen copy of the port's plain PyTorch modules (camera, sampling,
scene tables, interaction, BSDFs, lights, film filters and the path
integrator), changed in two places: a sample stream takes one sample index
a lane (``sampling/``), so lanes of many frames share a wavefront
(``render.py``), and ray queries are the reference's own (``query.py``).
It imports nothing of the program: later changes to the program do not
move it.
"""
