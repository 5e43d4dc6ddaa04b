"""Inverse rendering on torch autograd: parameter views over the scene, the
image loss and an Adam-based inverse renderer (``estimators``)."""
