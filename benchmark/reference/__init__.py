"""The benchmark's plain reference of a BeNeRF train step and of a rendered
chunk of a frame, in float64 PyTorch.

Written from the method's equations (the NeRF MLP and its encodings, the
coarse + fine volume renderer, the cumulative cubic B-spline on SE(3), the
event time window and its accumulated polarities, the event and blur
losses, Adam), apart from the program under test: it imports neither JAX,
nor the JAX package, nor anything of the PyTorch port. The random draws of
a step or a chunk are worked out again from the seed with torch's own
generators (draws.py), in float32 as the program draws them, and widened
to float64 after; everything else is float64.
"""
