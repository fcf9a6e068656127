"""The benchmark's plain reference of the radar chain.

Plain PyTorch and NumPy, written from the upstream processor's semantics
(Max-Manning/passiveRadar: signal_utils.py, clutter_removal.py,
range_doppler_processing.py, target_detection.py, config.py) and
independent of the code under test: nothing here imports the port, and
nothing takes a table, a weight or a filter that the port made. Every stage
runs in ``complex128`` (``Precision("fp64")``), or, as the correctness
control, in ``complex64`` with each stage's operands rounded to TF32's
10-bit mantissa (``Precision("tf32")``).
"""
