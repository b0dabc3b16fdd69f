"""Global fudge constants, kept for exact parity with `barf/magic.py:1-2`.

MAGIC_NUMBER scales density in the renderer (multiplied by 3, net 1.0);
MAGIC_NUMBER_THE_SECOND scales the camera-extrinsics translation (net 1.0).
"""
MAGIC_NUMBER = 1.0 / 3.0
MAGIC_NUMBER_THE_SECOND = 1.0
