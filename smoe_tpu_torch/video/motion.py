"""Video motion constants (from smoe_tpu/video/motion.py:19).

Only `TIME_PLANE` is carried over: the bitstream's layered-tier ordering
needs it for dual-model video headers.  `transform_coords` (the motion
decode) waits for the video slice of the port.
"""

TIME_PLANE = -5.0   # reference smoe.py:684
