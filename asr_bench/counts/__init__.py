"""What the cell's shapes need, whatever code does the work: the forward's
FLOPs from the configuration's layer shapes, the bytes of the copies' warp,
and the SR solve's operations and bytes. The yardstick of the roofline
and MFU metrics; the program cannot move it."""

from ..reference.deeplab import forward_flops
from .warp import copies_warp_bytes
from .solve import (SOLVE_OPS_PER_PIXEL_STEP, OPERATOR_OPS_PER_ELEMENT, solve_bytes,
                    solve_ops, step_flops)

__all__ = ["forward_flops", "copies_warp_bytes", "SOLVE_OPS_PER_PIXEL_STEP",
           "OPERATOR_OPS_PER_ELEMENT", "solve_bytes", "solve_ops", "step_flops"]
