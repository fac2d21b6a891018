"""Operations and bytes of the aug solve, and the FLOPs of a whole step.

Per class-pixel and step the solve needs: the 7 x 9 stencil's 63 multiply-
adds (126); the data term's gradient 2 lambda_df (G x - b) (3); the TV
gradient, two differences, two signs and the adjoint's four differences and
sum (9), scaled (1); the L2 gradient 2 lambda_L2 x (2) and the sum of the
three (2); AMSGrad's first and second moments (3 + 4), two bias
corrections (2), the running max (1), a square root, an addition of
epsilon and a division (3), the step's scale and the update (2). That is
158. Bytes: the stencil (63 float32 planes) and each class's b read once,
the estimate written once, for the whole solve.
"""

STENCIL_TAPS = 63
SOLVE_OPS_PER_PIXEL_STEP = 2 * STENCIL_TAPS + 3 + 9 + 1 + 2 + 2 + 7 + 2 + 1 + 3 + 2
# A 2-tap lerp (3 operations) per element in each of the warp's three passes.
OPERATOR_OPS_PER_ELEMENT = 3 * 3


def solve_ops(planes: int, steps: int, height: int, width: int) -> int:
    return planes * steps * height * width * SOLVE_OPS_PER_PIXEL_STEP


def solve_bytes(planes: int, height: int, width: int, itemsize: int = 4) -> int:
    return (STENCIL_TAPS + 2 * planes) * height * width * itemsize


def step_flops(forward: int, images: int, copies: int, classes: int, steps: int,
               height: int, width: int, sr_types) -> int:
    """One step's FLOPs: the forward of every copy (``forward``: its FLOPs
    for ``images`` x ``copies`` network inputs), the solve, and the shear
    passes of the copies' warp, of b (an operator and its adjoint over the
    copies) and of max/mean's inverse warp."""
    planes = images * classes
    pixels = height * width
    total = forward + OPERATOR_OPS_PER_ELEMENT * copies * images * 3 * pixels
    if "aug" in sr_types:
        total += solve_ops(planes, steps, height, width)
        total += 2 * OPERATOR_OPS_PER_ELEMENT * copies * planes * pixels
    if "max" in sr_types or "mean" in sr_types:
        total += OPERATOR_OPS_PER_ELEMENT * copies * planes * pixels
    return total
