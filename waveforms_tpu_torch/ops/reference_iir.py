"""Plain PyTorch version of the sequential IIR recurrence kernel (S1).

:func:`df2t` computes what ``csrc/iir_df2t.cu`` computes: direct form II
transposed over the rows of ``x``, with scipy's ``zi``/``zf`` semantics, in
the signal's type and in the kernel's (and the JAX package's
``_sequential_filter``'s) order of operations, one separate multiply or add
at a time, as the kernel's round-to-nearest intrinsics keep it:

    y[i]  = b0 * x[i] + s[0]
    s'    = (shift(s) + b[1:] * x[i]) - a[1:] * y[i]

It loops over time, one step for all rows at once; the products of the
input with the coefficients do not depend on the state and are formed for
every sample before the loop.  The kernel wrapper
(``kernels.iir_df2t``) runs it for tensors on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ['MAX_STATE', 'df2t']

#: the largest state the kernel holds in registers (csrc/iir_df2t.cu
#: IIR_MAX_D)
MAX_STATE = 16


def df2t(x, coef, zi, y, zf):
    """Filter the rows of ``x`` (R, n) into ``y`` from state ``zi`` (R, d),
    writing the final state to ``zf``; ``coef`` is (2 * (d + 1),), b[0..d]
    then a[0..d] (a[0] = 1, unread).  Returns ``y``."""
    rows, n = x.shape
    d = zi.shape[1]
    if not 1 <= d <= MAX_STATE:
        raise ValueError(f"the recurrence kernel takes a state of 1 to "
                         f"{MAX_STATE} entries, got {d}")
    b0, bt, at = coef[0], coef[1:d + 1], coef[d + 2:]
    bx0 = x * b0                     # b0 * x[i], every i
    bx = x[..., None] * bt           # b[1:] * x[i], every i
    zero = torch.zeros((rows, 1), dtype=x.dtype, device=x.device)
    s = zi.clone()
    for i in range(n):
        yn = bx0[:, i] + s[:, 0]
        s = (torch.cat([s[:, 1:], zero], 1) + bx[:, i]) - at * yn[:, None]
        y[:, i] = yn
    zf.copy_(s)
    return y
