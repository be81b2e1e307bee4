"""The blended-expert linear layer of the MVAE decoder, plain (the port's
`ops/moe_linear.py` `moe_linear_ref`, used on every device here):

    out[b] = sum_e coeff[b, e] * (x[b] @ W[e] + bias[e])
"""

from __future__ import annotations

import torch


def moe_linear(x, coeff, w, b):
    """Per-expert products, then the coefficient blend (float32)."""
    per_expert = torch.einsum("bi,eio->beo", x, w)
    out = torch.einsum("be,beo->bo", coeff, per_expert)
    return out + coeff @ b
