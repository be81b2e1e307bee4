"""World forward kinematics over a static joint tree, plain (the port's
`ops/fk.py` `_fk_plain`, used on every device here).

    R_0 = rot_0,  p_0 = root;   R_j = R_par @ rot_j,  p_j = p_par + R_par @ off_j
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..physics import soa


def fk_chain(rot, off, root_pos, parents: Sequence[int]):
    """rot (N, J, 3, 3), off (N, J, 3), root_pos (N, 3) -> (pos (N, J, 3),
    rotmat (N, J, 3, 3)), in the kernel's order of products and sums."""
    def mat_of(j):
        return rot[:, j].permute(1, 2, 0)             # (3, 3, N)

    gR = [mat_of(0)]
    gp = [root_pos.T]
    for j in range(1, len(parents)):
        p = parents[j]
        gp.append(gp[p] + soa.m_vec(gR[p], off[:, j].T))
        gR.append(soa.m_mul(gR[p], mat_of(j)))
    body_pos = torch.stack([v.T for v in gp], dim=1)
    body_rm = torch.stack([m.permute(2, 0, 1) for m in gR], dim=1)
    return body_pos, body_rm

