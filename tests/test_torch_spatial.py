"""Parity of the port's 6D spatial algebra (`physics/spatial.py`) with the JAX
package's: every function on seeded batched f32 inputs (leading dims (4, 5)),
with rotations for the transforms and symmetric positive-definite blocks for
`inv33` and `solve_spd66`.

Tolerance: 1e-5 relative, elementwise, with an absolute floor of 1e-5 of the
output's largest magnitude (entries near zero are sums of cancelling
products whose rounding differs between the frameworks by an ulp of the
terms, not of the result).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vid2player3d_tpu.physics import spatial as JSP
from vid2player3d_torch import physics as TP
from vid2player3d_torch.physics import spatial as TSP

torch.set_num_threads(1)

LEAD = (4, 5)
RTOL = 1e-5


def _rot(rng):
    q = rng.standard_normal(LEAD + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = np.moveaxis(q, -1, 0)
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                  2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                  2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)
    return R.reshape(LEAD + (3, 3)).astype(np.float32)


def _spd(rng, n):
    a = rng.standard_normal(LEAD + (n, n))
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(np.float32)


def _vec(rng, n, scale=1.0):
    return (rng.standard_normal(LEAD + (n,)) * scale).astype(np.float32)


def _inputs(name, rng):
    return {
        "skew": lambda: (_vec(rng, 3),),
        "spatial_inertia": lambda: (rng.uniform(0.5, 8.0, LEAD).astype(np.float32),
                                    _vec(rng, 3, 0.2), _spd(rng, 3) * 0.05),
        "inv33": lambda: (_spd(rng, 3),),
        "solve_spd66": lambda: (_spd(rng, 6), _vec(rng, 6)),
        "cross_motion": lambda: (_vec(rng, 6), _vec(rng, 6)),
        "cross_force": lambda: (_vec(rng, 6), _vec(rng, 6)),
        "xform_motion": lambda: (_rot(rng), _vec(rng, 3, 0.3), _vec(rng, 6)),
        "xform_force_to_parent": lambda: (_rot(rng), _vec(rng, 3, 0.3), _vec(rng, 6)),
        "xform_inertia_to_parent": lambda: (_rot(rng), _vec(rng, 3, 0.3), _spd(rng, 6)),
    }[name]()


NAMES = ("skew", "spatial_inertia", "inv33", "solve_spd66", "cross_motion", "cross_force",
         "xform_motion", "xform_force_to_parent", "xform_inertia_to_parent")


@pytest.mark.parametrize("name", NAMES)
def test_spatial_matches_jax(name):
    rng = np.random.default_rng(NAMES.index(name))
    args = _inputs(name, rng)
    want = np.asarray(getattr(JSP, name)(*(jnp.asarray(a) for a in args)))
    got = getattr(TSP, name)(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def test_spatial_solves_and_inverts():
    """`inv33` and `solve_spd66` against numpy's float64 linear algebra, and
    the package exports the module as the JAX package's does."""
    rng = np.random.default_rng(11)
    A3, A6, b = _spd(rng, 3), _spd(rng, 6), _vec(rng, 6)
    inv = TSP.inv33(torch.from_numpy(A3)).numpy()
    np.testing.assert_allclose(inv, np.linalg.inv(A3.astype(np.float64)), rtol=1e-5, atol=1e-6)
    x = TSP.solve_spd66(torch.from_numpy(A6), torch.from_numpy(b)).numpy()
    ref = np.linalg.solve(A6.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(x, ref, rtol=1e-4, atol=1e-6)
    assert TP.spatial is TSP
    assert {"ArticulationModel", "ArticulationState", "ContactParams", "engine",
            "asset"} <= set(dir(TP))
