"""The port's kernels against their plain PyTorch versions on the card.

Marked `gpu`: each test needs a CUDA device and skips without one (the check
is made inside the `cuda` fixture, never at import). This file imports no JAX,
so it also runs on a machine that has only the port's requirements:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from vid2player3d_torch.ops import fused_adam as FA

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# ragged sizes (one element, a head's bias, a size that is no multiple of the
# block) and the full-width trunk leaf
SIZES = (1, 69, 75 * 512, 1_000_003, 1024 * 734)


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", SIZES)
def test_k1_kernel_matches_plain(cuda, n, moments):
    """Three steps (clipped and not) on one leaf: the kernel does the plain
    version's f32 operations in the same order without FMA contraction, so
    params and moments agree to the last bit."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    p0 = torch.randn(n, generator=gen, device=cuda) * 0.05
    kern = [p0.clone(), torch.zeros(n, dtype=moments, device=cuda),
            torch.zeros(n, dtype=moments, device=cuda)]
    plain = [t.clone() for t in kern]
    count = torch.zeros((), dtype=torch.int32, device=cuda)
    before = FA.leaf_update.launches
    for scale in (3.0, 0.01, 1.0):
        g = torch.randn(n, generator=gen, device=cuda) * scale
        scalars, count = FA.adam_scalars([g], count, 1e-3, 1.0)
        FA.leaf_update(*kern, g, scalars)
        FA._leaf_plain(*plain, g, scalars, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert FA.leaf_update.launches == before + 3
    for a, b in zip(kern, plain):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, atol=0.0, rtol=0.0)
    assert not torch.equal(kern[0], p0)


def test_k1_apply_counts_one_launch_per_leaf(cuda):
    """`fused_clip_adam_apply` launches the kernel once per leaf and keeps
    the count on the device."""
    shapes = ((1024, 734), (1024,), (75, 512), (75,))
    ps = [torch.zeros(s, device=cuda) for s in shapes]
    ms = [torch.zeros_like(p, dtype=torch.bfloat16) for p in ps]
    vs = [torch.zeros_like(p, dtype=torch.bfloat16) for p in ps]
    gs = [torch.ones_like(p) for p in ps]
    before = FA.leaf_update.launches
    count = FA.fused_clip_adam_apply(ps, ms, vs, gs, torch.zeros((), dtype=torch.int32,
                                                                 device=cuda), 1e-3, 50.0)
    assert FA.leaf_update.launches == before + len(shapes)
    assert count.device.type == "cuda" and int(count) == 1
    # clip scale 50/|g| < 1, first step: every param moves by -lr
    for p in ps:
        torch.testing.assert_close(p, torch.full_like(p, -1e-3), rtol=1e-5, atol=0.0)


def test_k1_rejects_what_it_does_not_take(cuda):
    p = torch.zeros(8, device=cuda)
    s = torch.zeros(4, device=cuda)
    with pytest.raises(ValueError):
        FA.leaf_update(p, torch.zeros(8, device=cuda), torch.zeros(8), torch.zeros(8, device=cuda),
                       s)
    with pytest.raises(TypeError):
        FA.leaf_update(p, *(torch.zeros(8, dtype=torch.float16, device=cuda),) * 2,
                       torch.zeros(8, device=cuda), s)
