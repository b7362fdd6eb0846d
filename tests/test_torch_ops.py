"""The port's plain PyTorch primitives against the JAX package's, on the
same numpy inputs, on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from optflow_tpu.ops import pyramid as jpyr
from optflow_tpu.ops import warp as jwarp
from optflow_tpu_torch.ops import pyramid as tpyr
from optflow_tpu_torch.ops import warp as twarp
from tests.conftest import make_fibsem_like

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _batch(rng, n, h, w):
    return np.stack([make_fibsem_like(rng, h, w) for _ in range(n)])


@pytest.mark.parametrize(
    "shape", [(256, 1024), (512, 1024), (96, 128), (37, 53)]
)
def test_pyramid_shapes_equal(shape):
    assert tpyr.pyramid_shapes(*shape, 10, 0.8) == jpyr.pyramid_shapes(
        *shape, 10, 0.8
    )
    assert tpyr.pyramid_shapes(*shape, 3, 0.5) == jpyr.pyramid_shapes(
        *shape, 3, 0.5
    )


@pytest.mark.parametrize(
    "src,dst", [((96, 128), (77, 102)), ((77, 102), (96, 128)),
                ((37, 53), (30, 42)), ((34, 137), (43, 171))]
)
def test_resize_bilinear_matches_jax(rng, src, dst):
    """Tolerance 2e-4 on 0-255 frames: both are half-pixel bilinear without
    antialiasing; only the weight arithmetic's rounding differs."""
    ims = _batch(rng, 2, *src)
    want = np.stack(
        [np.asarray(jpyr.resize_bilinear(jnp.asarray(im), dst)) for im in ims]
    )
    got = tpyr.resize_bilinear(_t(ims), dst).numpy()
    assert got.shape == (2, *dst)
    assert np.abs(got - want).max() <= 2e-4
    # a single (H, W) image takes the same code
    one = tpyr.resize_bilinear(_t(ims[0]), dst).numpy()
    assert np.abs(one - want[0]).max() <= 2e-4


def test_build_pyramid_and_upscale_flow(rng):
    im = make_fibsem_like(rng, 64, 96)
    shapes = jpyr.pyramid_shapes(64, 96, 4, 0.8)
    want = jpyr.build_pyramid(jnp.asarray(im), shapes)
    got = tpyr.build_pyramid(_t(im)[None], shapes)
    for a, b in zip(want, got):
        assert np.abs(np.asarray(a) - b[0].numpy()).max() <= 4e-4
    u = rng.standard_normal((2, *shapes[1])).astype(np.float32)
    w1, w2 = jpyr.upscale_flow(
        jnp.asarray(u[0]), jnp.asarray(u[1]), shapes[0], 0.8
    )
    g1, g2 = tpyr.upscale_flow(_t(u[0]), _t(u[1]), shapes[0], 0.8)
    assert np.abs(np.asarray(w1) - g1.numpy()).max() <= 1e-5
    assert np.abs(np.asarray(w2) - g2.numpy()).max() <= 1e-5


@pytest.mark.parametrize("shape", [(37, 53), (40, 56)])
def test_centered_gradient_matches_jax(rng, shape):
    ims = _batch(rng, 2, *shape)
    gx, gy = twarp.centered_gradient(_t(ims))
    for k in range(2):
        wx, wy = jwarp.centered_gradient(jnp.asarray(ims[k]))
        assert np.abs(gx[k].numpy() - np.asarray(wx)).max() <= 1e-5
        assert np.abs(gy[k].numpy() - np.asarray(wy)).max() <= 1e-5


@pytest.mark.parametrize("shape", [(37, 53), (40, 56)])
def test_forward_gradient_and_divergence_match_jax(rng, shape):
    u = rng.standard_normal((2, 2, *shape)).astype(np.float32)
    ux, uy = twarp.forward_gradient(_t(u[0]))
    div = twarp.divergence(_t(u[0]), _t(u[1]))
    for k in range(2):
        wx, wy = jwarp.forward_gradient(jnp.asarray(u[0, k]))
        wd = jwarp.divergence(jnp.asarray(u[0, k]), jnp.asarray(u[1, k]))
        assert np.abs(ux[k].numpy() - np.asarray(wx)).max() <= 1e-5
        assert np.abs(uy[k].numpy() - np.asarray(wy)).max() <= 1e-5
        assert np.abs(div[k].numpy() - np.asarray(wd)).max() <= 1e-5


@pytest.mark.parametrize(
    "kind,amp", [("small", 1.5), ("leaves_image", 60.0), ("beyond_8px", 14.0)]
)
def test_warp_backward_matches_jax(rng, kind, amp):
    """All five outputs within 1e-3 (intensities 0-255, so a relative 4e-6):
    the exact gather has no bound on the flow — flows that leave the image
    clamp to the edge, flows beyond 8 px are sampled exactly."""
    h, w = 37, 53
    i0 = _batch(rng, 2, h, w)
    i1 = _batch(rng, 2, h, w)
    if kind == "beyond_8px":
        u = np.full((2, 2, h, w), amp, np.float32)
        u[1] = -9.5
        u += rng.standard_normal(u.shape).astype(np.float32)
    else:
        u = (amp * rng.standard_normal((2, 2, h, w))).astype(np.float32)
    i1x, i1y = twarp.centered_gradient(_t(i1))
    got = twarp.warp_backward(_t(i0), _t(i1), i1x, i1y, _t(u[0]), _t(u[1]))
    for k in range(2):
        jx, jy = jwarp.centered_gradient(jnp.asarray(i1[k]))
        want = jwarp.warp_backward(
            jnp.asarray(i0[k]), jnp.asarray(i1[k]), jx, jy,
            jnp.asarray(u[0, k]), jnp.asarray(u[1, k]),
        )
        for name, a, b in zip(
            ("i1w", "i1wx", "i1wy", "grad", "rho_c"), want, got
        ):
            diff = np.abs(np.asarray(a) - b[k].numpy())
            scale = max(1.0, float(np.abs(np.asarray(a)).max()) / 255.0)
            assert diff.max() <= 1e-3 * scale, (name, diff.max())


# --- the affine warp of feature pre-alignment --------------------------------

AFFINES = np.array([
    [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
    [[1.0, 0.0, 6.5], [0.0, 1.0, -4.25]],
    [[0.9986, -0.0523, 5.0], [0.0523, 0.9986, 2.0]],  # 3 degrees
    [[1.15, 0.02, -7.0], [-0.03, 0.9, 3.0]],
    [[2.0, 4.0, 1.0], [1.0, 2.0, 0.0]],  # singular
], np.float32)


def test_invert_affine_matches_jax():
    """1e-6 on entries of order 1-10: the same closed form, float32."""
    want = np.stack([np.asarray(jwarp.invert_affine(jnp.asarray(a)))
                     for a in AFFINES])
    got = twarp.invert_affine(_t(AFFINES)).numpy()
    assert got.shape == (5, 2, 3)
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())
    assert not got[4].any()  # a singular matrix inverts to zeros
    one = twarp.invert_affine(_t(AFFINES[2])).numpy()
    assert np.array_equal(one, got[2])
    both = np.vstack([AFFINES[3], [0, 0, 1]]) @ np.vstack([got[3], [0, 0, 1]])
    assert np.abs(both - np.eye(3)).max() <= 1e-5


@pytest.mark.parametrize("out_shape", [None, (40, 90), (70, 64)])
def test_affine_warp_matches_jax(rng, out_shape):
    """Tolerance 1e-4 on 0-255 frames: the same taps and weights; the
    constant border (taps outside contribute the fill) included."""
    ims = _batch(rng, 4, 48, 80)
    for fill in (0.0, 7.0):
        want = np.stack([
            np.asarray(jwarp.affine_warp(
                jnp.asarray(im), jnp.asarray(a), out_shape=out_shape,
                fill=fill))
            for im, a in zip(ims, AFFINES)
        ])
        got = twarp.affine_warp(
            _t(ims), _t(AFFINES[:4]), out_shape=out_shape, fill=fill).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4
        one = twarp.affine_warp(
            _t(ims[1]), _t(AFFINES[1]), out_shape=out_shape, fill=fill)
        assert np.abs(one.numpy() - want[1]).max() <= 1e-4
    assert np.array_equal(
        twarp.affine_warp(_t(ims[0]), _t(AFFINES[0])).numpy(), ims[0])
    with pytest.raises(ValueError):
        twarp.affine_warp(_t(ims), _t(AFFINES[:2]))
