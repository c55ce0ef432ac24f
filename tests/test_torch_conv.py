"""The port's banded-matmul convs (ctc_asr_tpu_torch.models.layers) held
against the JAX reference's (ctc_asr_tpu/models/layers.py) on the CPU.

Kernels, biases and inputs come from numpy seeds and go to both
packages. Band matrices, slab starts and tilings must be equal; the
convs' values agree to 2e-4 and their gradients (of the kernel, the bias
and the input) to 2e-3 in f32 compute, as the reference's own tests hold
its forms against its 2-D conv (tests/test_models.py); one bf16 case at a
stated tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctc_asr_tpu.models import layers as jl
from ctc_asr_tpu_torch.models import layers as tl
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL, GRAD_TOL = 2e-4, 2e-3

# (kt, kf, cin, cout, st, sf, T, F): the reference's conv test cases
# (tests/test_models.py), then conv_bilstm3's two convs at a small T
CASES = [
    (5, 7, 1, 4, 2, 2, 21, 16),       # no 128-column tiling
    (3, 5, 4, 8, 1, 2, 10, 12),
    (11, 21, 2, 4, 2, 2, 30, 40),
    (11, 21, 2, 32, 2, 2, 30, 40),    # gfo=4 -> 128 columns
    (3, 5, 4, 16, 1, 2, 10, 32),      # gfo=8 -> 128 columns
    (11, 41, 1, 32, 2, 2, 12, 80),    # conv_bilstm3 conv 1
    (11, 21, 32, 32, 1, 2, 8, 40),    # conv_bilstm3 conv 2
]
TILED = [c for c in CASES
         if jl._pick_gfo(jl._same_pad(c[7], c[1], c[5])[0], c[3])]


def _case(kt, kf, cin, cout, st, sf, T, F, seed=0):
    rng = np.random.default_rng(seed + T + F)
    w = (rng.standard_normal((kt, kf, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, T, F, cin)).astype(np.float32)
    return w, b, x


@pytest.mark.parametrize("case", CASES)
def test_band_matrices_equal(case):
    kt, kf, cin, cout, st, sf, T, F = case
    w, _, _ = _case(*case)
    want = np.asarray(jax.jit(jl._band_matrices, static_argnums=(1, 2))(
        jnp.asarray(w), F, sf))
    got = tl._band_matrices(torch.from_numpy(w), F, sf).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", TILED)
def test_blocked_bands_equal(case):
    """Same integer slab starts and the same list of band matrices."""
    kt, kf, cin, cout, st, sf, T, F = case
    w, _, _ = _case(*case)
    gfo = jl._pick_gfo(jl._same_pad(F, kf, sf)[0], cout)
    want_starts, want = jax.jit(jl._blocked_bands, static_argnums=(1, 2, 3))(
        jnp.asarray(w), F, sf, gfo)
    starts, got = tl._blocked_bands(torch.from_numpy(w), F, sf, gfo)
    assert starts == [int(s) for s in want_starts]
    assert all(type(s) is int for s in starts)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pick_gfo_grid():
    for f_out in range(1, 49):
        for cout in (1, 3, 4, 8, 16, 32, 48, 64, 96, 128, 256):
            assert tl._pick_gfo(f_out, cout) == jl._pick_gfo(f_out, cout), \
                (f_out, cout)


def _both(jfn, tfn, case, dtype=jnp.float32, tdtype=torch.float32):
    """Values and the gradients of sum(y**2) w.r.t. w, b and x from the
    reference's ``jfn`` and the port's ``tfn`` on the same inputs."""
    kt, kf, cin, cout, st, sf, T, F = case
    w, b, x = _case(*case)

    def jloss(w_, b_, x_):
        y = jfn({"w": w_, "b": b_}, x_, (st, sf), dtype)
        return jnp.sum(y ** 2), y
    (_, jy), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(w), jnp.asarray(b), jnp.asarray(x))
    tw, tb, tx = (torch.from_numpy(a).requires_grad_() for a in (w, b, x))
    ty = tfn({"w": tw, "b": tb}, tx, (st, sf), tdtype)
    tg = torch.autograd.grad((ty ** 2).sum(), (tw, tb, tx))
    return (ty.detach().numpy(), [g.numpy() for g in tg],
            np.asarray(jy), [np.asarray(g) for g in jg])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("form", ["conv2d_matmul_apply",
                                  "conv2d_blocked_apply"])
def test_conv_forms_match_reference(form, case):
    """Values at 2e-4, gradients of the kernel, the bias and the input at
    2e-3, no-tiling cases included (the blocked form takes the full band
    there, as the reference's does)."""
    y, g, jy, jg = _both(getattr(jl, form), getattr(tl, form), case)
    assert y.shape == jy.shape
    np.testing.assert_allclose(y, jy, rtol=TOL, atol=TOL)
    for name, a, want in zip(("w", "b", "x"), g, jg):
        np.testing.assert_allclose(a, want, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", TILED)
def test_conv_blocked_fwd_impl_matches_reference(case):
    """The blocked body itself (no full-band dispatch) and the port's own
    2-D conv give the reference's values."""
    kt, kf, cin, cout, st, sf, T, F = case
    w, b, x = _case(*case)
    want = np.asarray(jax.jit(jl._conv_blocked_fwd_impl,
                              static_argnums=(3, 4))(
        jnp.asarray(w), jnp.asarray(b), jnp.asarray(x), (st, sf),
        jnp.float32))
    got = tl._conv_blocked_fwd_impl(torch.from_numpy(w), torch.from_numpy(b),
                                    torch.from_numpy(x), (st, sf),
                                    torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    plain = tl.conv2d_apply({"w": torch.from_numpy(w),
                             "b": torch.from_numpy(b)},
                            torch.from_numpy(x), (st, sf),
                            torch.float32).numpy()
    np.testing.assert_allclose(got, plain, rtol=TOL, atol=TOL)


def test_blocked_bf16_matches_reference():
    """bf16 compute at conv_bilstm3's conv 2: operands and the conv's
    output are rounded to bf16 in both packages, whose sums run in other
    orders; values within two bf16 ulps of the largest output (2**-7
    relative), the kernel gradient within 2e-2 of its largest."""
    case = (11, 21, 32, 32, 1, 2, 8, 40)
    y, g, jy, jg = _both(jl.conv2d_blocked_apply, tl.conv2d_blocked_apply,
                         case, jnp.bfloat16, torch.bfloat16)
    scale = np.abs(jy).max()
    assert np.abs(y - jy).max() <= 2 ** -7 * scale
    assert np.abs(g[0] - jg[0]).max() <= 2e-2 * np.abs(jg[0]).max()
