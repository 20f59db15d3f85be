"""The port's window attention against the JAX package's.

``window_attention_reference`` (the plain PyTorch version the Hopper kernel
is held against) must agree with ``window_attention_xla`` and, where its
chunk rule allows, with the Pallas kernel in interpret mode. Tolerance 2e-5
absolute, as tests/test_pallas_attention.py uses: float32 sums taken in
another order. The kernel itself runs only on a CUDA card (``gpu`` marker).

JAX is imported inside the parity tests, not at module level, so that the
``gpu`` cases collect on the card's machine, which has no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_window_attention.py``.
"""
import numpy as np
import pytest
import torch

from srbh_tpu_torch.models.swinir import shift_attn_mask
from srbh_tpu_torch.ops import window_attention as wa

TOL = 2e-5
HEADS = 2
CHUNK = 8  # the Pallas path's DEFAULT_CHUNK


def jax_attention():
    from srbh_tpu.ops.pallas import window_attention as jwa

    assert jwa.DEFAULT_CHUNK == CHUNK
    return jwa


def make_case(n, d, nw, seed=0):
    """q, k, v (heads, B_, N, d), bias (heads, N, N) and the shift mask of
    an image of nW windows (None: unmasked, 16 windows)."""
    rng = np.random.default_rng(seed)
    ws = int(round(n ** 0.5))
    b_ = 2 * (nw or 8)
    q, k, v = (rng.normal(size=(HEADS, b_, n, d)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(HEADS, n, n)).astype(np.float32)
    mask = None
    if nw is not None:
        side = ws * int(round(nw ** 0.5))
        mask = shift_attn_mask(side, side, ws, ws // 2)
        assert mask.shape == (nw, n, n)
    return q, k, v, bias, mask


def to_torch(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in arrays]


def to_jax(*arrays):
    import jax.numpy as jnp

    return [None if a is None else jnp.asarray(a) for a in arrays]


CASES = [(n, d, nw) for n in (49, 64) for d in (16, 30)
         for nw in (None, 4, 16, 81)]


@pytest.mark.parametrize("n,d,nw", CASES)
def test_reference_matches_xla(n, d, nw):
    case = make_case(n, d, nw)
    want = np.asarray(jax_attention().window_attention_xla(*to_jax(*case)))
    got = wa.window_attention_reference(*to_torch(*case)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _chunk_allows(b_, nw):
    c = CHUNK
    return b_ % c == 0 and (nw is None or nw % c == 0 or c % nw == 0)


PALLAS_CASES = [(n, d, nw) for n, d, nw in CASES
                if d == 30 and _chunk_allows(2 * (nw or 8), nw)]


@pytest.mark.parametrize("n,d,nw", PALLAS_CASES)
def test_reference_matches_pallas_interpret(n, d, nw):
    case = make_case(n, d, nw, seed=1)
    want = np.asarray(jax_attention().window_attention_pallas(
        *to_jax(*case), interpret=True))
    got = wa.window_attention_reference(*to_torch(*case)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_pallas_cases_cover_both_kernels():
    assert {nw is None for _, _, nw in PALLAS_CASES} == {True, False}
    assert any(nw == 81 for _, _, nw in CASES)  # no chunk rule in the port


@pytest.mark.parametrize("masked", [False, True])
def test_wrapper_on_cpu_takes_plain_path(masked):
    q, k, v, bias, mask = to_torch(*make_case(64, 30, 16 if masked else None))
    before = wa.window_attention.launches
    got = wa.window_attention(q, k, v, bias, mask)
    assert wa.window_attention.launches == before
    torch.testing.assert_close(
        got, wa.window_attention_reference(q, k, v, bias, mask),
        rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["n", "d", "dtype", "bias", "mask", "grad",
                                 "contiguous"])
def test_kernel_input_checks(bad):
    n, d = 64, 30
    q, k, v, bias, mask = to_torch(*make_case(n, d, 4))
    if bad == "n":
        q = k = v = torch.zeros(HEADS, 8, 81, d)
        bias = torch.zeros(HEADS, 81, 81)
        mask = None
    elif bad == "d":
        q = k = v = torch.zeros(HEADS, 8, n, 65)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "bias":
        bias = bias[:1]
    elif bad == "mask":
        mask = torch.zeros(3, n, n)
    elif bad == "grad":
        q = q.requires_grad_()
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        wa._check(q, k, v, bias, mask)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("n,d,nw", [(64, 30, None), (64, 30, 64),
                                    (64, 30, 81), (49, 30, 100),
                                    (64, 16, 16)])
def test_kernel_matches_plain_on_card(n, d, nw, dtype, tol):
    """bf16: two bf16 ulps at |o| < 4 (the kernel keeps p in float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, bias, mask = (None if t is None else t.cuda()
                           for t in to_torch(*make_case(n, d, nw, seed=2)))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    with torch.inference_mode():
        before = wa.window_attention.launches
        got = wa.window_attention(q, k, v, bias, mask)
        want = wa.window_attention_reference(q, k, v, bias, mask)
        torch.cuda.synchronize()
    assert wa.window_attention.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= tol
