"""The port's window attention against the JAX package's.

``window_attention_reference`` (the plain PyTorch version the Hopper kernel
is held against) must agree with ``window_attention_xla`` and, where its
chunk rule allows, with the Pallas kernel in interpret mode. Tolerance 2e-5
absolute, as tests/test_pallas_attention.py uses: float32 sums taken in
another order. The kernel itself runs only on a CUDA card (``gpu`` marker);
its precision scheme (3xTF32 products for float32) is emulated here in numpy
and held to the same tolerance.

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


def qkv_views(q, k, v):
    """q, k and v as SwinIR hands them to the kernel: strided (heads, B_, N,
    d) views of one (B_, N, 3, heads, d) projection, holding the same
    values."""
    qkv = torch.stack([q, k, v]).permute(2, 3, 0, 1, 4).contiguous()
    return qkv.permute(2, 3, 0, 1, 4).unbind(0)


def off_pair(t):
    """A copy of ``t`` that starts 4 bytes past an 8-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return flat[1:].view(t.shape).copy_(t)


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


def tf32(x):
    """float32 rounded to TF32 (10 mantissa bits): round to nearest on the 13
    low mantissa bits, ties away from zero, as ``cvt.rna.tf32.f32``."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_matmul(a, b, terms):
    """a @ b from TF32 parts, as the kernel's tensor-core products: 3 terms
    is a_hi b_hi + a_hi b_lo + a_lo b_hi (3xTF32), 1 term a_hi b_hi. Each
    product of two TF32 values is exact; sums in float64, rounded to float32."""
    a_hi, b_hi = tf32(a), tf32(b)
    out = a_hi.astype(np.float64) @ b_hi
    if terms == 3:
        out += (a_hi.astype(np.float64) @ tf32(b - b_hi)
                + tf32(a - a_hi).astype(np.float64) @ b_hi)
    return out.astype(np.float32)


def emulated_kernel(q, k, v, bias, mask, terms):
    """The kernel's float32 arithmetic: the score sums start from
    (bias + mask) * d^1/2 and add q.k from TF32 parts; the exponent scales
    them by d^-1/2; unnormalised exponentials times V from TF32 parts are
    divided by the row sum afterwards."""
    h, b_, n, d = q.shape
    scale = np.float32(d ** -0.5)
    init = np.broadcast_to(bias[:, None], (h, b_, n, n))
    if mask is not None:
        nw = mask.shape[0]
        init = (init.reshape(h, b_ // nw, nw, n, n) + mask).reshape(h, b_, n, n)
    s = init * (np.float32(1) / scale) + tf32_matmul(q, k.swapaxes(-1, -2), terms)
    e = np.exp((s - s.max(-1, keepdims=True)) * scale)
    return tf32_matmul(e, v, terms) / e.sum(-1, keepdims=True)


EMULATION_CASES = [(n, d, nw) for n, d in ((64, 30), (49, 30), (64, 10))
                   for nw in (None, 16)]


def _emulation_error(n, d, nw, terms):
    case = make_case(n, d, nw, seed=3)
    want = wa.window_attention_reference(*to_torch(*case)).numpy()
    return np.abs(emulated_kernel(*case, terms) - want).max()


@pytest.mark.parametrize("n,d,nw", EMULATION_CASES)
def test_3xtf32_emulation_within_tolerance(n, d, nw):
    assert _emulation_error(n, d, nw, terms=3) <= TOL


@pytest.mark.parametrize("n,d,nw", EMULATION_CASES)
def test_1xtf32_emulation_misses_tolerance(n, d, nw):
    """Why the kernel splits each operand: one TF32 product keeps about
    three decimal digits, far outside the float32 tolerance."""
    assert _emulation_error(n, d, nw, terms=1) > TOL


@pytest.mark.parametrize("masked", [False, True])
def test_wrapper_takes_qkv_views(masked):
    q, k, v, bias, mask = to_torch(*make_case(64, 30, 16 if masked else None))
    views = qkv_views(q, k, v)
    assert all(t.stride(-1) == 1 and not t.is_contiguous() for t in views)
    wa._check(*views, bias, mask)  # the kernel takes them as they are
    torch.testing.assert_close(wa.window_attention(*views, bias, mask),
                               wa.window_attention(q, k, v, bias, mask),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_f32_pairs_aligns_bias(dtype):
    """The kernel reads bias and mask as float2 pairs: the wrapper hands it
    8-byte aligned float32 copies of views that start between two pairs."""
    bias = off_pair(torch.arange(2 * 64 * 64, dtype=torch.float32)
                    .reshape(2, 64, 64).to(dtype))
    assert bias.data_ptr() % 8 != 0
    got = wa.f32_pairs(bias)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.data_ptr() % 8 == 0
    torch.testing.assert_close(got, bias.float(), rtol=0, atol=0)


@pytest.mark.parametrize("dtype,d,layout,want", [
    (torch.float32, 30, "contiguous", 8), (torch.float32, 30, "qkv", 8),
    (torch.float32, 32, "qkv", 16), (torch.float32, 10, "contiguous", 8),
    (torch.bfloat16, 30, "qkv", 4), (torch.bfloat16, 15, "contiguous", 2)])
def test_copy_width(dtype, d, layout, want):
    """16-byte copies only where every row start is 16-byte aligned: the
    qkv projection's f32 rows at d 30 start 8-byte aligned."""
    q, k, v = (t.to(dtype) for t in to_torch(*make_case(64, d, None))[:3])
    if layout == "qkv":
        q, k, v = qkv_views(q, k, v)
    assert wa.copy_width(q, k, v) == want


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
@pytest.mark.parametrize("n,d,nw,layout", [
    (64, 30, None, "contiguous"), (64, 30, 64, "contiguous"),
    (64, 30, 81, "contiguous"), (49, 30, 100, "contiguous"),
    (64, 16, 16, "contiguous"), (64, 10, 16, "contiguous"),
    (64, 64, 16, "contiguous"), (64, 30, None, "qkv"), (64, 30, 64, "qkv"),
    (64, 30, 16, "offset")])
def test_kernel_matches_plain_on_card(n, d, nw, layout, dtype, tol):
    """bf16: two bf16 ulps at |o| < 4 (the kernel keeps p in f32 for its
    row sums and rounds it to bf16 only for P @ V, as the plain version
    does). Both are also held against float64 within the same tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, bias, mask = (None if t is None else t.cuda()
                           for t in to_torch(*make_case(n, d, nw, seed=2)))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    if layout == "qkv":
        q, k, v = qkv_views(q, k, v)
    if layout == "offset":  # bias and mask off an 8-byte boundary
        bias, mask = off_pair(bias), off_pair(mask)
    with torch.inference_mode():
        before = wa.window_attention.launches
        got = wa.window_attention(q, k, v, bias, mask)
        want = wa.window_attention_reference(q, k, v, bias, mask)
        torch.cuda.synchronize()
    assert wa.window_attention.launches == before + 1
    assert got.is_contiguous()
    assert (got.float() - want.float()).abs().max().item() <= tol
    exact = torch.einsum("hbnm,hbmd->hbnd", torch.softmax(
        (torch.einsum("hbnd,hbmd->hbnm", q.double() * d ** -0.5, k.double())
         + bias[:, None].double()
         + (0 if mask is None else mask.double().repeat(q.shape[1] // nw, 1, 1)[None])),
        -1), v.double())
    assert (got.double() - exact).abs().max().item() <= tol
