"""The port's LM layers (``repro_torch.models.layers``: ``rms_norm``,
``layer_norm``, ``rope_frequencies``, ``apply_rope``, ``_mask_bias``,
``gqa_attention``, ``swiglu``, ``gelu_mlp``) against the JAX package's on
the CPU: the same inputs, made by numpy from a seed, through both.
Tolerances: float32 rtol 1e-5 atol 1e-6; bfloat16 1e-2 (inputs rounded
to bfloat16 first, so both packages start from the same values)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL
from _torch_threads import _one_torch_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2, 1e-2)}


def _pair(x, dtype):
    """The same values as a JAX array and a tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype][:2]
    j = jnp.asarray(np.asarray(x, np.float32)).astype(jdt)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(tdt)


def _close(got: torch.Tensor, want, dtype):
    rtol, atol = DTYPES[dtype][2:]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.normal(size=(3, 5, 24)) * 3, dtype)
    js, ts = _pair(rng.normal(size=24) * 0.1, "float32")
    got = TL.rms_norm(tx, ts)
    assert got.dtype == tx.dtype
    _close(got, JL.rms_norm(jx, js), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.normal(size=(4, 16)) * 2 + 1, dtype)
    js, ts = _pair(rng.normal(size=16), "float32")
    jb, tb = _pair(rng.normal(size=16), "float32")
    got = TL.layer_norm(tx, ts, tb)
    assert got.dtype == tx.dtype
    _close(got, JL.layer_norm(jx, js, jb), dtype)


@pytest.mark.parametrize("d_head,theta", [(16, 10000.0), (240, 10000.0),
                                          (128, 1e6)])
def test_rope_frequencies_match_jax(d_head, theta):
    _close(TL.rope_frequencies(d_head, theta),
           JL.rope_frequencies(d_head, theta), "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope_matches_jax(dtype):
    """Split halves, at small and at 32k-scale positions."""
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.normal(size=(2, 6, 3, 16)), dtype)
    pos = np.array([0, 1, 7, 1023, 32767, 40000], np.int32)
    got = TL.apply_rope(tx, torch.tensor(pos))
    assert got.dtype == tx.dtype
    want = JL.apply_rope(jx, jnp.asarray(pos))
    if dtype == "float32":
        # the angle at 40,000 x a float32 frequency: sin/cos of angles of
        # thousands of radians differ in their last bits between libms
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=2e-5)
    else:
        _close(got, want, dtype)


def test_apply_rope_rotates_halves_not_pairs():
    x = torch.zeros((1, 1, 1, 4))
    x[..., 0] = 1.0                                     # first half, feature 0
    out = TL.apply_rope(x, torch.tensor([1]))
    # feature 0 pairs with feature 2 (= 0 + Dh/2)
    assert abs(float(out[..., 2]) - np.sin(1.0)) < 1e-6
    assert float(out[..., 1]) == 0.0


@pytest.mark.parametrize("window", [None, 3, 1 << 30])
@pytest.mark.parametrize("valid", [False, True])
def test_mask_bias_matches_jax(window, valid):
    q_pos = np.array([-1, 0, 2, 5, 9], np.int32)
    k_pos = np.array([-1, 0, 1, 2, 3, 5, 8, 9], np.int32)
    kv = (k_pos >= 0) if valid else None
    got = TL._mask_bias(torch.tensor(q_pos), torch.tensor(k_pos), window,
                        None if kv is None else torch.tensor(kv))
    want = JL._mask_bias(jnp.asarray(q_pos), jnp.asarray(k_pos), window,
                         None if kv is None else jnp.asarray(kv))
    assert got.dtype == torch.float32 and got.shape == (5, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# gqa_attention: (name, B, Sq, Sk, Hq, Hkv, window, q_chunk, k_valid, q_pos0)
ATTN = [
    ("rep1", 2, 12, 12, 4, 4, None, None, False, 0),
    ("rep2", 2, 12, 12, 4, 2, None, None, False, 0),
    ("window8", 1, 20, 20, 4, 2, 8, None, False, 0),
    ("window-big", 1, 20, 20, 4, 2, 1 << 30, None, False, 0),
    ("chunk-divides", 2, 16, 16, 4, 2, None, 4, False, 0),
    ("chunk-not-dividing", 2, 13, 13, 4, 2, 5, 4, False, 0),
    ("chunk-past-sq", 1, 6, 6, 2, 1, None, 8, False, 0),
    ("k_valid", 2, 1, 10, 4, 2, None, None, True, 6),
    ("decode-sq1-window", 2, 1, 10, 4, 1, 4, None, True, 9),
    ("all-masked-row", 1, 3, 5, 2, 2, None, None, True, 0),
]


def _attn_inputs(B, Sq, Sk, Hq, Hkv, valid, q_pos0, dtype, seed):
    rng = np.random.default_rng(seed)
    jq, tq = _pair(rng.normal(size=(B, Sq, Hq, 8)), dtype)
    jk, tk = _pair(rng.normal(size=(B, Sk, Hkv, 8)), dtype)
    jv, tv = _pair(rng.normal(size=(B, Sk, Hkv, 8)), dtype)
    q_pos = np.arange(q_pos0, q_pos0 + Sq, dtype=np.int32)
    k_pos = np.arange(Sk, dtype=np.int32)
    kv = None
    if valid:
        kv = k_pos <= q_pos[-1]
        if Sq == 3:                              # no valid key at all
            kv = np.zeros(Sk, bool)
    return (jq, jk, jv, q_pos, k_pos, kv), (tq, tk, tv)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ATTN, ids=[c[0] for c in ATTN])
def test_gqa_attention_matches_jax(case, dtype):
    _, B, Sq, Sk, Hq, Hkv, window, q_chunk, valid, q_pos0 = case
    (jq, jk, jv, q_pos, k_pos, kv), (tq, tk, tv) = _attn_inputs(
        B, Sq, Sk, Hq, Hkv, valid, q_pos0, dtype, seed=Sq * 7 + Hkv)
    want = JL.gqa_attention(
        jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(k_pos), window=window,
        k_valid=None if kv is None else jnp.asarray(kv), q_chunk=q_chunk)
    got = TL.gqa_attention(
        tq, tk, tv, torch.tensor(q_pos), torch.tensor(k_pos), window=window,
        k_valid=None if kv is None else torch.tensor(kv), q_chunk=q_chunk)
    assert got.dtype == tq.dtype and got.shape == (B, Sq, Hq, 8)
    assert bool(torch.isfinite(got).all())
    _close(got, want, dtype)


def test_all_masked_row_is_the_uniform_mean():
    """A query with no key to attend takes the mean of every value row:
    the -1e30 bias gives a uniform softmax, not NaN."""
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.normal(size=(1, 1, 2, 4)), dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(1, 6, 2, 4)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(1, 6, 2, 4)), dtype=torch.float32)
    out = TL.gqa_attention(q, k, v, torch.tensor([3]), torch.arange(6),
                           k_valid=torch.zeros(6, dtype=torch.bool))
    torch.testing.assert_close(out[0, 0], v[0].mean(0), rtol=1e-6,
                               atol=1e-6)


def test_gqa_attention_rejects_heads_that_do_not_group():
    q = torch.zeros((1, 2, 3, 4))
    k = torch.zeros((1, 2, 2, 4))
    with pytest.raises(ValueError, match="3 query heads over 2"):
        TL.gqa_attention(q, k, k, torch.arange(2), torch.arange(2))


def test_f32_bmm_is_exact_products_summed_in_float32():
    """bfloat16 operands: the float32 result equals the float64 product of
    their values to float32 rounding of the sums, never rounded to
    bfloat16 (the JAX preferred_element_type=float32)."""
    rng = np.random.default_rng(6)
    a = torch.tensor(rng.normal(size=(3, 5, 64))).to(torch.bfloat16)
    b = torch.tensor(rng.normal(size=(3, 64, 7))).to(torch.bfloat16)
    got = TL.f32_bmm(a, b)
    assert got.dtype == torch.float32
    want = torch.bmm(a.double(), b.double())
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-5)
    assert not torch.equal(got, got.to(torch.bfloat16).float())


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_matches_jax(dtype):
    rng = np.random.default_rng(7)
    jx, tx = _pair(rng.normal(size=(2, 5, 16)), dtype)
    ws = [_pair(rng.normal(size=s) / 4, "float32")
          for s in ((16, 32), (16, 32), (32, 16))]
    got = TL.swiglu(tx, *(w[1] for w in ws))
    assert got.dtype == tx.dtype
    _close(got, JL.swiglu(jx, *(w[0] for w in ws)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_mlp_matches_jax_tanh_form(dtype):
    rng = np.random.default_rng(8)
    jx, tx = _pair(rng.normal(size=(6, 16)) * 2, dtype)
    ws = [_pair(rng.normal(size=s) / 3, "float32")
          for s in ((16, 32), (32,), (32, 16), (16,))]
    got = TL.gelu_mlp(tx, *(w[1] for w in ws))
    assert got.dtype == tx.dtype
    _close(got, JL.gelu_mlp(jx, *(w[0] for w in ws)), dtype)
    if dtype == "float32":
        # torch's default gelu (erf) would part from JAX's by far more
        h = tx @ ws[0][1] + ws[1][1]
        erf = torch.nn.functional.gelu(h) @ ws[2][1] + ws[3][1]
        assert float((erf - got).abs().max()) > 1e-4


def test_abs_p_is_a_meta_tensor():
    t = TL.abs_p(3, 4)
    assert t.device.type == "meta" and t.shape == (3, 4)
    assert t.dtype == torch.float32
    assert TL.abs_p(dtype=torch.int32).shape == ()
