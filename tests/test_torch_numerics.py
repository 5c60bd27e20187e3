"""PyTorch port, numerics core: FxP quantization, quantize-once weights,
SIMD packing, CORDIC exp/divide and the activation datapath against the
JAX reference package on the same seeded numpy inputs (CPU).

Integer results (codes, scales, packed words) are held bit-equal. The
float CORDIC paths run the same f32 operations in the same order as the
reference, so they are held bit-equal too; the LV divide's sign test on
a denormal product is the one place XLA on the CPU may flush where torch
does not, so those tests run with denormals flushed on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cordic as jcordic
from repro.core import fxp as jfxp
from repro.core import qtensor as jqt
from repro.core import simd as jsimd
from repro.core.activation import flex_af as jflex_af
from repro_torch.convert import from_numpy_tree
from repro_torch.core import cordic as tcordic
from repro_torch.core import fxp as tfxp
from repro_torch.core import qtensor as tqt
from repro_torch.core import simd as tsimd
from repro_torch.core.activation import flex_af as tflex_af

FMTS = ("fxp4", "fxp8", "fxp12", "fxp16")


@pytest.fixture
def flush_denormals():
    # the mode is per process thread state: switch it back off after the
    # test so that later tests in this worker compute with denormals
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _x(seed, shape, scale=3.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("axis", [None, 0, -1])
def test_quantize_codes_and_scales_bit_equal(fmt, axis):
    x = _x(0, (16, 24))
    # exact halfway points exercise round-half-even on both sides
    x[0, :4] = [0.5, 1.5, -2.5, 2.5]
    jc, js = jfxp.quantize(jnp.asarray(x), jfxp.FORMATS[fmt], axis=axis)
    tc, ts = tfxp.quantize(torch.from_numpy(x), tfxp.FORMATS[fmt], axis=axis)
    assert str(tc.dtype).split(".")[-1] == str(np.asarray(jc).dtype)
    _eq(tc, jc)
    _eq(ts, js)
    _eq(tfxp.fake_quant(torch.from_numpy(x), tfxp.FORMATS[fmt]),
        jfxp.fake_quant(jnp.asarray(x), jfxp.FORMATS[fmt]))


@pytest.mark.parametrize("fmt", FMTS)
def test_pack_unpack_words_bit_equal(fmt):
    f = jfxp.FORMATS[fmt]
    lanes = 32 // f.bits
    codes = np.random.default_rng(1).integers(
        f.qmin, f.qmax + 1, size=(5, 8 * lanes)).astype(np.int32)
    jw = jsimd.pack(jnp.asarray(codes), f)
    tw = tsimd.pack(torch.from_numpy(codes), tfxp.FORMATS[fmt])
    assert tw.dtype == torch.int32
    _eq(tw, jw)
    _eq(tsimd.unpack(tw, tfxp.FORMATS[fmt]), codes)


@pytest.mark.parametrize("fmt", FMTS)
def test_quantize_params_bit_equal_and_converts(fmt):
    w = _x(2, (3, 32, 20), scale=0.2)          # [L, K, N] stacked weight
    tree = {"blocks": {"w1": w, "bias": _x(3, (3, 20))}, "lm_head": w[0]}
    jq = jqt.quantize_params(
        {"blocks": {"w1": jnp.asarray(w), "bias": jnp.asarray(tree[
            "blocks"]["bias"])}, "lm_head": jnp.asarray(w[0])}, fmt)
    tq = tqt.quantize_params(
        {"blocks": {"w1": torch.from_numpy(w),
                    "bias": torch.from_numpy(tree["blocks"]["bias"])},
         "lm_head": torch.from_numpy(w[0])}, fmt)
    for jl, tl in ((jq["blocks"]["w1"], tq["blocks"]["w1"]),
                   (jq["lm_head"], tq["lm_head"])):
        assert isinstance(tl, tqt.QuantizedTensor)
        assert (tl.fmt_name, tl.n, tl.packed) == (jl.fmt_name, jl.n,
                                                  jl.packed)
        _eq(tl.data, jl.data)
        _eq(tl.scale, jl.scale)
        _eq(tl.codes(), jl.codes())
    assert tqt.packed_bytes(tq) == jqt.packed_bytes(jq)
    # the converter carries a reference QuantizedTensor across unchanged
    jl = jq["blocks"]["w1"]
    conv = from_numpy_tree({"w": {"data": np.asarray(jl.data),
                                  "scale": np.asarray(jl.scale),
                                  "fmt": jl.fmt_name, "n": jl.n,
                                  "packed": jl.packed}})["w"]
    _eq(conv.data, jl.data)
    _eq(conv.layer(1).codes(), jl.codes()[1])


def test_convert_keeps_bf16_bits():
    a = jnp.asarray(_x(4, (7, 5))).astype(jnp.bfloat16)
    t = from_numpy_tree({"e": np.asarray(a)})["e"]
    assert t.dtype == torch.bfloat16
    _eq(t.float(), np.asarray(a.astype(jnp.float32)))


@pytest.mark.parametrize("stages", [4, 5, 8])
def test_extended_exp_bit_equal(stages, flush_denormals):
    z = np.concatenate([_x(5, (4096,), scale=20.0),
                        np.array([0.0, -0.0, 88.5, -90.0, 1e-30, -1e-30,
                                  0.34657359, -0.34657359], np.float32)])
    got = tcordic.extended_exp_float(torch.from_numpy(z), stages)
    want = jcordic.extended_exp_float(jnp.asarray(z), stages)
    _eq(got, want)
    assert tcordic.exp2_int(torch.tensor([-126.0, 0.0, 3.0, 127.0])
                            ).tolist() == [2.0 ** -126, 1.0, 8.0, 2.0 ** 127]


@pytest.mark.parametrize("stages", [5, 12, 24])
def test_lv_divide_bit_equal(stages, flush_denormals):
    den = np.abs(_x(6, (4096,))) + 0.1
    num = np.clip(_x(7, (4096,)), -1.0, 1.0) * den
    num[:3] = [0.0, den[1], -den[2]]
    got = tcordic.lv_divide_float(torch.from_numpy(num),
                                  torch.from_numpy(den), stages)
    want = jcordic.lv_divide_float(jnp.asarray(num), jnp.asarray(den),
                                   stages)
    _eq(got, want)


@pytest.mark.parametrize("af", ["sigmoid", "tanh", "relu", "silu", "gelu",
                                "exp", "softmax"])
@pytest.mark.parametrize("precision", [None, "fxp8"])
def test_flex_af_cordic_bit_equal(af, precision, flush_denormals):
    x = _x(8, (8, 64))
    got = tflex_af(torch.from_numpy(x), af, precision=precision)
    want = jflex_af(jnp.asarray(x), af, precision=precision)
    _eq(got, want)


@pytest.mark.parametrize("af", ["sigmoid", "tanh", "silu", "gelu", "exp",
                                "softmax"])
def test_flex_af_exact_matches_reference(af):
    # library transcendentals (XLA's and torch's) differ by a few ulps
    x = _x(9, (8, 64))
    got = tflex_af(torch.from_numpy(x), af, impl="exact")
    want = jflex_af(jnp.asarray(x), af, impl="exact")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_device_constants_match_python_rounding():
    c = tcordic.device_constants(4)
    assert c["shifts"] == jcordic._hr_schedule(4, True)
    assert c["inv_gain"] == np.float32(1.0 / jcordic.hyperbolic_gain(4, True))
    assert c["inv_ln2"] == np.float32(1.0 / np.log(2.0))
