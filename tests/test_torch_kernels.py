"""PyTorch port, the two kernels of the serving path against the JAX
reference package's Pallas kernels (interpret mode, CPU), plus the
on-card checks of the CUDA kernels against their plain versions.

  * fxp_gemm_fused: the port's plain version vs fxp_gemm_fused_pallas on
    the same codes and scale — bit-exact without an AF (an exact int32
    product times the same f32 scale), and bit-exact with every CORDIC AF
    too (the same f32 operations in the same order; the stated tolerance
    would be 1 f32 ulp). `dispatch.matmul` with a quantize-once weight
    covers the quantize/scale/AF plumbing on both port backends.
  * paged_attention_float: the port's plain version vs the Pallas kernel
    under flexpe(8) (int8 dequant body, CORDIC softmax) and bf16 (float
    body, exact softmax), with a sentinel table entry, a block shared by
    two rows and an idle row. Tolerance: 1 bf16 ulp of the output (the
    einsum reductions run in another order than XLA's), widened by the LV
    divide's 2^-lv resolution under CORDIC.

The CUDA kernels themselves are held against these plain versions on the
card by `tests/test_torch_cuda.py` and `chip_smoke.py`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PrecisionPolicy as JPolicy
from repro.core.fxp import FORMATS as JFORMATS
from repro.core.fxp import quantize as jquantize
from repro.core.qtensor import quantize_tensor as jquantize_tensor
from repro.kernels import dispatch as jdispatch
from repro.kernels.fxp_gemm.fxp_gemm import fxp_gemm_fused_pallas
from repro.kernels.paged_attention import ops as jpa_ops
from repro_torch.core.activation import softmax_lv_stages
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.core.precision import (QuantizedActivation, qmatmul,
                                        quantize_activation)
from repro_torch.core.qtensor import quantize_tensor as tquantize_tensor
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels.fxp_gemm.fxp_gemm import fxp_gemm_fused

AFS = [None, "silu", "sigmoid", "tanh", "gelu", "exp", "relu"]


def _codes(seed, shape):
    return np.random.default_rng(seed).integers(
        -127, 128, size=shape).astype(np.int8)


# ---------------------------------------------------------------------------
# fxp_gemm_fused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("af", AFS)
def test_gemm_plain_matches_pallas(af):
    m, k, n = 8, 256, 256
    x, w = _codes(0, (m, k)), _codes(1, (k, n))
    scale = (np.random.default_rng(2).random((1, n)) * 1e-3
             ).astype(np.float32)
    want = fxp_gemm_fused_pallas(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(scale), af=af, hr_stages=4,
                                 lv_stages=5, interpret=True)
    got = fxp_gemm_fused(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(scale), af=af)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["reference", "kernels"])
@pytest.mark.parametrize("af", [None, "silu"])
def test_dispatch_matmul_quantized_weight_matches_reference(backend, af):
    """Whole plumbing: per-tensor activation quantize over every row, the
    folded f32 scale, the fused AF and its write-back grid, bf16 out."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 96)).astype(np.float32)
    w = (rng.normal(size=(96, 40)) * 0.1).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = jdispatch.matmul(jx, jquantize_tensor(jnp.asarray(w), "fxp8"),
                            JPolicy.flexpe(8), backend="pallas-interpret",
                            af=af)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16)
    got = tdispatch.matmul(tx, tquantize_tensor(torch.from_numpy(w),
                                                "fxp8"),
                           TPolicy.flexpe(8, backend=backend),
                           backend=backend, af=af)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 40)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("backend", ["reference", "kernels"])
@pytest.mark.parametrize("af", [None, "silu"])
def test_shared_activation_quantization_is_bit_identical(backend, af):
    """q/k/v and the SwiGLU gate/up GEMMs reuse one quantized activation:
    the same codes and scale each GEMM would compute on its own."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 3, 64)).astype(np.float32)
                         ).to(torch.bfloat16)
    ws = [tquantize_tensor(torch.from_numpy(
        (rng.normal(size=(64, n)) * 0.1).astype(np.float32)), "fxp8")
        for n in (48, 16)]
    pol = TPolicy.flexpe(8, backend=backend)
    xa = quantize_activation(x, ws[0], pol)
    assert isinstance(xa, QuantizedActivation)
    for w in ws:
        assert torch.equal(qmatmul(xa, w, pol, af=af),
                           qmatmul(x, w, pol, af=af))
    # float weights keep the fake-quant path: nothing to share
    assert quantize_activation(x, torch.ones((64, 8)), pol) is x


def test_gemm_kernels_raise_on_unported_code_paths():
    x = torch.zeros((2, 16))
    packed = tquantize_tensor(torch.ones((16, 8)), "fxp4")
    with pytest.raises(NotImplementedError, match="queue 2, item 7"):
        tdispatch.matmul(x, packed, TPolicy.edge4(backend="kernels"),
                         backend="kernels")


# ---------------------------------------------------------------------------
# paged_attention_float
# ---------------------------------------------------------------------------

B, KVH, G, HD, BS, MB, NB = 3, 2, 2, 32, 4, 4, 8


def _pools(quant, seed=0):
    """Row 0 holds blocks [3, 1] (6 tokens), row 1 SHARES block 3 and adds
    [2, 5] (10 tokens), row 2 is idle (all sentinel, length 0); unused
    table slots hold the sentinel NB."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, KVH * G, HD)).astype(np.float32)
    kf = rng.normal(size=(NB, BS, KVH, HD)).astype(np.float32)
    vf = rng.normal(size=(NB, BS, KVH, HD)).astype(np.float32)
    tables = np.full((B, MB), NB, np.int32)
    tables[0, :2] = [3, 1]
    tables[1, :3] = [3, 2, 5]
    lengths = np.array([6, 10, 0], np.int32)
    n_valid = np.array([1, 1, 0], np.int32)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    if quant:
        fmt = JFORMATS["fxp8"]
        kc, ks = jquantize(jnp.asarray(kf), fmt, axis=3)
        vc, vs = jquantize(jnp.asarray(vf), fmt, axis=3)
        pools = (kc, vc, ks, vs)
    else:
        fmt = None
        pools = (jnp.asarray(kf).astype(jnp.bfloat16),
                 jnp.asarray(vf).astype(jnp.bfloat16), None, None)
    return jq, pools, tables, lengths, lengths + n_valid, fmt


def _t(a):
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("policy_name", ["flexpe8", "bf16"])
def test_paged_attention_plain_matches_pallas(policy_name):
    quant = policy_name == "flexpe8"
    jpol = JPolicy.flexpe(8) if quant else JPolicy.bf16()
    jq, (kc, vc, ks, vs), tables, lengths, kv_valid, fmt = _pools(quant)
    want = jpa_ops.paged_attention(
        jq, kc, vc, ks, vs, jnp.asarray(tables),
        lengths=jnp.asarray(lengths), kv_valid=jnp.asarray(kv_valid),
        positions=jnp.asarray(lengths)[:, None], fmt=fmt, policy=jpol,
        interpret=True)
    tpol = TPolicy.flexpe(8) if quant else TPolicy.bf16()
    got = tdispatch.paged_attention(
        _t(jq), _t(kc), _t(vc), _t(ks), _t(vs), _t(tables), tpol,
        "kernels", lengths=_t(lengths), kv_valid=_t(kv_valid),
        positions=_t(lengths)[:, None],
        fmt=None if fmt is None else "fxp8", int_attention=False)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 1, KVH * G, HD)
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert np.isfinite(got).all()
    # 1 bf16 ulp (2^-7 relative) of the output; under CORDIC the LV
    # divide resolves 2^-lv of max(|o|, den) in the scaled domain
    lv = softmax_lv_stages(MB * BS, "fxp8")
    atol = (2.0 ** -(lv - 1) * np.abs(want).max()) if quant else 1e-6
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=atol)


def test_paged_attention_reference_backend_is_plain():
    jq, (kc, vc, ks, vs), tables, lengths, kv_valid, _ = _pools(True)
    args = (_t(jq), _t(kc), _t(vc), _t(ks), _t(vs), _t(tables))
    kw = dict(lengths=_t(lengths), kv_valid=_t(kv_valid),
              positions=_t(lengths)[:, None], fmt="fxp8",
              int_attention=False)
    pol = TPolicy.flexpe(8)
    ref = tdispatch.paged_attention(*args, pol, "reference", **kw)
    ker = tdispatch.paged_attention(*args, pol, "kernels", **kw)
    assert torch.equal(ref, ker)       # CPU tensors: the same plain code
    with pytest.raises(NotImplementedError, match="queue 2, item 5"):
        tdispatch.paged_attention(*args, pol, "kernels",
                                  **dict(kw, int_attention=True))
