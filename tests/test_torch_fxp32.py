"""PyTorch port, slice 10: the fused GEMM's mode for FxP24/FxP32 codes in
int32 (the PE's 1X FxP32 mode) and the model under `flexpe(32)`, port
against the JAX reference package on the same seeded inputs (CPU).

  * The exact sum of int32 code products reaches ~2^76 (K 13824), past
    int64 and f64. The plain version (`limb_matmul`) sums 16-bit halves
    of the codes in f64 slices that stay exact and combines them in two
    int64 limbs; `limbs_to_f32` rounds the sum once to f32, to nearest
    even. Held bit for bit against Python integers and an integer RNE, at
    codes of +-(2^31 - 1) and -2^31 (not exact in f32), at sums past 2^64
    and at f32 ties past 2^63. The kernel (csrc/fxp_gemm.cu, x32) rounds
    the same exact sum once, so it is bit-equal to this plain version
    (tests/test_torch_cuda.py and chip_smoke.py on the card).
  * Against `fxp_gemm_fused_pallas(..., interpret=True)`, whose f32
    accumulator rounds every code and every partial sum: within 1e-6 of
    the output range, with and without each fused AF (observed at
    4 x 512 x 256: at most 3.0e-7 of the range; sigmoid, tanh and exp
    equal).
  * `core.fxp.quantize` at FxP32 saturates as XLA's cast does (the CPU's
    f32 -> int32 cast wraps 2^31 to -2^31): the reference's codes at both
    range ends for `quantize`, `quantize_tensor` and the KV codes with
    their mod-256 wrap into the int8 pool; FxP24 codes are exact in f32
    and unchanged.
  * `dispatch.matmul` and `expert_matmul` at FxP24 and FxP32: the port's
    two backends bit-equal (the kernel op's contract on both), within
    1e-6 of the output range of the reference's Pallas backend.
  * Reduced Qwen2.5-14B under `flexpe(32)`: a prefill block and a greedy
    decode step within 2% of the logit range of the reference's eager
    `decode_step` (its plain backend runs an f32 dot of fake-quantized
    operands; observed: 0.54% on both port backends, about one bf16 step
    of the largest logit), the same greedy tokens; the paged engine's
    greedy tokens equal the reference engine's (run with copied uploads,
    as tests/test_torch_serving.py does, on a prompt draw without
    near-ties); one model step under `flexpe(24)`. The eager reference
    matters: jitted, XLA's reciprocal scale moves FxP32 KV codes, whose
    low byte is all the int8 pool keeps (1.1% of the logit range)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import PrecisionPolicy as JPolicy
from repro.core.fxp import FORMATS as JFORMATS
from repro.core.fxp import quantize as jquantize
from repro.core.precision import qmatmul as jqmatmul
from repro.core.qtensor import quantize_params as jquantize_params
from repro.core.qtensor import quantize_tensor as jquantize_tensor
from repro.kernels import dispatch as jdispatch
from repro.kernels.fxp_gemm.fxp_gemm import fxp_gemm_fused_pallas
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving.executor import ModelExecutor as JExecutor
from repro_torch.convert import from_numpy_tree
from repro_torch.core.activation import default_stages
from repro_torch.core.fxp import FORMATS as TFORMATS
from repro_torch.core.fxp import quantize as tquantize
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.core.precision import (QuantizedActivation,
                                        quantize_activation)
from repro_torch.core.qtensor import quantize_tensor as tquantize_tensor
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels.fxp_gemm.fxp_gemm import (FUSED_AFS, fxp_gemm_fused,
                                                   limb_matmul, limbs_to_f32,
                                                   x32_split)
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving import Request, ServingEngine
from test_torch_edge import _f32, _t
from test_torch_serving import _race_free_flush, numpy_tree

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def _f32_of_int(v: int) -> np.float32:
    """The integer v rounded once to f32, to nearest even, in integer
    arithmetic (float(v) would round to f64 first: twice)."""
    n = abs(v)
    if n >= 1 << 24:
        shift = n.bit_length() - 24
        q, rem = divmod(n, 1 << shift)
        half = 1 << (shift - 1)
        if rem > half or (rem == half and q & 1):
            q += 1
        n = q << shift
    return np.float32(-n if v < 0 else n)


def _exact(x, w):
    """Python-int product of int codes [M, K] @ [K, N] -> nested lists."""
    x, w = x.astype(object), w.astype(object)
    return (x @ w).tolist()


def _ends(rng, shape):
    """int32 codes, half of them at the range ends and near them."""
    ends = np.array([I32_MAX, I32_MIN, I32_MIN + 1, I32_MAX - 1, 0, 1, -1],
                    np.int64)
    codes = rng.integers(I32_MIN, I32_MAX, shape, endpoint=True)
    pick = rng.random(shape) < 0.5
    return np.where(pick, ends[rng.integers(0, len(ends), shape)],
                    codes).astype(np.int32)


# ---------------------------------------------------------------------------
# the exact int32 product, rounded once
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(3, 1, 5), (4, 17, 6), (2, 300, 3),
                                   (5, 1000, 4)])
def test_limb_matmul_is_the_exact_sum_rounded_once(m, k, n):
    rng = np.random.default_rng(k)
    x, w = _ends(rng, (m, k)), _ends(rng, (k, n))
    hi, lo = limb_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert hi.dtype == lo.dtype == torch.int64
    assert ((lo >= 0) & (lo < 1 << 32)).all()
    want = _exact(x, w)
    got = (hi.numpy().astype(object) * (1 << 32) + lo.numpy()).tolist()
    assert got == want
    np.testing.assert_array_equal(
        limbs_to_f32(hi, lo).numpy(),
        np.array([[_f32_of_int(v) for v in row] for row in want]))


def test_limb_matmul_past_2_to_the_64_and_at_f32_ties():
    """Sums of -2^31 * -2^31 over K 40 (10 * 2^64) and +-(2^31 - 1)^2;
    then sums built at f32 ties past 2^63 (2^64 + 2^40 lies halfway
    between 2^64 and 2^64 + 2^41, 2^64 + 3 * 2^40 between 2^64 + 2^41 and
    2^64 + 2^42) and one off each: ties go to even, the others to the
    nearer."""
    k = 40
    x = np.full((3, k), I32_MIN, np.int32)
    x[1] = I32_MAX
    x[2, ::2] = I32_MAX
    w = np.full((k, 2), I32_MIN, np.int32)
    w[:, 1] = I32_MAX
    hi, lo = limb_matmul(torch.from_numpy(x), torch.from_numpy(w))
    want = _exact(x, w)
    assert want[0][0] == k << 62 and abs(want[0][0]) > 1 << 64
    np.testing.assert_array_equal(
        limbs_to_f32(hi, lo).numpy(),
        np.array([[_f32_of_int(v) for v in row] for row in want]))
    # four products -2^31 * -2^31 (2^64), then 2^10 * 2^30 (or 3 * 2^40 as
    # 3 * 2^10 * 2^30), then d * 1
    rows = [[I32_MIN] * 4 + [mid << 10, d] for mid in (1, 3)
            for d in (-1, 0, 1)]
    x = np.array(rows, np.int64)
    w = np.array([I32_MIN] * 4 + [1 << 30, 1], np.int64)[:, None]
    hi, lo = limb_matmul(torch.from_numpy(x.astype(np.int32)),
                         torch.from_numpy(w.astype(np.int32)))
    sums = _exact(x, w)
    assert [s[0] - (1 << 64) for s in sums] == [
        (1 << 40) - 1, 1 << 40, (1 << 40) + 1,
        (3 << 40) - 1, 3 << 40, (3 << 40) + 1]
    got = limbs_to_f32(hi, lo).numpy()[:, 0]
    want = [2.0 ** 64, 2.0 ** 64, 2.0 ** 64 + 2.0 ** 41,
            2.0 ** 64 + 2.0 ** 41, 2.0 ** 64 + 2.0 ** 42,
            2.0 ** 64 + 2.0 ** 42]
    np.testing.assert_array_equal(got, np.array(want, np.float32))
    np.testing.assert_array_equal(
        limbs_to_f32(-hi - (lo > 0).long(), ((1 << 32) - lo) % (1 << 32)
                     ).numpy()[:, 0], -np.array(want, np.float32))


def test_x32_split_bounds():
    """The kernel's K slices: a multiple of its 128-row warp step, at most
    32768 rows (its int64 half sums stay exact), enough slices to fill
    the card at the decode shapes."""
    for m, k, n in [(4, 5120, 5120), (4, 5120, 1024), (4, 5120, 13824),
                    (4, 13824, 5120), (4, 5120, 152064), (16, 5120, 5120),
                    (4, 100000, 64), (1, 96, 8)]:
        kps = x32_split(m, k, n)
        assert kps % 128 == 0 and 128 <= kps <= 32768
        tiles = -(-n // 128) * -(-m // 4)
        assert tiles * -(-k // kps) >= min(132, tiles * -(-k // 128))


# ---------------------------------------------------------------------------
# the fused plain version against the reference's Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["fxp24", "fxp32"])
@pytest.mark.parametrize("af", (None,) + FUSED_AFS)
def test_x32_plain_within_f32_rounding_of_pallas(fmt, af):
    bits = TFORMATS[fmt].bits
    q = TFORMATS[fmt].qmax
    rng = np.random.default_rng(bits + len(af or ""))
    m, k, n = 4, 512, 128
    x = rng.integers(-q - 1, q, (m, k), endpoint=True).astype(np.int32)
    w = rng.integers(-q - 1, q, (k, n), endpoint=True).astype(np.int32)
    x[0, :8], w[:8, 0], x[1, :4], w[:4, 1] = -q - 1, -q - 1, q, q
    scale = (rng.random((1, n)) * 2 / (float(q) ** 2 * np.sqrt(k))
             ).astype(np.float32)
    hr, lv = default_stages(fmt)
    want = np.asarray(fxp_gemm_fused_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), af=af,
        hr_stages=hr, lv_stages=lv, blocks=(m, 128, 128), interpret=True))
    got = fxp_gemm_fused(_t(x), _t(w), _t(scale), af=af, hr_stages=hr,
                         lv_stages=lv)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    if af is None:
        exact = np.array([[_f32_of_int(v) for v in row]
                          for row in _exact(x, w)])
        np.testing.assert_array_equal(got.numpy(), exact * scale)


# ---------------------------------------------------------------------------
# the FxP32 quantize saturates as the reference's does
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["fxp24", "fxp32"])
def test_quantize_range_ends_match_reference(fmt):
    """x = [1, -1, 0.5, 0.3]: at FxP32, 1 / scale rounds to 2^31 in f32,
    which the reference saturates to 2^31 - 1 (the CPU's cast would give
    -2^31); -1 gives -2^31. Random rows, per axis, too."""
    rng = np.random.default_rng(21)
    for x, axis in ((np.array([1, -1, 0.5, 0.3], np.float32), None),
                    (rng.normal(size=(6, 40)).astype(np.float32), None),
                    (rng.normal(size=(6, 40)).astype(np.float32), 1),
                    (rng.normal(size=(3, 5, 2, 8)).astype(np.float32), 3)):
        codes, scale = jquantize(jnp.asarray(x), JFORMATS[fmt], axis=axis)
        tcodes, tscale = tquantize(torch.from_numpy(x), TFORMATS[fmt],
                                   axis=axis)
        assert tcodes.dtype == torch.int32
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))
        np.testing.assert_array_equal(tscale.numpy(), np.asarray(scale))
    codes = tquantize(torch.tensor([1.0, -1.0, 0.5, 0.3]), TFORMATS[fmt])[0]
    if fmt == "fxp32":
        assert codes.tolist() == [I32_MAX, I32_MIN, 1 << 30, 644245120]
    else:
        assert codes.tolist() == [8388607, -8388607, 4194304, 2516582]


@pytest.mark.parametrize("fmt", ["fxp24", "fxp32"])
def test_quantize_tensor_int32_round_trip(fmt):
    """Per-channel quantize-once weights at FxP24/32: int32 codes and
    scales bit-equal to the reference's (each channel's largest code at
    qmax), carried by the conversion of the JAX tree; `codes()`,
    `layer()` and `dequantize()` keep them."""
    rng = np.random.default_rng(22)
    w = rng.normal(size=(2, 48, 24)).astype(np.float32)
    jw = jquantize_tensor(jnp.asarray(w), fmt)
    tw = tquantize_tensor(torch.from_numpy(w), fmt)
    cw = from_numpy_tree(numpy_tree(jw))
    for q in (tw, cw):
        assert q.data.dtype == torch.int32 and not q.packed
        np.testing.assert_array_equal(q.data.numpy(), np.asarray(jw.data))
        np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jw.scale))
        assert torch.equal(q.codes(), q.data)
        assert torch.equal(q.layer(1).data, q.data[1])
        if fmt == "fxp32":     # amax / scale is +-2^31 in f32: saturated
            assert ((q.data.amax(dim=1) == I32_MAX)
                    | (q.data.amin(dim=1) == I32_MIN)).all()
        np.testing.assert_array_equal(
            q.layer(0).dequantize().numpy(),
            np.asarray(jw.data[0].astype(jnp.float32) * jw.scale[0]))


def _wrap(codes):
    return ((np.asarray(codes).astype(np.int64) + 128) % 256 - 128)


def test_fxp32_kv_codes_wrap_mod_256_in_both_packages():
    """FxP32 K/V codes land in the int8 pool mod 256 on both packages'
    paged and contiguous writes: 2^31 - 1 -> -1, -2^31 -> 0, as the
    reference's FxP16 cache wraps (ROADMAP.md queue 3)."""
    rng = np.random.default_rng(23)
    kf = rng.normal(size=(2, 3, 2, 8)).astype(np.float32)
    kf[0, 0, 0, 0] = 1e3                  # one row's amax, positive
    kf[1, 1, 1, 3] = -1e3                 # and one negative
    codes, scale = jquantize(jnp.asarray(kf), JFORMATS["fxp32"], axis=3)
    tcodes, tscale = tquantize(torch.from_numpy(kf), TFORMATS["fxp32"],
                               axis=3)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(scale))
    assert int(codes[0, 0, 0, 0]) == I32_MAX
    assert int(codes[1, 1, 1, 3]) == I32_MIN
    tables = np.array([[2, 0, 6], [1, 3, 6]], np.int32)
    start = np.array([0, 1], np.int32)
    count = np.array([3, 2], np.int32)
    pool = np.zeros((6, 2, 2, 8), np.int8)
    want = JL.paged_cache_update(jnp.asarray(pool), codes,
                                 jnp.asarray(tables), jnp.asarray(start),
                                 jnp.asarray(count))
    got = TL.paged_cache_update(torch.from_numpy(pool.copy()), tcodes,
                                torch.from_numpy(tables),
                                torch.from_numpy(start),
                                torch.from_numpy(count))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(want)[2, 0],
                                  _wrap(np.asarray(codes)[0, 0]))
    assert np.asarray(want)[2, 0, 0, 0] == -1            # 2^31 - 1
    buf = np.zeros((2, 6, 2, 8), np.int8)
    want = JL.ragged_cache_update(jnp.asarray(buf), codes, jnp.asarray(start),
                                  jnp.asarray(count))
    got = TL.ragged_cache_update(torch.from_numpy(buf.copy()), tcodes,
                                 torch.from_numpy(start),
                                 torch.from_numpy(count))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.asarray(want)[1, 2, 1, 3] == 0             # -2^31
    np.testing.assert_array_equal(np.asarray(want)[1, 1:3],
                                  _wrap(np.asarray(codes)[1, :2]))


# ---------------------------------------------------------------------------
# quantize_activation, dispatch.matmul and expert_matmul at FxP24/32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["fxp24", "fxp32"])
def test_quantize_activation_int32_bit_equal(fmt):
    rng = np.random.default_rng(24)
    x = jnp.asarray(rng.normal(size=(2, 3, 96)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    w = jquantize_tensor(jnp.asarray(rng.normal(size=(96, 40)).astype(
        np.float32)), fmt)
    tw = from_numpy_tree(numpy_tree(w))
    pol = TPolicy.flexpe(TFORMATS[fmt].bits)
    xa = quantize_activation(_t(x), tw, pol)
    assert isinstance(xa, QuantizedActivation)
    assert xa.codes.dtype == torch.int32 and xa.lead == (2, 3)
    codes, scale = jquantize(x.reshape(-1, 96).astype(jnp.float32),
                             JFORMATS[fmt])
    np.testing.assert_array_equal(xa.codes.numpy(), np.asarray(codes))
    np.testing.assert_array_equal(xa.scale.numpy(), np.asarray(scale))
    for be in ("reference", "kernels"):
        bpol = TPolicy.flexpe(TFORMATS[fmt].bits, backend=be)
        assert torch.equal(tdispatch.matmul(xa, tw, bpol, backend=be),
                           tdispatch.matmul(_t(x), tw, bpol, backend=be))


@pytest.mark.parametrize("fmt", ["fxp24", "fxp32"])
@pytest.mark.parametrize("af", [None, "silu"])
def test_dispatch_matmul_backends_agree_and_match_reference(fmt, af):
    rng = np.random.default_rng(25)
    x = jnp.asarray(rng.normal(size=(2, 3, 160)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    w = jquantize_tensor(jnp.asarray((rng.normal(size=(160, 72)) * 0.1
                                      ).astype(np.float32)), fmt)
    tw = from_numpy_tree(numpy_tree(w))
    bits = TFORMATS[fmt].bits
    got = {be: tdispatch.matmul(_t(x), tw, TPolicy.flexpe(bits, backend=be),
                                backend=be, af=af).float().numpy()
           for be in ("reference", "kernels")}
    np.testing.assert_array_equal(got["reference"], got["kernels"])
    want = _f32(jqmatmul(x.astype(jnp.float32), w,
                         JPolicy.flexpe(bits, backend="pallas-interpret"),
                         af=af))
    # the port's bf16 result against the reference's f32 one: the bf16
    # rounding of the output, plus f32 roundings of the sum
    np.testing.assert_allclose(got["kernels"], want, rtol=2 ** -8,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("fmt", ["fxp24", "fxp32"])
def test_expert_matmul_per_expert_on_x32_matches_reference(fmt):
    """An FxP24/32 expert bank runs per expert, as the reference loops
    it: the port's backends bit-equal, within 1e-6 of the output range of
    the reference's Pallas backend."""
    rng = np.random.default_rng(26)
    e, c, k, n = 3, 4, 64, 40
    x = jnp.asarray(rng.normal(size=(1, e, c, k)).astype(np.float32))
    x = x.at[0, 1].set(0.0)               # an expert no token routes to
    bank = jquantize_tensor(jnp.asarray((rng.normal(size=(e, k, n)) * 0.1
                                         ).astype(np.float32)), fmt)
    tbank = from_numpy_tree(numpy_tree(bank))
    bits = TFORMATS[fmt].bits
    got = {be: tdispatch.expert_matmul(
        _t(x), tbank, TPolicy.flexpe(bits, backend=be), backend=be).numpy()
        for be in ("reference", "kernels")}
    np.testing.assert_array_equal(got["reference"], got["kernels"])
    want = _f32(jdispatch.expert_matmul(
        x, bank, JPolicy.flexpe(bits, backend="pallas-interpret"),
        "pallas-interpret"))
    np.testing.assert_allclose(got["kernels"], want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert (got["kernels"][0, 1] == 0).all()


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_decode_attention_on_wrapped_fxp32_pools_matches_reference(backend):
    """Decode attention over pools of wrapped FxP32 codes under
    `flexpe(32)` (the CORDIC softmax at FxP32's 8 HR stages and its LV
    stages for the row): the port on both backends against the
    reference's Pallas backend, within 1% of the output range."""
    rng = np.random.default_rng(27)
    b, kvh, g, hd, bs, nb = 3, 2, 3, 16, 4, 9
    fmt = JFORMATS["fxp32"]
    kc, ks = jquantize(jnp.asarray(rng.normal(size=(nb, bs, kvh, hd))
                                   .astype(np.float32)), fmt, axis=3)
    vc, vs = jquantize(jnp.asarray(rng.normal(size=(nb, bs, kvh, hd))
                                   .astype(np.float32)), fmt, axis=3)
    kc, vc = kc.astype(jnp.int8), vc.astype(jnp.int8)      # the pool's cast
    q = jnp.asarray(rng.normal(size=(b, 1, kvh * g, hd)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    tables = np.array([[3, 1, nb], [4, 0, 5], [nb, nb, nb]], np.int32)
    lengths = np.array([6, 10, 0], np.int32)
    kv_valid = lengths + np.array([1, 1, 0], np.int32)
    pos = lengths[:, None]
    want = _f32(jdispatch.paged_attention(
        q, kc, vc, ks, vs, jnp.asarray(tables),
        JPolicy.flexpe(32, backend="pallas-interpret"), "pallas-interpret",
        lengths=jnp.asarray(lengths), kv_valid=jnp.asarray(kv_valid),
        positions=jnp.asarray(pos), fmt=fmt))
    got = tdispatch.paged_attention(
        _t(q), _t(kc), _t(vc), _t(ks), _t(vs), _t(tables),
        TPolicy.flexpe(32, backend=backend), backend,
        lengths=_t(lengths), kv_valid=_t(kv_valid), positions=_t(pos),
        fmt=TFORMATS["fxp32"]).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


# ---------------------------------------------------------------------------
# reduced Qwen2.5-14B under flexpe(32) and flexpe(24)
# ---------------------------------------------------------------------------

CHUNK, SLOTS, MAX_LEN, BS = 8, 2, 24, 4


def _tables():
    nb = SLOTS * (MAX_LEN // BS)
    t = np.full((SLOTS, MAX_LEN // BS), nb, np.int32)
    t[0] = [5, 0, 3, 7, 9, 11]
    t[1] = [1, 4, 6, 2, 8, 10]
    return t


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen2_5_14b").reduced()
    fp = JM.init_params(cfg, jax.random.PRNGKey(0))
    out = {}
    for fmt in ("fxp32", "fxp24"):
        jparams = jquantize_params(fp, fmt)
        out[fmt] = (jparams, from_numpy_tree(numpy_tree(jparams)))
    return cfg, out


def _reference_steps(cfg, jparams, bits, steps):
    """The reference's ragged prefill block then greedy decode steps,
    eager: [(tokens, n_valid, last-position logits)]."""
    jpol = JPolicy.flexpe(bits)
    jcache = JM.init_cache(cfg, SLOTS, MAX_LEN, jpol, kv_block_size=BS)
    jcache["block_tables"] = jnp.asarray(_tables())
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (SLOTS, CHUNK))
    n_valid = np.array([CHUNK, 5], np.int32)
    out = []
    with jax.disable_jit():
        for _ in range(steps):
            jl, jcache = JM.decode_step(cfg, jparams, jcache,
                                        jnp.asarray(tokens, jnp.int32),
                                        policy=jpol,
                                        n_valid=jnp.asarray(n_valid),
                                        last_only=True)
            jl = _f32(jl)[:, -1, :cfg.vocab]
            out.append((tokens, n_valid, jl))
            tokens = jl.argmax(-1)[:, None].astype(np.int64)
            n_valid = np.ones((SLOTS,), np.int32)
    return out


@pytest.fixture(scope="module")
def reference_steps(model):
    cfg, trees = model
    return _reference_steps(cfg, trees["fxp32"][0], 32, 2)


def _port_steps(cfg, tparams, bits, backend, steps):
    tpol = TPolicy.flexpe(bits, backend=backend)
    tcache = TM.init_cache(cfg, SLOTS, MAX_LEN, tpol, kv_block_size=BS,
                           device="cpu")
    tcache["block_tables"] = torch.from_numpy(_tables())
    for tokens, n_valid, _ in steps:
        tl, tcache = TM.decode_step(cfg, tparams, tcache,
                                    torch.from_numpy(tokens), policy=tpol,
                                    n_valid=torch.from_numpy(n_valid),
                                    last_only=True)
        yield tl.float().numpy()[:, -1, :cfg.vocab], tcache


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_fxp32_prefill_then_greedy_decode_matches_reference(
        model, reference_steps, backend):
    cfg, trees = model
    got = list(_port_steps(cfg, trees["fxp32"][1], 32, backend,
                           reference_steps))
    for step, ((tl, tcache), (_, _, jl)) in enumerate(zip(got,
                                                          reference_steps)):
        np.testing.assert_allclose(tl, jl, rtol=0,
                                   atol=2e-2 * np.abs(jl).max(),
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1),
                                      err_msg=f"step {step}")
    # the pool holds FxP32 codes mod 256: each written (position, head)'s
    # largest code, +-(2^31 - 1) or -2^31, wraps to -1, 1 or 0
    pool = got[0][1]["kv"]["k"][0].numpy().astype(np.int32)
    assert np.abs(pool).max() <= 128


def test_fxp24_model_step_matches_reference(model):
    """One prefill block under `flexpe(24)`, both port backends against
    the reference's eager step."""
    cfg, trees = model
    want = _reference_steps(cfg, trees["fxp24"][0], 24, 1)
    for backend in ("reference", "kernels"):
        (tl, _), = _port_steps(cfg, trees["fxp24"][1], 24, backend, want)
        jl = want[0][2]
        np.testing.assert_allclose(tl, jl, rtol=0,
                                   atol=2e-2 * np.abs(jl).max())
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))


PLENS, GEN = (7, 4, 10), 5
ENGINE_KW = dict(max_slots=2, max_len=16, prefill_chunk=4, kv_block_size=4)


def _prompts(cfg):
    # a prompt draw whose greedy decode meets no near-tie of the top
    # logits in either package (ROADMAP.md queue 3)
    rng = np.random.default_rng(2)
    return [rng.integers(0, cfg.vocab, size=n).tolist() for n in PLENS]


def test_fxp32_paged_engine_matches_reference_engine(model):
    cfg, trees = model
    jparams, tparams = trees["fxp32"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JExecutor, "flush", _race_free_flush(JExecutor.flush))
        eng = JEngine(cfg, jparams, policy=JPolicy.flexpe(32), **ENGINE_KW)
        want = [f.tokens for f in eng.run([
            JRequest(prompt=p, max_new_tokens=GEN, id=i)
            for i, p in enumerate(_prompts(cfg))])]
    for backend in ("reference", "kernels"):
        eng = ServingEngine(cfg, tparams,
                            policy=TPolicy.flexpe(32, backend=backend),
                            device="cpu", **ENGINE_KW)
        done = eng.run([Request(prompt=p, max_new_tokens=GEN, id=i)
                        for i, p in enumerate(_prompts(cfg))])
        eng.check_invariants()
        assert [f.tokens for f in done] == want, backend
