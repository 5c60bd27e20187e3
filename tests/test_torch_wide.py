"""PyTorch port, slice 4: the fused GEMM's mode for codes wider than 8 bits
(FxP12/16 in int16) and the FxP16 tier of the model, port against the JAX
reference package on the same seeded inputs (CPU).

  * The wide mode's plain version sums the code products exactly (f64,
    exact while K * 2^30 < 2^53) and rounds once to f32; the kernel does
    the same, so the two are bit-equal (tests/test_torch_cuda.py on the
    card). Against `fxp_gemm_fused_pallas(..., interpret=True)`:
    - FxP16 codes, K 1024 and 5120: the reference sums in f32 in XLA's
      order (no `wide_exact`, as its serving dispatch calls it), so it is
      held within 1e-5 of the output range (observed: at most 2.3e-7,
      with 85-88% of the outputs differing in their last bits);
    - FxP12 codes at K <= 512 under the reference's `wide_exact` bound
      (K * qmax^2 < 2^31, its int32 accumulator): bit-equal.
  * `quantize_activation` at FxP16: int16 codes and the f32 scale
    bit-equal to the reference's per-tensor `quantize`.
  * `dispatch.matmul` on a quantize-once FxP16 weight: the port's two
    backends bit-equal to each other (the kernel op's contract on both),
    and within 1e-5 of the output range of the reference's Pallas
    backend.
  * The FxP16 KV cache wraps, in both packages: `flexpe(16)` caches K/V
    at FxP16, the pool is int8, and the cache write casts the int16 codes
    to it, so every code is stored mod 256 (a reference defect the port
    mirrors; ROADMAP.md queue 3). Pinned here on both packages' write
    primitives and after a model prefill; both packages' decode attention
    on such pools agree within 1% of the output range (observed: 0).
  * Reduced Qwen2.5-14B under `flexpe(16)`: one prefill block and six
    greedy decode steps within 10% of the logit range of the reference's
    eager `decode_step` (its plain backend, which dequantizes the weight
    and runs an f32 dot of fake-quantized operands: within an f32 rounding
    of the port's exact sums; observed: at most 0.9%), greedy tokens equal."""
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
from repro_torch.convert import from_numpy_tree
from repro_torch.core.fxp import FORMATS as TFORMATS
from repro_torch.core.fxp import quantize as tquantize
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.core.precision import (QuantizedActivation,
                                        quantize_activation)
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels.fxp_gemm.fxp_gemm import (fxp_gemm_fused,
                                                   fxp_gemm_fused_plain)
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from test_torch_edge import _f32, _t
from test_torch_serving import numpy_tree


# ---------------------------------------------------------------------------
# the wide GEMM mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1024, 5120])
@pytest.mark.parametrize("af", [None, "silu"])
def test_wide_gemm_plain_within_f32_rounding_of_pallas(k, af):
    rng = np.random.default_rng(k)
    m, n = 8, 256
    x = rng.integers(-32767, 32768, (m, k)).astype(np.int16)
    w = rng.integers(-32767, 32768, (k, n)).astype(np.int16)
    scale = (rng.random((1, n)) * 1e-9).astype(np.float32)
    want = np.asarray(fxp_gemm_fused_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), af=af,
        hr_stages=4, lv_stages=5, blocks=(m, n, 128), interpret=True))
    got = fxp_gemm_fused(_t(x), _t(w), _t(scale), af=af, hr_stages=4,
                         lv_stages=5)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the exact sum, rounded once: the f64 product of the codes
    exact = (x.astype(np.float64) @ w.astype(np.float64)).astype(np.float32)
    if af is None:
        np.testing.assert_array_equal(got, exact * scale)


@pytest.mark.parametrize("k", [128, 512])
@pytest.mark.parametrize("af", [None, "silu"])
def test_wide_gemm_plain_bit_equal_to_pallas_under_wide_exact(k, af):
    """FxP12 codes (qmax 2047) at K <= 512: K * qmax^2 < 2^31, where the
    reference keeps its int32 accumulator."""
    rng = np.random.default_rng(k + 1)
    m, n = 8, 384
    x = rng.integers(-2047, 2048, (m, k)).astype(np.int16)
    w = rng.integers(-2047, 2048, (k, n)).astype(np.int16)
    scale = (rng.random((1, n)) * 1e-6).astype(np.float32)
    want = fxp_gemm_fused_pallas(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(scale), af=af, hr_stages=4,
                                 lv_stages=5, blocks=(m, 128, 128),
                                 wide_exact=True, interpret=True)
    got = fxp_gemm_fused_plain(_t(x), _t(w), _t(scale), af=af)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_activation_fxp16_bit_equal():
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.normal(size=(2, 3, 96)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    w = jquantize_tensor(jnp.asarray(rng.normal(size=(96, 40)).astype(
        np.float32)), "fxp16")
    tw = from_numpy_tree(numpy_tree(w))
    assert tw.data.dtype == torch.int16
    xa = quantize_activation(_t(x), tw, TPolicy.flexpe(16))
    assert isinstance(xa, QuantizedActivation)
    assert xa.codes.dtype == torch.int16 and xa.lead == (2, 3)
    codes, scale = jquantize(x.reshape(-1, 96).astype(jnp.float32),
                             JFORMATS["fxp16"])
    np.testing.assert_array_equal(xa.codes.numpy(), np.asarray(codes))
    np.testing.assert_array_equal(xa.scale.numpy(), np.asarray(scale))


@pytest.mark.parametrize("af", [None, "silu"])
def test_fxp16_dispatch_matmul_backends_agree_and_match_reference(af):
    rng = np.random.default_rng(12)
    x = jnp.asarray(rng.normal(size=(2, 3, 160)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    w = jquantize_tensor(jnp.asarray((rng.normal(size=(160, 72)) * 0.1
                                      ).astype(np.float32)), "fxp16")
    tw = from_numpy_tree(numpy_tree(w))
    got = {be: tdispatch.matmul(_t(x), tw, TPolicy.flexpe(16, backend=be),
                                backend=be, af=af).float().numpy()
           for be in ("reference", "kernels")}
    np.testing.assert_array_equal(got["reference"], got["kernels"])
    want = _f32(jqmatmul(x.astype(jnp.float32), w,
                         JPolicy.flexpe(16, backend="pallas-interpret"),
                         af=af))
    # the port's bf16 result against the reference's f32 one: the bf16
    # rounding of the output, plus an f32 rounding of the sum
    np.testing.assert_allclose(got["kernels"], want, rtol=2 ** -8,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the FxP16 KV cache wraps mod 256
# ---------------------------------------------------------------------------

def _wrap(codes):
    return ((np.asarray(codes).astype(np.int32) + 128) % 256 - 128)


def test_fxp16_kv_codes_wrap_mod_256_in_both_packages():
    """The int16 codes of FxP16 K/V land in the int8 pool mod 256 on both
    packages' paged and contiguous writes (e.g. 6433 -> 33, -6759 -> -103,
    32767 -> -1), while each position keeps its amax / 32767 scale."""
    rng = np.random.default_rng(13)
    kf = rng.normal(size=(2, 3, 2, 8)).astype(np.float32)
    codes, scale = jquantize(jnp.asarray(kf), JFORMATS["fxp16"], axis=3)
    tcodes, tscale = tquantize(torch.from_numpy(kf), TFORMATS["fxp16"],
                               axis=3)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(scale))
    assert np.asarray(codes).dtype == np.int16
    assert (np.abs(np.asarray(codes)).max(axis=3) == 32767).all()
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
    # row 0's three tokens sit at blocks 2, 2, 0: every stored code is the
    # int16 code mod 256
    np.testing.assert_array_equal(np.asarray(want)[2, 0],
                                  _wrap(np.asarray(codes)[0, 0]))
    np.testing.assert_array_equal(np.asarray(want)[0, 0],
                                  _wrap(np.asarray(codes)[0, 2]))
    buf = np.zeros((2, 6, 2, 8), np.int8)
    want = JL.ragged_cache_update(jnp.asarray(buf), codes, jnp.asarray(start),
                                  jnp.asarray(count))
    got = TL.ragged_cache_update(torch.from_numpy(buf.copy()), tcodes,
                                 torch.from_numpy(start),
                                 torch.from_numpy(count))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(want)[1, 1:3],
                                  _wrap(np.asarray(codes)[1, :2]))
    assert _wrap([6433, -6759, 32767]).tolist() == [33, -103, -1]
    one = torch.zeros(3, dtype=torch.int8)
    one[:] = torch.tensor([6433, -6759, 32767], dtype=torch.int16)
    assert one.tolist() == [33, -103, -1]


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_decode_attention_on_wrapped_fxp16_pools_matches_reference(backend):
    """Decode attention over pools of wrapped FxP16 codes under
    `flexpe(16)` (CORDIC softmax): the port on both backends against the
    reference's Pallas backend, within 1% of the output range."""
    rng = np.random.default_rng(14)
    b, kvh, g, hd, bs, nb = 3, 2, 3, 16, 4, 9
    fmt = JFORMATS["fxp16"]
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
        JPolicy.flexpe(16, backend="pallas-interpret"), "pallas-interpret",
        lengths=jnp.asarray(lengths), kv_valid=jnp.asarray(kv_valid),
        positions=jnp.asarray(pos), fmt=fmt))
    got = tdispatch.paged_attention(
        _t(q), _t(kc), _t(vc), _t(ks), _t(vs), _t(tables),
        TPolicy.flexpe(16, backend=backend), backend,
        lengths=_t(lengths), kv_valid=_t(kv_valid), positions=_t(pos),
        fmt=TFORMATS["fxp16"]).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


# ---------------------------------------------------------------------------
# reduced Qwen2.5-14B under flexpe(16)
# ---------------------------------------------------------------------------

CHUNK, SLOTS, MAX_LEN, BS = 8, 2, 24, 4


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen2_5_14b").reduced()
    jparams = jquantize_params(JM.init_params(cfg, jax.random.PRNGKey(0)),
                               "fxp16")
    return cfg, jparams, from_numpy_tree(numpy_tree(jparams))


@pytest.fixture(scope="module")
def reference_steps(model):
    """The reference's ragged prefill block then six greedy decode steps,
    eager: ([(tokens, n_valid, last-position logits)], layer 0's K pool
    and K scales after the prefill)."""
    cfg, jparams, _ = model
    jpol = JPolicy.flexpe(16)
    jcache = JM.init_cache(cfg, SLOTS, MAX_LEN, jpol, kv_block_size=BS)
    jcache["block_tables"] = jnp.asarray(_tables())
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (SLOTS, CHUNK))
    n_valid = np.array([CHUNK, 5], np.int32)
    steps, pool = [], None
    with jax.disable_jit():
        for _ in range(7):
            jl, jcache = JM.decode_step(cfg, jparams, jcache,
                                        jnp.asarray(tokens, jnp.int32),
                                        policy=jpol,
                                        n_valid=jnp.asarray(n_valid),
                                        last_only=True)
            if pool is None:
                pool = (np.asarray(jcache["kv"]["k"][0]),
                        np.asarray(jcache["kv"]["k_scale"][0]))
            jl = _f32(jl)[:, -1, :cfg.vocab]
            steps.append((tokens, n_valid, jl))
            tokens = jl.argmax(-1)[:, None].astype(np.int64)
            n_valid = np.ones((SLOTS,), np.int32)
    return steps, pool


def _tables():
    nb = SLOTS * (MAX_LEN // BS)
    t = np.full((SLOTS, MAX_LEN // BS), nb, np.int32)
    t[0] = [5, 0, 3, 7, 9, 11]
    t[1] = [1, 4, 6, 2, 8, 10]
    return t


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_fxp16_prefill_then_greedy_decode_matches_reference(
        model, reference_steps, backend):
    cfg, _, tparams = model
    steps, (jk, jks) = reference_steps
    tpol = TPolicy.flexpe(16, backend=backend)
    tcache = TM.init_cache(cfg, SLOTS, MAX_LEN, tpol, kv_block_size=BS,
                           device="cpu")
    tcache["block_tables"] = torch.from_numpy(_tables())
    for step, (tokens, n_valid, jl) in enumerate(steps):
        tl, tcache = TM.decode_step(cfg, tparams, tcache,
                                    torch.from_numpy(tokens), policy=tpol,
                                    n_valid=torch.from_numpy(n_valid),
                                    last_only=True)
        tl = tl.float().numpy()[:, -1, :cfg.vocab]
        np.testing.assert_allclose(tl, jl, rtol=0,
                                   atol=0.1 * np.abs(jl).max(),
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1),
                                      err_msg=f"step {step}")
        if step == 0:
            # after the prefill, layer 0's pool holds FxP16 codes mod 256 in
            # both packages: per written (position, head) the largest code
            # of the row is 32767 -> -1 or -32767 -> 1, so the stored codes
            # dequantize to under 128/32767 of the row's amax
            tk = tcache["kv"]["k"][0].numpy()
            tks = tcache["kv"]["k_scale"][0].numpy()
            written = [(5, 0), (5, 1), (0, 0), (0, 1), (1, 0)]   # blocks
            for k_pool, k_scale in ((tk, tks), (jk, jks)):
                for blk, off in written:
                    codes = k_pool[blk, off].astype(np.int32)   # [KV, hd]
                    assert np.abs(codes).max() <= 128
                    assert (np.abs(codes) == 1).any(axis=-1).all()
                    assert (k_scale[blk, off] > 1e-6).all()
            # the two packages' codes agree mod 256 within one step
            d = _wrap(tk.astype(np.int32) - jk.astype(np.int32))
            assert np.abs(d).max() <= 1
