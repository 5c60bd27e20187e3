"""PyTorch port, the kernels of the serving path against the JAX
reference package's Pallas kernels (interpret mode, CPU).

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
  * cordic_af: the port's op (fake-quant in f32, the plain AF, fake-quant
    out) bit-equal to the reference's `flex_af` on f32 inputs, for every
    kernel AF at precision None and FxP8, and to the reference's jitted
    `cordic_af` op at precision None. At FxP8 the jitted op differs by up
    to an f32 ulp of the output: XLA rewrites the scale's `amax / qmax`
    into `amax * (1 / qmax)` under jit (ROADMAP.md queue 3); the port
    keeps the divide of the eager reference.
  * cordic_softmax: the port's op against the reference's, at 64, 300 and
    4096 columns. The row sum runs in the kernel's fixed order, the
    reference's in XLA's: a sum one ulp apart can move a probability by
    one LV step (2^-lv) and, at FxP8, one step of the output grid. That
    is the stated tolerance; these inputs agree bit for bit.
  * expert_matmul: both port backends bit-equal to the reference's
    per-expert loop on a quantize-once bank, empty expert queues included.

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
from repro.core.activation import flex_af as jflex_af
from repro.core.activation import softmax_lv_stages as jsoftmax_lv_stages
from repro.kernels.cordic_af.ops import cordic_af as jcordic_af
from repro.kernels.cordic_softmax.ops import cordic_softmax as jcordic_softmax
from repro.kernels.fxp_gemm.fxp_gemm import fxp_gemm_fused_pallas
from repro.kernels.paged_attention import ops as jpa_ops
from repro_torch.convert import from_numpy_tree
from repro_torch.core.activation import softmax_lv_stages
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.core.precision import (QuantizedActivation, qmatmul,
                                        quantize_activation)
from repro_torch.core.qtensor import quantize_tensor as tquantize_tensor
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels.cordic_af.cordic_af import KERNEL_AFS, cordic_af
from repro_torch.kernels.cordic_softmax.cordic_softmax import (
    cordic_softmax, warp_row_sum)
from repro_torch.kernels.fxp_gemm.fxp_gemm import (fxp_gemm_fused,
                                                   fxp_gemm_fused_batched)

AFS = [None, "silu", "sigmoid", "tanh", "gelu", "exp", "relu"]


def _codes(seed, shape):
    return np.random.default_rng(seed).integers(
        -127, 128, size=shape).astype(np.int8)


# ---------------------------------------------------------------------------
# fxp_gemm_fused
# ---------------------------------------------------------------------------

# ragged M (row tiles of 8, 16 and 32, and two of 32), K off the 128-row
# stage and N off the 128-column tile of the tensor-core core
RAGGED = [(3, 200, 130), (13, 1030, 384), (20, 96, 1001), (33, 300, 257)]


@pytest.mark.parametrize(
    "m,k,n,af", [pytest.param(8, 256, 256, af, id=str(af)) for af in AFS]
    + [pytest.param(m, k, n, af, id=f"{m}-{k}-{n}-{af}")
       for m, k, n in RAGGED for af in (None, "silu")])
def test_gemm_plain_matches_pallas(m, k, n, af):
    """`fxp_gemm_fused` on int8 CPU tensors (its plain version, which the
    card's kernel equals bit for bit) equals the reference's fused Pallas
    kernel in interpret mode: every AF at 8 x 256 x 256, and SiLU or none
    at ragged shapes, with codes over the whole int8 range and one
    reference block over the whole product."""
    if (m, k, n) == (8, 256, 256):
        x, w = _codes(0, (m, k)), _codes(1, (k, n))
        scale = (np.random.default_rng(2).random((1, n)) * 1e-3
                 ).astype(np.float32)
        blocks = {}
    else:
        rng = np.random.default_rng(m * 11 + k + n)
        x = rng.integers(-128, 128, (m, k)).astype(np.int8)
        w = rng.integers(-128, 128, (k, n)).astype(np.int8)
        scale = (rng.random((1, n)) * 1e-4).astype(np.float32)
        blocks = {"blocks": (m, n, k)}
    want = fxp_gemm_fused_pallas(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(scale), af=af, hr_stages=4,
                                 lv_stages=5, interpret=True, **blocks)
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
    """Every code width now has a kernel mode, so the kernels backend
    refuses no FxP format: FxP24/32 weights (the x32 mode, int32 codes)
    run as a matrix and as an expert bank (per expert) and equal the
    plain path bit for bit, as do FxP16 weights (the wide mode) and packed
    FxP4 expert banks (the packed batched mode). What it still refuses is
    a stacked weight where a per-layer one belongs."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.normal(size=(2, 16)).astype(np.float32))
    xe = torch.from_numpy(rng.normal(size=(1, 3, 2, 16)).astype(np.float32))
    for fmt in ("fxp24", "fxp32"):
        w = torch.from_numpy(rng.normal(size=(3, 16, 8)).astype(np.float32))
        wide, bank = tquantize_tensor(w[0], fmt), tquantize_tensor(w, fmt)
        assert wide.data.dtype == torch.int32
        got = {be: (tdispatch.matmul(x, wide, TPolicy.flexpe(
                        int(fmt[3:]), backend=be), backend=be),
                    tdispatch.expert_matmul(xe, bank, TPolicy.flexpe(
                        int(fmt[3:]), backend=be), backend=be))
               for be in ("kernels", "reference")}
        for a, b in zip(got["kernels"], got["reference"]):
            assert torch.equal(a, b)
        torch.testing.assert_close(got["kernels"][0], x @ w[0], rtol=1e-5,
                                   atol=1e-5)
        with pytest.raises(ValueError, match="2-D"):
            tdispatch.matmul(x, bank, TPolicy.flexpe(int(fmt[3:]),
                                                     backend="kernels"),
                             backend="kernels")
    w16 = tquantize_tensor(torch.ones((16, 8)), "fxp16")
    out = tdispatch.matmul(torch.ones((2, 16)), w16,
                           TPolicy.flexpe(16, backend="kernels"),
                           backend="kernels")
    torch.testing.assert_close(out, torch.full((2, 8), 16.0))
    bank = tquantize_tensor(torch.ones((3, 16, 8)), "fxp4")
    assert bank.packed and bank.ndim == 3
    out = tdispatch.expert_matmul(torch.ones((1, 3, 2, 16)), bank,
                                  TPolicy.edge4(backend="kernels"),
                                  backend="kernels")
    torch.testing.assert_close(out, torch.full((1, 3, 2, 8), 16.0))


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


# Layouts a split of the row must keep, each a change of _pools' rows:
#   sentinel-in-window: row 1's second table slot back to the sentinel
#     inside its window (as clear_table_entry can leave: the position
#     scores exactly 0, it is not masked);
#   mid-block: row 0's window ends one position into its second block,
#     row 1's two into its fourth;
#   one-token: row 2 holds one token in block 0;
#   empty-window: row 2's valid length is 0 over three allocated blocks
#     (every score masked: the mean of V over the table width).
LAYOUTS = ("sentinel-in-window", "mid-block", "one-token", "empty-window")


def _layout(tables, lengths, kv_valid, layout):
    tables, lengths, kv_valid = tables.copy(), lengths.copy(), kv_valid.copy()
    if layout == "sentinel-in-window":
        tables[1, 1] = NB
    elif layout == "mid-block":
        tables[1, 3] = 7
        lengths[:2] = [4, 13]
        kv_valid[:2] = [5, 14]
    elif layout == "one-token":
        tables[2, 0] = 0
        kv_valid[2] = 1
    elif layout == "empty-window":
        tables[2, :3] = [4, 6, 0]
        lengths[2] = 9
    return tables, lengths, kv_valid


def _check_plain_matches_pallas(policy_name, layout=None):
    quant = policy_name == "flexpe8"
    jpol = JPolicy.flexpe(8) if quant else JPolicy.bf16()
    jq, (kc, vc, ks, vs), tables, lengths, kv_valid, fmt = _pools(quant)
    if layout is not None:
        tables, lengths, kv_valid = _layout(tables, lengths, kv_valid, layout)
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
    return got


@pytest.mark.parametrize("policy_name", ["flexpe8", "bf16"])
def test_paged_attention_plain_matches_pallas(policy_name):
    _check_plain_matches_pallas(policy_name)


@pytest.mark.parametrize("policy_name", ["flexpe8", "bf16"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_paged_attention_plain_matches_pallas_layouts(policy_name, layout):
    """The plain version against the Pallas kernel on the layouts that
    the card's cluster kernel is held to against the plain version: the
    semantics of the split, pinned on the CPU."""
    got = _check_plain_matches_pallas(policy_name, layout)
    if layout == "empty-window":
        # every weight equal: the mean of V over the table width, not 0/0
        assert np.abs(got[2]).max() > 0


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
    # integer attention: with the exact softmax the kernel's plain version,
    # with a CORDIC one the gathered composition on both backends
    kw["int_attention"] = True
    for pol in (TPolicy.flexpe(8), TPolicy.flexpe(8, af_impl="exact")):
        assert torch.equal(
            tdispatch.paged_attention(*args, pol, "reference", **kw),
            tdispatch.paged_attention(*args, pol, "kernels", **kw))


# ---------------------------------------------------------------------------
# cordic_af and cordic_softmax
# ---------------------------------------------------------------------------

@pytest.fixture
def flush_denormals():
    # XLA's CPU backend flushes f32 denormals; torch's does not unless
    # asked. Per-thread state: switched back off after the test.
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.mark.parametrize("precision", [None, "fxp8"])
@pytest.mark.parametrize("af", KERNEL_AFS)
def test_cordic_af_bit_equal_to_reference(af, precision, flush_denormals):
    x = (np.random.default_rng(5).normal(size=(16, 200)) * 3
         ).astype(np.float32)
    got = cordic_af(torch.from_numpy(x), af, precision=precision).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jflex_af(jnp.asarray(x), af, precision=precision)))
    want = np.asarray(jcordic_af(jnp.asarray(x), af, precision=precision,
                                 interpret=True))
    if precision is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=np.spacing(np.abs(want).max()))


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_policy_act_snaps_in_f32_on_both_backends(backend):
    """A bf16 activation: both port backends compute the kernel op's
    contract, `flex_af` on the f32 values. The reference's plain backend
    applies `flex_af` to the bf16 values, which snaps on the bf16 grid
    and gives other codes (ROADMAP.md queue 3)."""
    x = jnp.asarray(np.random.default_rng(6).normal(size=(64, 256)) * 3
                    ).astype(jnp.bfloat16)
    want = jflex_af(x.astype(jnp.float32), "silu",
                    precision="fxp8").astype(jnp.bfloat16)
    got = TPolicy.flexpe(8, backend=backend).act(_t(x), "silu")
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    bf16_grid = jflex_af(x, "silu", precision="fxp8")
    assert (np.asarray(bf16_grid.astype(jnp.float32)) != want).any()


@pytest.mark.parametrize("precision", [None, "fxp8"])
@pytest.mark.parametrize("n", [64, 300, 4096])
def test_cordic_softmax_matches_reference(n, precision, flush_denormals):
    x = (np.random.default_rng(n).normal(size=(12, n)) * 2
         ).astype(np.float32)
    got = cordic_softmax(torch.from_numpy(x), precision=precision).numpy()
    want = np.asarray(jcordic_softmax(jnp.asarray(x), precision=precision,
                                      interpret=True))
    lv = jsoftmax_lv_stages(n, precision)
    assert lv == softmax_lv_stages(n, precision)
    tol = 2.0 ** -(lv - 1)
    if precision is not None:
        tol += np.abs(want).max() / JFORMATS[precision].qmax
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=n * tol + 0.05)


def test_softmax_row_sum_order():
    """`warp_row_sum` adds in the kernel's order: 32 lanes each summing
    columns l, l+32, ... in turn from 0, then the xor butterfly."""
    rng = np.random.default_rng(7)
    e = rng.random((3, 100)).astype(np.float32) * rng.choice(
        [1e-3, 1.0, 1e3], size=(3, 100)).astype(np.float32)
    want = np.empty((3,), np.float32)
    for r in range(3):
        lanes = [np.float32(0.0)] * 32
        for j in range(100):
            lanes[j % 32] = np.float32(lanes[j % 32] + e[r, j])
        for off in (16, 8, 4, 2, 1):
            lanes = [np.float32(lanes[i] + lanes[i ^ off]) for i in range(32)]
        assert len(set(lanes)) == 1
        want[r] = lanes[0]
    got = warp_row_sum(torch.from_numpy(e))[:, 0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_policy_softmax_routes(backend):
    """A CORDIC policy's softmax over the last axis: the kernel op on the
    kernels backend, `flex_af` with row-length LV stages otherwise; the
    same probabilities here. An exact policy takes the exact softmax."""
    x = torch.from_numpy((np.random.default_rng(8).normal(size=(2, 5, 64))
                          * 2).astype(np.float32))
    want = jnp.asarray(x.numpy())
    want = JPolicy.flexpe(8).softmax(want, axis=-1)
    got = TPolicy.flexpe(8, backend=backend).softmax(x, axis=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    exact = TPolicy.flexpe(8, af_impl="exact", backend=backend)
    torch.testing.assert_close(exact.softmax(x), torch.softmax(x, -1))


# ---------------------------------------------------------------------------
# MoE expert banks
# ---------------------------------------------------------------------------

def _bank(k, n, e=6, seed=9):
    w = (np.random.default_rng(seed).normal(size=(e, k, n)) * 0.1
         ).astype(np.float32)
    jw = jquantize_tensor(jnp.asarray(w).astype(jnp.bfloat16), "fxp8")
    tw = from_numpy_tree({"data": np.asarray(jw.data),
                          "scale": np.asarray(jw.scale), "fmt": jw.fmt_name,
                          "n": jw.n, "packed": jw.packed})
    return jw, tw


@pytest.mark.parametrize("backend", ["reference", "kernels"])
@pytest.mark.parametrize("k,n", [(64, 40), (40, 64)])
def test_expert_matmul_bit_equal_to_reference(backend, k, n):
    """x [G, E, C, K] with expert 2's queue empty and half of every other
    queue unfilled (zero rows), as a dropless decode batch leaves them."""
    jw, tw = _bank(k, n)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 6, 5, k)).astype(np.float32)
    x[:, :, 3:] = 0.0
    x[:, 2] = 0.0
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = jdispatch.expert_matmul(jx, jw, JPolicy.flexpe(8),
                                   backend="reference")
    before = fxp_gemm_fused.launches
    got = tdispatch.expert_matmul(_t(jx), tw,
                                  TPolicy.flexpe(8, backend=backend),
                                  backend=backend)
    assert fxp_gemm_fused.launches == before     # CPU: no launch
    assert got.dtype == torch.bfloat16 and got.shape == (2, 6, 5, n)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_batched_gemm_plain_is_the_per_expert_loop():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(-127, 128, (4, 7, 96), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (4, 96, 33), dtype=np.int8))
    scale = torch.from_numpy((rng.random((4, 1, 33)) * 1e-3
                              ).astype(np.float32))
    got = fxp_gemm_fused_batched(x, w, scale, af="silu")
    for e in range(4):
        assert torch.equal(got[e], fxp_gemm_fused(x[e], w[e], scale[e],
                                                  af="silu"))
    with pytest.raises(ValueError, match="shape mismatch"):
        fxp_gemm_fused_batched(x, w[:3], scale)
