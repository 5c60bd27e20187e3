"""PyTorch port, slice 3: FxP4 edge serving and integer decode attention,
port against the JAX reference package on the same seeded inputs (CPU).

  * Packed-FxP4 fused GEMM: the port's plain version (nibbles unpacked in
    the lane order of core.simd.pack) against `fxp_gemm_fused_pallas(...,
    packed=True)` in interpret mode, with and without the fused SiLU, at
    ragged N: bit-equal. `dispatch.matmul` under edge4 on a packed
    quantize-once weight, both port backends against the reference's
    `qmatmul` on its Pallas backend: bit-equal.
  * Raw code GEMMs: `fxp_gemm_codes` (int8 and int16 codes) and
    `fxp4_gemm_packed` against `fxp_gemm_pallas` and
    `fxp4_gemm_packed_pallas`: bit-equal.
  * Integer paged attention: `paged_attention_int_plain` against
    `paged_attention_int_pallas` with the exact softmax, on pools with a
    shared block, sentinel table entries and an idle row. The integer dots
    are exact; torch's softmax rounds its f32 sum and exp otherwise than
    XLA's, and a p x v_scale code that flips with that moves the output by
    one v step times the row scale. Tolerance: 1% of the output range
    (largest error seen: 0.0 on these inputs).
  * `int8_decode_attention` on a prefill chunk (Sq > 1), port against
    reference: the same tolerance (largest error seen: 0.0).
  * Integer attention with a CORDIC softmax takes the gathered plain
    composition on both packages' kernel backends. A defect of the
    reference, which the port mirrors: that softmax snaps its input to the
    FxP grid with one per-tensor scale, the -1e30 of the masked positions
    sets that scale, every valid score snaps to 0, and the attention is the
    plain mean of V over the valid positions (ROADMAP.md queue 3). The
    two packages agree within 1% of the output range (largest error seen:
    0.0); the mean of V holds within 2% (largest error seen: 0.0096
    against 0.020), the FxP8 grid of the p x v_scale codes.
  * Reduced Qwen2.5-14B under edge4 (packed FxP4 weights) and under
    integer attention (`flexpe(8, af_impl="exact")` with
    `int_attention=True`): one prefill block and six greedy decode steps
    within 10% of the logit range of the reference's `decode_step`, with
    the same greedy tokens (the engines: tests/test_torch_edge_serving.py).
    The reference runs eagerly (`jax.disable_jit`): compiled, XLA rewrites
    `amax / qmax` of every per-tensor scale into `amax * (1 / qmax)`, and
    at FxP4's seven levels the codes that moves are whole steps of the
    grid (the compiled step's logits differ from its own eager ones by
    more than this tolerance on this model); the port keeps the true
    divide of the eager reference and matches it (ROADMAP.md queue 3)."""
import dataclasses

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
from repro.kernels.fxp_gemm.fxp_gemm import (fxp4_gemm_packed_pallas,
                                             fxp_gemm_fused_pallas,
                                             fxp_gemm_pallas)
from repro.kernels.paged_attention.paged_attention import (
    paged_attention_int_pallas)
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.convert import from_numpy_tree
from repro_torch.core.fxp import FORMATS as TFORMATS
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.core.qtensor import quantize_tensor as tquantize_tensor
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels.fxp_gemm.fxp_gemm import (fxp4_gemm_packed,
                                                   fxp_gemm_codes,
                                                   fxp_gemm_fused,
                                                   unpack_nibbles)
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention_int, paged_attention_int_plain)
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from test_torch_serving import numpy_tree


def _t(a):
    """numpy / JAX array -> torch tensor (bf16 keeps its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# packed-FxP4 fused GEMM
# ---------------------------------------------------------------------------

def test_unpack_nibbles_lane_order():
    """Byte j: element 2j in the low nibble, 2j+1 in the high, each
    sign-extended; the int32 words of a packed weight seen as bytes."""
    b = torch.tensor([[0x7F, -0x80, 0x18, -0x01]], dtype=torch.int8)
    assert unpack_nibbles(b).tolist() == [[-1, 7, 0, -8, -8, 1, -1, -1]]
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, 21)).astype(np.float32))
    qt = tquantize_tensor(w, "fxp4")
    assert torch.equal(unpack_nibbles(qt.data.view(torch.int8), qt.n),
                       qt.codes().to(torch.int8))


@pytest.mark.parametrize("n", [256, 200, 40])
@pytest.mark.parametrize("af", [None, "silu"])
def test_packed_gemm_plain_matches_pallas(af, n):
    rng = np.random.default_rng(n)
    m, k = 8, 256
    x = rng.integers(-8, 8, (m, k)).astype(np.int8)
    wb = rng.integers(-128, 128, (k, n // 2)).astype(np.int8)
    scale = (rng.random((1, n)) * 1e-2).astype(np.float32)
    want = fxp_gemm_fused_pallas(jnp.asarray(x), jnp.asarray(wb),
                                 jnp.asarray(scale), packed=True, af=af,
                                 hr_stages=4, lv_stages=3,
                                 blocks=(m, n, 128), interpret=True)
    got = fxp_gemm_fused(_t(x), _t(wb), _t(scale), af=af, hr_stages=4,
                         lv_stages=3, packed=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["reference", "kernels"])
@pytest.mark.parametrize("af", [None, "silu"])
def test_edge4_dispatch_matmul_matches_reference(backend, af):
    """The whole edge4 plumbing on a packed weight of ragged width: FxP4
    activation codes per tensor, the int32 words as nibble bytes, the
    folded scale, the fused SiLU at FxP4 stages and its FxP4 write-back."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 96)).astype(np.float32)
    w = (rng.normal(size=(96, 44)) * 0.1).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jw = jquantize_tensor(jnp.asarray(w), "fxp4")
    assert jw.packed
    want = jqmatmul(jx, jw, JPolicy.edge4(backend="pallas-interpret"),
                    af=af)
    tw = from_numpy_tree(numpy_tree(jw))
    got = tdispatch.matmul(_t(jx), tw, TPolicy.edge4(backend=backend),
                           backend=backend, af=af)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 44)
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


# ---------------------------------------------------------------------------
# raw code GEMMs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,qmax", [(np.int8, 127), (np.int16, 2047)])
def test_code_gemm_plain_matches_pallas(dtype, qmax):
    """int8 codes, and FxP12 codes in int16 at K = 512, inside the
    reference's overflow-free bound K * qmax^2 < 2^31."""
    rng = np.random.default_rng(qmax)
    x = rng.integers(-qmax, qmax + 1, (16, 512)).astype(dtype)
    w = rng.integers(-qmax, qmax + 1, (512, 136)).astype(dtype)
    want = fxp_gemm_pallas(jnp.asarray(x), jnp.asarray(w),
                           blocks=(16, 136, 128), interpret=True)
    got = fxp_gemm_codes(_t(x), _t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_packed_code_gemm_plain_matches_pallas():
    rng = np.random.default_rng(7)
    x = rng.integers(-8, 8, (8, 384)).astype(np.int8)
    wb = rng.integers(-128, 128, (384, 72)).astype(np.int8)
    want = fxp4_gemm_packed_pallas(jnp.asarray(x), jnp.asarray(wb),
                                   blocks=(8, 144, 128), interpret=True)
    got = fxp4_gemm_packed(_t(x), _t(wb))
    assert got.shape == (8, 144) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# integer paged attention
# ---------------------------------------------------------------------------

B, KVH, G, HD, BS, MB, NB = 4, 2, 3, 32, 4, 5, 11
FMT = "fxp8"


def _pools(seed=0):
    """Row 0 holds blocks [3, 1] (6 tokens), row 1 SHARES block 3 and adds
    [2, 5, 9] (17 tokens), row 2 holds [7, 0, 4, 10, 8] (19 tokens, the
    whole table), row 3 is idle (all sentinel, length 0); unused table
    slots hold the sentinel NB."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, KVH * G, HD)).astype(np.float32)
    kf = rng.normal(size=(NB, BS, KVH, HD)).astype(np.float32)
    vf = rng.normal(size=(NB, BS, KVH, HD)).astype(np.float32)
    tables = np.full((B, MB), NB, np.int32)
    tables[0, :2] = [3, 1]
    tables[1, :4] = [3, 2, 5, 9]
    tables[2] = [7, 0, 4, 10, 8]
    lengths = np.array([6, 17, 19, 0], np.int32)
    kv_valid = lengths + np.array([1, 1, 1, 0], np.int32)
    fmt = JFORMATS[FMT]
    kc, ks = jquantize(jnp.asarray(kf), fmt, axis=3)
    vc, vs = jquantize(jnp.asarray(vf), fmt, axis=3)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    return jq, (kc, vc, ks, vs), tables, lengths, kv_valid


def _tol(want):
    return 1e-2 * np.abs(want).max()


# Layouts a split of the row must keep, each a change of _pools' rows:
#   sentinel-in-window: row 2's third table slot back to the sentinel
#     inside its window (the position scores exactly 0, it is not masked);
#   mid-block: row 0's window ends one position into its second block,
#     row 2's two into its fifth;
#   one-token: row 3 holds one token in block 6;
#   empty-window: row 3's valid length is 0 over three allocated blocks
#     (every score masked: the mean of V over the table width, requantized).
LAYOUTS = ("sentinel-in-window", "mid-block", "one-token", "empty-window")


def _layout(tables, lengths, kv_valid, layout):
    tables, lengths, kv_valid = tables.copy(), lengths.copy(), kv_valid.copy()
    if layout == "sentinel-in-window":
        tables[2, 2] = NB
    elif layout == "mid-block":
        lengths[[0, 2]] = [4, 17]
        kv_valid[[0, 2]] = [5, 18]
    elif layout == "one-token":
        tables[3, 0] = 6
        kv_valid[3] = 1
    elif layout == "empty-window":
        tables[3, :3] = [6, 3, 7]
        lengths[3] = 9
    return tables, lengths, kv_valid


def _check_int_plain_matches_pallas(layout=None):
    jq, (kc, vc, ks, vs), tables, lengths, kv_valid = _pools()
    if layout is not None:
        tables, lengths, kv_valid = _layout(tables, lengths, kv_valid, layout)
    fmt = JFORMATS[FMT]
    meta = np.stack([lengths, kv_valid, lengths], axis=1).astype(np.int32)
    qc, sq = jquantize(jq.astype(jnp.float32) / np.sqrt(HD), fmt, axis=3)
    qc4 = qc[:, 0].reshape(B, KVH, G, HD)
    sq4 = sq[:, 0].reshape(B, KVH, G, 1)
    want = paged_attention_int_pallas(
        qc4, sq4, kc, vc, ks, vs, jnp.asarray(tables), jnp.asarray(meta),
        fmt=fmt, softmax_fn=jax.nn.softmax, out_dtype=jnp.bfloat16,
        interpret=True)
    args = (_t(qc4), _t(sq4), _t(kc), _t(vc), _t(ks), _t(vs), _t(tables),
            _t(meta))
    kw = dict(fmt=TFORMATS[FMT], out_dtype=torch.bfloat16)
    got = paged_attention_int_plain(*args, **kw)
    # on CPU tensors the kernel wrapper runs the plain version, no launch
    before = paged_attention_int.launches
    assert torch.equal(paged_attention_int(*args, **kw), got)
    assert paged_attention_int.launches == before
    got, want = got.float().numpy(), _f32(want)
    assert got.shape == (B, KVH * G, HD) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))
    return got, want


def test_paged_attention_int_plain_matches_pallas():
    got, want = _check_int_plain_matches_pallas()
    # the idle row: sentinel blocks, zero V scales, an exact zero output
    assert (got[3] == 0).all() and (want[3] == 0).all()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_paged_attention_int_plain_matches_pallas_layouts(layout):
    """The plain version against the Pallas kernel on the layouts that
    the card's cluster kernel is held to against the plain version."""
    got, _ = _check_int_plain_matches_pallas(layout)
    if layout == "empty-window":
        # every weight equal: the requantized mean of V, not 0/0
        assert np.abs(got[3]).max() > 0


def test_int8_decode_attention_prefill_chunk_matches_reference():
    """A prefill chunk (Sq = 3) of rows 0-2 over their gathered codes:
    causal inside the chunk, the valid length as the outer bound."""
    jq, (kc, vc, ks, vs), tables, lengths, kv_valid = _pools(seed=1)
    rng = np.random.default_rng(2)
    q = jnp.asarray(rng.normal(size=(3, 3, KVH * G, HD)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    pos = (lengths[:3, None] - 2 + np.arange(3)[None, :]).astype(np.int32)
    tb = jnp.asarray(tables[:3])
    views = [JL.gather_block_kv(a, tb) for a in (kc, vc, ks, vs)]
    jpol = dataclasses.replace(JPolicy.flexpe(8, af_impl="exact"),
                               int_attention=True)
    want = JL.int8_decode_attention(q, *views, JFORMATS[FMT], jpol,
                                    positions=jnp.asarray(pos),
                                    kv_valid_len=jnp.asarray(kv_valid[:3]))
    tpol = dataclasses.replace(TPolicy.flexpe(8, af_impl="exact"),
                               int_attention=True)
    got = TL.int8_decode_attention(_t(q), *map(_t, views), TFORMATS[FMT],
                                   tpol, positions=_t(pos),
                                   kv_valid_len=_t(kv_valid[:3]))
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), _f32(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))


def _int_dispatch(policy_impl, port_backend):
    """(port, reference) integer decode attention through dispatch on the
    kernels / Pallas-interpret backends."""
    jq, (kc, vc, ks, vs), tables, lengths, kv_valid = _pools(seed=2)
    pos = lengths[:, None]
    want = jdispatch.paged_attention(
        jq, kc, vc, ks, vs, jnp.asarray(tables),
        JPolicy.flexpe(8, af_impl=policy_impl, backend="pallas-interpret"),
        "pallas-interpret", lengths=jnp.asarray(lengths),
        kv_valid=jnp.asarray(kv_valid), positions=jnp.asarray(pos),
        fmt=JFORMATS[FMT], int_attention=True)
    got = tdispatch.paged_attention(
        _t(jq), _t(kc), _t(vc), _t(ks), _t(vs), _t(tables),
        TPolicy.flexpe(8, af_impl=policy_impl, backend=port_backend),
        port_backend, lengths=_t(lengths), kv_valid=_t(kv_valid),
        positions=_t(pos), fmt=TFORMATS[FMT], int_attention=True)
    views = [np.asarray(JL.gather_block_kv(a, jnp.asarray(tables)))
             for a in (vc, vs)]
    return got.float().numpy()[:, 0], _f32(want)[:, 0], views, kv_valid


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_int_attention_exact_dispatch_matches_reference(backend):
    got, want, _, _ = _int_dispatch("exact", backend)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_int_attention_cordic_is_mean_of_v_as_in_reference(backend):
    """Integer attention under a CORDIC policy: the gathered composition
    on both packages, within 1% of the output range of each other. Both
    equal the mean of V over the valid positions, within the FxP8 grid of
    the p x v_scale codes (2% of the output range): a defect of the
    reference that the port mirrors, pinned here (ROADMAP.md queue 3)."""
    got, want, (v_codes, v_scale), kv_valid = _int_dispatch("cordic",
                                                            backend)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))
    v = v_codes.astype(np.float32) * v_scale            # [B, S, KV, hd]
    for b in range(3):                                  # row 3 is idle
        mean = v[b, :kv_valid[b]].mean(axis=0)          # [KV, hd]
        mean = np.repeat(mean, G, axis=0)               # [KV * G, hd]
        for out in (got[b], want[b]):
            np.testing.assert_allclose(out, mean, rtol=0,
                                       atol=2 * _tol(want))


# ---------------------------------------------------------------------------
# reduced Qwen2.5-14B: model step and engine under both policies
# ---------------------------------------------------------------------------

POLICIES = {
    "edge4": (JPolicy.edge4, TPolicy.edge4, "fxp4"),
    "int-attention": (
        lambda **kw: dataclasses.replace(
            JPolicy.flexpe(8, af_impl="exact", **kw), int_attention=True),
        lambda **kw: dataclasses.replace(
            TPolicy.flexpe(8, af_impl="exact", **kw), int_attention=True),
        "fxp8"),
}


@pytest.fixture(scope="module", params=sorted(POLICIES))
def model(request):
    jpol_fn, tpol_fn, fmt = POLICIES[request.param]
    cfg = get_config("qwen2_5_14b").reduced()
    jparams = jquantize_params(JM.init_params(cfg, jax.random.PRNGKey(0)),
                               fmt)
    return (request.param, cfg, jparams, from_numpy_tree(numpy_tree(jparams)),
            jpol_fn, tpol_fn)


CHUNK, SLOTS, MAX_LEN, BSZ = 8, 2, 24, 4


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_prefill_then_greedy_decode_matches_reference(model, backend):
    """Tolerance on the logits: 10% of their range per step, as
    tests/test_torch_model.py holds the FxP8 path; greedy tokens equal."""
    name, cfg, jparams, tparams, jpol_fn, tpol_fn = model
    jpol, tpol = jpol_fn(), tpol_fn(backend=backend)
    nb = SLOTS * (MAX_LEN // BSZ)
    tables = np.full((SLOTS, MAX_LEN // BSZ), nb, np.int32)
    tables[0] = [5, 0, 3, 7, 9, 11]
    tables[1] = [1, 4, 6, 2, 8, 10]
    jcache = JM.init_cache(cfg, SLOTS, MAX_LEN, jpol, kv_block_size=BSZ)
    jcache["block_tables"] = jnp.asarray(tables)
    tcache = TM.init_cache(cfg, SLOTS, MAX_LEN, tpol, kv_block_size=BSZ,
                           device="cpu")
    tcache["block_tables"] = torch.from_numpy(tables)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (SLOTS, CHUNK))
    n_valid = np.array([CHUNK, 5], np.int32)
    for step in range(7):
        with jax.disable_jit():
            jl, jcache = JM.decode_step(cfg, jparams, jcache,
                                        jnp.asarray(tokens, jnp.int32),
                                        policy=jpol,
                                        n_valid=jnp.asarray(n_valid),
                                        last_only=True)
        tl, tcache = TM.decode_step(cfg, tparams, tcache,
                                    torch.from_numpy(tokens), policy=tpol,
                                    n_valid=torch.from_numpy(n_valid),
                                    last_only=True)
        jl = _f32(jl)[:, -1, :cfg.vocab]
        tl = tl.float().numpy()[:, -1, :cfg.vocab]
        np.testing.assert_allclose(tl, jl, rtol=0,
                                   atol=0.1 * np.abs(jl).max(),
                                   err_msg=f"{name} step {step}")
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1),
                                      err_msg=f"{name} step {step}")
        tokens = jl.argmax(-1)[:, None].astype(np.int64)
        n_valid = np.ones((SLOTS,), np.int32)
