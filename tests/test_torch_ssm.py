"""PyTorch port, the SSM (Mamba2-370M) and hybrid (Zamba2-1.2B) families:
the port's `models/ssm.py` and the two families' `decode_step` against
the JAX reference on the same converted weights and seeded inputs (CPU).

  * `mamba2_layer` in f32 without a policy, in its three modes
    (cache-less prefill, an S > 1 continuation from a carried state, the
    S = 1 recurrence), with ragged `n_valid` rows: within 1e-5 of the
    output's range (the einsums sum in another order). A row with
    n_valid 0 keeps its state and conv window bit for bit.
  * The chunked SSD does not depend on the chunk size, and equals the
    token-by-token recurrence (1e-5 of the range).
  * `mamba2_layer` under flexpe(8) with quantize-once weights and bf16
    activations: the output, the gate and the conv window are bit-equal
    to the reference's Pallas backend (the SiLU gate is the CORDIC AF op
    on both sides, and the bf16 conv, SiLU and einsums round as XLA
    rounds them); the f32 state within 1e-5 of its range.
  * `decode_step` of the reduced models: a ragged prefill block then two
    greedy decode steps, teacher-forced with the reference's tokens. In
    f32 without a policy the logits are within 1e-4 of their range. Under
    flexpe(8) reduced Mamba2's logits are bit-equal and its state within
    1e-5; reduced Zamba2's logits are within 10% of their range (observed
    at most 2.6%: its attention sums in another order than XLA's, as in
    tests/test_torch_model.py, and FxP8 grids amplify an ulp), its state
    and conv window within 5% of theirs (observed 1.5% and 1.1%, both in
    the last layer), the first shared application's KV codes bit-equal
    (its inputs are) and the second's within 8 FxP8 steps (observed 6,
    in 9% of the codes). Greedy tokens are equal wherever the
    reference's top two logits are further apart than twice the step's
    largest logit difference.

Under a policy the reference runs its Pallas backend (interpret mode),
whose CORDIC AF snaps in f32 as the port's does on both of its backends
(its plain backend snaps bf16 gates on the bf16 grid: ROADMAP.md
queue 3), and eagerly: compiled, XLA rewrites `amax / qmax` of every
per-tensor scale as a multiply, and the compiled reference drifts from
its own eager arithmetic. `eager_reference` keeps the eager arithmetic
but compiles each Pallas entry once (an eager `pallas_call` is already
one compiled computation; the entries hold nothing else but exact casts
and reshapes), which the first test of this file holds bit-equal to the
plainly eager run.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.cordic_af.ops as jafops
import repro.kernels.cordic_softmax.ops as jsmops
import repro.kernels.dispatch as jdisp
from repro.configs import get_config as jget_config
from repro.core import PrecisionPolicy as JPolicy
from repro.core.qtensor import quantize_params as jquantize_params
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from test_torch_model import numpy_tree

JPAL = JPolicy.flexpe(8, backend="pallas-interpret")
FAMILIES = ("mamba2_370m", "zamba2_1p2b")


# ---------------------------------------------------------------------------
# the eager reference, its Pallas entries compiled once
# ---------------------------------------------------------------------------

def _compiled_once(fn, **static):
    jitted = jax.jit(fn, **static)

    def run(*a, **kw):
        with jax.disable_jit(False):
            return jitted(*a, **kw)
    return run


_GEMM = _compiled_once(jdisp.fxp_gemm_fused_pallas, static_argnames=(
    "packed", "af", "hr_stages", "lv_stages", "blocks", "wide_exact",
    "interpret"))
_AF = _compiled_once(jafops.cordic_af_pallas, static_argnums=(1, 2, 3),
                     static_argnames=("repeat_iters", "block", "interpret"))
_SOFTMAX = _compiled_once(jsmops.cordic_softmax_pallas,
                          static_argnums=(1, 2),
                          static_argnames=("block_rows", "interpret"))
_ATTN_EAGER = jdisp._paged_attn_pallas
_ATTN = _compiled_once(_ATTN_EAGER, static_argnames=(
    "fmt", "int_attention", "policy", "interpret"))


def _attention(*a, int_attention=False, **kw):
    # the float path is meta, reshapes and the pallas_call; the integer
    # path quantizes q outside the kernel, so it stays eager
    if int_attention:
        return _ATTN_EAGER(*a, int_attention=True, **kw)
    return _ATTN(*a, int_attention=False, **kw)


@contextlib.contextmanager
def eager_reference():
    """The reference under `jax.disable_jit`, each Pallas entry (the fused
    GEMM, both CORDIC ops, the float paged attention) compiled once per
    shape instead of at every call."""
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jdisp, "fxp_gemm_fused_pallas", _GEMM)
        mp.setattr(jafops, "cordic_af_pallas", _AF)
        mp.setattr(jsmops, "cordic_softmax_pallas", _SOFTMAX)
        mp.setattr(jdisp, "_paged_attn_pallas", _attention)
        yield


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_pair(x):
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return j, torch.from_numpy(_np(j)).to(torch.bfloat16)


def _close(got, want, rel, what):
    got, want = _np(got), _np(want)
    span = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * span, f"{what}: max |err| {err} > {rel} x {span}"
    return err / span


@pytest.fixture(scope="module")
def f32_layer():
    cfg = jget_config("mamba2_370m").reduced()
    jp = JS.ssm_init(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    return cfg, jp, from_numpy_tree(numpy_tree(jp))


def _state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    st = rng.normal(size=(b, cfg.ssm_nheads, cfg.ssm_headdim,
                          cfg.ssm_state)).astype(np.float32)
    cv = rng.normal(size=(b, cfg.conv_width - 1, TS.conv_channels(cfg))
                    ).astype(np.float32)
    return st, cv


# ---------------------------------------------------------------------------
# the harness itself
# ---------------------------------------------------------------------------

def test_eager_reference_harness_is_bit_equal_to_eager():
    """Each patched entry, called through the reference's dispatch as its
    models call it, gives the same bits compiled once as plainly eager:
    the fused GEMM with and without its GELU epilogue, the CORDIC AF and
    softmax ops, the float paged attention over an int8 pool."""
    from repro.core.fxp import FORMATS
    from repro.core.qtensor import quantize_tensor
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(3, 40)), jnp.bfloat16)
    w = quantize_tensor(jnp.asarray(rng.normal(size=(40, 24)), jnp.float32),
                        "fxp8")
    z = jnp.asarray(rng.normal(size=(2, 5, 24)) * 3, jnp.bfloat16)
    logits = jnp.asarray(rng.normal(size=(4, 8)), jnp.float32)
    q = jnp.asarray(rng.normal(size=(2, 1, 4, 32)), jnp.bfloat16)
    pool = jnp.asarray(rng.integers(-127, 128, (6, 4, 2, 32)), jnp.int8)
    scales = jnp.asarray(rng.random((6, 4, 2, 1)) * 0.02, jnp.float32)
    tables = jnp.asarray([[3, 0, 6], [1, 5, 6]], jnp.int32)
    lens = jnp.asarray([6, 3], jnp.int32)
    be = "pallas-interpret"

    def calls():
        return [jdisp.matmul(x, w, JPAL, be),
                jdisp.matmul(x, w, JPAL, be, af="gelu"),
                jdisp.act(z, "silu", JPAL, be),
                jdisp.softmax(logits, JPAL, be),
                jdisp.paged_attention(
                    q, pool, pool, scales, scales, tables, JPAL, be,
                    lengths=lens, kv_valid=lens + 1, positions=lens[:, None],
                    fmt=FORMATS["fxp8"])]
    with eager_reference():
        cached = [_np(a) for a in calls()]
    with jax.disable_jit():
        eager = [_np(a) for a in calls()]
    for a, b in zip(cached, eager):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# mamba2_layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["prefill", "continuation", "recurrence"])
def test_mamba2_layer_matches_reference_f32(f32_layer, mode):
    cfg, jp, tp = f32_layer
    b = 3
    s = 1 if mode == "recurrence" else 13
    x = np.random.default_rng(1).normal(size=(b, s, cfg.d_model)).astype(
        np.float32) * 0.5
    kw_j, kw_t = {}, {}
    if mode != "prefill":
        st, cv = _state(cfg, b, 2)
        nv = np.array([s, max(s - 4, 1), 0], np.int32)
        kw_j = dict(state=jnp.asarray(st), conv_state=jnp.asarray(cv),
                    n_valid=jnp.asarray(nv))
        kw_t = dict(state=torch.from_numpy(st), conv_state=torch.from_numpy(cv),
                    n_valid=torch.from_numpy(nv))
    jy, (jst, jcv) = JS.mamba2_layer(jp, jnp.asarray(x), cfg, chunk=8, **kw_j)
    ty, (tst, tcv) = TS.mamba2_layer(tp, torch.from_numpy(x), cfg, chunk=8,
                                     **kw_t)
    assert ty.shape == (b, s, cfg.d_model) and tst.dtype == torch.float32
    _close(ty, jy, 1e-5, "output")
    _close(tst, jst, 1e-5, "state")
    _close(tcv, jcv, 1e-5, "conv window")
    if mode != "prefill":
        # the idle row: state and window bit for bit
        np.testing.assert_array_equal(tst[2].numpy(), st[2])
        np.testing.assert_array_equal(tcv[2].numpy(), cv[2])


def test_mamba2_layer_ragged_rows_are_independent(f32_layer):
    """Rows of one ragged call carry what each row alone carries: dt = 0
    past a row's valid tokens makes their steps the identity, and the conv
    window ends at the row's own last valid token."""
    cfg, _, tp = f32_layer
    s = 9
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, s, cfg.d_model)).astype(np.float32))
    st, cv = (torch.from_numpy(a) for a in _state(cfg, 3, 5))
    nv = torch.tensor([9, 4, 0], dtype=torch.int32)
    _, (all_st, all_cv) = TS.mamba2_layer(tp, x, cfg, state=st,
                                          conv_state=cv, n_valid=nv)
    for r, n in enumerate(nv.tolist()):
        if n == 0:
            continue
        _, (one_st, one_cv) = TS.mamba2_layer(
            tp, x[r:r + 1, :n], cfg, state=st[r:r + 1],
            conv_state=cv[r:r + 1])
        _close(all_st[r:r + 1], one_st, 1e-5, f"row {r} state")
        np.testing.assert_array_equal(all_cv[r:r + 1].numpy(),
                                      one_cv.numpy())


def test_ssd_chunk_size_invariance_and_recurrence(f32_layer):
    """The chunked SSD at chunks 4, 8, 16 and 64 (the reference's rule: the
    largest divisor of S at most `chunk`) and the token-by-token
    recurrence agree."""
    cfg, _, tp = f32_layer
    s = 32
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, s, cfg.d_model)).astype(np.float32) * 0.5)
    ys = {c: TS.mamba2_layer(tp, x, cfg, chunk=c) for c in (4, 8, 16, 64)}
    for c, (y, (st, _)) in ys.items():
        _close(y, ys[64][0], 1e-5, f"chunk {c} output")
        _close(st, ys[64][1][0], 1e-5, f"chunk {c} state")
    st, cv = TS.init_ssm_state(cfg, 2)
    cv = cv.float()
    seq = []
    for t in range(s):
        y, (st, cv) = TS.mamba2_layer(tp, x[:, t:t + 1], cfg, state=st,
                                      conv_state=cv)
        seq.append(y)
    _close(torch.cat(seq, 1), ys[64][0], 1e-5, "recurrence output")
    _close(st, ys[64][1][0], 1e-5, "recurrence state")
    # a 13-token block takes one chunk of 13; 12 tokens at chunk 8, 2 of 6
    assert _chunk(13, 128) == 13 and _chunk(12, 8) == 6


def _chunk(s, chunk):
    q = min(chunk, s)
    while s % q:
        q -= 1
    return q


@pytest.fixture(scope="module")
def fxp8_models():
    out = {}
    for arch in FAMILIES:
        cfg = jget_config(arch).reduced()
        jp = jquantize_params(JM.init_params(cfg, jax.random.PRNGKey(0)),
                              "fxp8")
        out[arch] = (cfg, jp, from_numpy_tree(numpy_tree(jp)))
    return out


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_mamba2_layer_fxp8_bit_equal_to_reference(fxp8_models, backend):
    """One reduced Mamba2 layer under flexpe(8), a ragged continuation
    block: in_proj, the bf16 conv and SiLU, the SSD, the CORDIC gate and
    out_proj as the reference's Pallas backend computes them."""
    cfg, jp, tp = fxp8_models["mamba2_370m"]
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["ssm"])
    tl = TM.layer_params(tp["blocks"], 0)["ssm"]
    jx, tx = _bf16_pair(np.random.default_rng(7).normal(
        size=(2, 8, cfg.d_model)))
    st, cv = _state(cfg, 2, 8)
    jcv, tcv = _bf16_pair(cv)
    nv = np.array([8, 5], np.int32)
    with eager_reference():
        jy, (jst, jcv2) = JS.mamba2_layer(
            jl, jx, cfg, JPAL, state=jnp.asarray(st), conv_state=jcv,
            n_valid=jnp.asarray(nv))
    ty, (tst, tcv2) = TS.mamba2_layer(
        tl, tx, cfg, TPolicy.flexpe(8, backend=backend),
        state=torch.from_numpy(st), conv_state=tcv,
        n_valid=torch.from_numpy(nv))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(ty), _np(jy))
    np.testing.assert_array_equal(_np(tcv2), _np(jcv2))
    _close(tst, jst, 1e-5, "state")


# ---------------------------------------------------------------------------
# decode_step of the reduced models
# ---------------------------------------------------------------------------

SLOTS, MAX_LEN, BS, CHUNK = 2, 24, 4, 8


def _init_pair(cfg, jpol, tpol, dtype_j, dtype_t):
    jc = JM.init_cache(cfg, SLOTS, MAX_LEN, jpol, dtype=dtype_j,
                       kv_block_size=BS)
    tc = TM.init_cache(cfg, SLOTS, MAX_LEN, tpol, dtype=dtype_t,
                       kv_block_size=BS, device="cpu")
    if "block_tables" in tc:
        tables = np.array([[5, 0, 3, 7, 9, 11], [1, 4, 6, 2, 8, 10]],
                          np.int32)
        jc["block_tables"] = jnp.asarray(tables)
        tc["block_tables"] = torch.from_numpy(tables)
    return jc, tc


def _steps(cfg, jp, tp, jpol, tpol, f32, ctx, tol):
    """A ragged prefill block then two greedy decode steps through both
    packages, teacher-forced with the reference's tokens; every step's
    logits held to `tol["logits"]` of their range. -> the final caches."""
    dt_j, dt_t = ((jnp.float32, torch.float32) if f32
                  else (jnp.bfloat16, torch.bfloat16))
    jc, tc = _init_pair(cfg, jpol, tpol, dt_j, dt_t)
    tokens = np.random.default_rng(9).integers(0, cfg.vocab, (SLOTS, CHUNK))
    n_valid = np.array([CHUNK, 5], np.int32)
    rows = np.arange(SLOTS)
    for step in range(3):
        with ctx():
            jl, jc = JM.decode_step(cfg, jp, jc, jnp.asarray(tokens, jnp.int32),
                                    policy=jpol, n_valid=jnp.asarray(n_valid),
                                    last_only=True)
        tl, tc = TM.decode_step(cfg, tp, tc, torch.from_numpy(tokens),
                                policy=tpol, n_valid=torch.from_numpy(n_valid),
                                last_only=True)
        jl = _np(jl)[:, -1, :cfg.vocab]
        tl = _np(tl)[:, -1, :cfg.vocab]
        diff = np.abs(tl - jl).max()
        assert diff <= tol["logits"] * np.abs(jl).max(), f"step {step}"
        jt, tt = jl.argmax(-1), tl.argmax(-1)
        top2 = np.sort(jl, -1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 2 * diff
        np.testing.assert_array_equal(tt[decided], jt[decided])
        assert (jl[rows, tt] >= jl.max(-1) - 2 * diff).all(), f"step {step}"
        assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist()
        tokens = jt[:, None].astype(np.int64)
        n_valid = np.ones((SLOTS,), np.int32)
    return jc, tc


# (family, f32 without a policy or flexpe(8)) -> relative tolerances of
# the logits, the carried state and conv window, and the KV codes' steps
TOLERANCES = {
    ("mamba2_370m", "f32"): dict(logits=1e-4, state=1e-5, conv=1e-5),
    ("zamba2_1p2b", "f32"): dict(logits=1e-4, state=1e-5, conv=1e-5,
                                 kv=1e-4),
    ("mamba2_370m", "fxp8"): dict(logits=0.0, state=1e-5, conv=0.0),
    ("zamba2_1p2b", "fxp8"): dict(logits=0.1, state=0.05, conv=0.05,
                                  kv_codes=(0, 8)),
}


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("mode", ["f32", "fxp8"])
def test_decode_step_matches_reference(fxp8_models, arch, mode):
    tol = TOLERANCES[(arch, mode)]
    if mode == "f32":
        cfg = jget_config(arch).reduced()
        jp = JM.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
        tp = from_numpy_tree(numpy_tree(jp))
        jc, tc = _steps(cfg, jp, tp, None, None, True,
                        contextlib.nullcontext, tol)
    else:
        cfg, jp, tp = fxp8_models[arch]
        jc, tc = _steps(cfg, jp, tp, JPAL, TPolicy.flexpe(8), False,
                        eager_reference, tol)
    # the carried caches: the f32 state, the conv window in the cache's
    # dtype, and the hybrid's KV
    _close(tc["ssm"][0], jc["ssm"][0], tol["state"], "state")
    _close(tc["ssm"][1], jc["ssm"][1], tol["conv"], "conv window")
    assert tc["ssm"][1].dtype == (torch.float32 if mode == "f32"
                                  else torch.bfloat16)
    if cfg.family == "hybrid":
        assert tc["kv"]["k"].shape[0] == cfg.n_layers // cfg.attn_every
        for leaf in ("k", "v"):
            if mode == "f32":
                _close(tc["kv"][leaf], jc["kv"][leaf], tol["kv"], leaf)
            else:
                d = np.abs(tc["kv"][leaf].numpy().astype(np.int32)
                           - np.asarray(jc["kv"][leaf]).astype(np.int32))
                for app, steps in enumerate(tol["kv_codes"]):
                    assert d[app].max() <= steps, (leaf, app)
    else:
        assert "kv" not in tc and "block_tables" not in tc


# ---------------------------------------------------------------------------
# params and caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_and_cache_like_reference(arch):
    """The port's random init has the reference's tree, shapes and dtypes
    (and its deterministic leaves' values); its cache the reference's
    leaves, the hybrid's KV one layer per shared application."""
    cfg = jget_config(arch).reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = TM.init_params(get_config(arch).reduced(), 0, device="cpu")
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    tflat = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
    assert sorted(map(str, jflat)) == sorted(map(str, tflat))
    for path, jleaf in jflat.items():
        tleaf = tflat[path]
        assert tuple(tleaf.shape) == jleaf.shape, path
        assert str(tleaf.dtype).split(".")[-1] == str(jleaf.dtype), path
    blocks = tp["blocks"]["ssm"]
    for name in ("A_log", "D", "dt_bias", "conv_b", "norm_w"):
        np.testing.assert_allclose(
            blocks[name].float().numpy(),
            _np(jp["blocks"]["ssm"][name]), rtol=1e-6, err_msg=name)
    pol = TPolicy.flexpe(8)
    tc = TM.init_cache(get_config(arch).reduced(), 2, 16, pol,
                       kv_block_size=4, device="cpu")
    jc = JM.init_cache(cfg, 2, 16, JPolicy.flexpe(8), kv_block_size=4)
    assert sorted(tc) == sorted(jc)
    for t, j in zip(tc["ssm"], jc["ssm"]):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
    if "kv" in jc:
        for name in jc["kv"]:
            assert tuple(tc["kv"][name].shape) == jc["kv"][name].shape
