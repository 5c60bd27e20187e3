"""PyTorch port: bf16 as a served policy and the whole precision ladder
(fxp4, fxp8, fxp16, bf16) in one fleet, against the JAX reference (CPU).

  * Reduced Qwen2.5-14B under `tier_policy("bf16")` (bf16 weights, the
    bf16 paged pool, f32 matmuls rounded to bf16, the exact SiLU gate):
    one ragged prefill block then six greedy decode steps. Against the
    eager reference (`jax.disable_jit`) the logits are bit-equal on both
    backends; against the compiled reference within 2% of their range
    (observed at most 1.13%: XLA fuses the bf16 elementwise chains and
    skips some of their roundings), with the same greedy tokens.
  * The port's bf16 engine against the reference's (paged, eager, copied
    uploads): the same greedy tokens.
  * The four-rung fleet (`tiers=["fxp4", "fxp8", "fxp16", "bf16"]`,
    tiered routing, priority 0, 8 requests over 2 slots a replica, so two
    land on each tier) against the reference's eager `EngineRouter` with
    the same flags: the same placements, tiers stamped and greedy tokens.
    The reference runs eagerly with copied uploads
    (`test_torch_serving._race_free_flush`): compiled, it drifts from its
    own eager arithmetic at FxP4 (ROADMAP.md queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.precision import tier_policy as jtier_policy
from repro.models import model as JM
from repro.serving import EngineRouter as JRouter
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving.executor import ModelExecutor as JExecutor
from repro_torch.convert import from_numpy_tree
from repro_torch.core.precision import tier_policy
from repro_torch.core.qtensor import TieredWeights
from repro_torch.models import model as TM
from repro_torch.serving import EngineRouter, Request, ServingEngine
from test_torch_model import BS, CHUNK, MAX_LEN, SLOTS, _tables, numpy_tree
from test_torch_serving import _race_free_flush

LADDER = ["fxp4", "fxp8", "fxp16", "bf16"]
KW = dict(max_slots=2, max_len=16, prefill_chunk=4, kv_block_size=4)
PLENS, GEN = (7, 4, 10, 6, 9, 5, 8, 3), 5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs. The reduced models'
    ops are small, and with the suite's parallel workers each taking a
    thread per core, their spinning threads oversubscribe the cores
    (on six workers, this module's identity cases took 20x longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qwen():
    """Reduced Qwen2.5-14B: the reference's bf16 tree and its port copy."""
    cfg = get_config("qwen2_5_14b").reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jp, from_numpy_tree(numpy_tree(jp))


def _steps(cfg, cache, step_fn):
    """A ragged prefill block then six greedy decode steps, fed the
    reference's tokens -> [(logits [SLOTS, vocab] f32, lengths)]."""
    out = []
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (SLOTS, CHUNK))
    n_valid = np.array([CHUNK, 5], np.int32)
    for _ in range(7):
        logits, cache = step_fn(cache, tokens, n_valid)
        out.append((logits[:, -1, :cfg.vocab], np.asarray(cache["lengths"])))
        tokens = out[-1][0].argmax(-1)[:, None].astype(np.int64)
        n_valid = np.ones((SLOTS,), np.int32)
    return out


def _reference_steps(cfg, jp, jit):
    pol = jtier_policy("bf16")
    cache = JM.init_cache(cfg, SLOTS, MAX_LEN, pol, kv_block_size=BS)
    cache["block_tables"] = jnp.asarray(_tables())

    def step(c, t, n):
        return JM.decode_step(cfg, jp, c, t, policy=pol, n_valid=n,
                              last_only=True)
    fn = jax.jit(step) if jit else step

    def run(c, t, n):
        lg, c = fn(c, jnp.asarray(t, jnp.int32), jnp.asarray(n))
        return np.asarray(lg.astype(jnp.float32)), c
    if jit:
        return _steps(cfg, cache, run)
    with jax.disable_jit():
        return _steps(cfg, cache, run)


@pytest.fixture(scope="module")
def reference_bf16_steps(qwen):
    cfg, jp, _ = qwen
    return {"eager": _reference_steps(cfg, jp, jit=False),
            "compiled": _reference_steps(cfg, jp, jit=True)}


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_bf16_step_matches_reference(qwen, reference_bf16_steps, backend):
    cfg, _, tp = qwen
    pol = tier_policy("bf16", backend=backend)
    assert pol.matmul is None and pol.kv_cache is None
    cache = TM.init_cache(cfg, SLOTS, MAX_LEN, pol, kv_block_size=BS,
                          device="cpu")
    assert cache["kv"]["k"].dtype == torch.bfloat16      # the bf16 pool
    cache["block_tables"] = torch.from_numpy(_tables())

    def run(c, t, n):
        lg, c = TM.decode_step(cfg, tp, c, torch.from_numpy(t), policy=pol,
                               n_valid=torch.from_numpy(n), last_only=True)
        return lg.float().numpy(), c
    got = _steps(cfg, cache, run)
    for step, ((tl, tlen), (el, elen), (cl, _)) in enumerate(zip(
            got, reference_bf16_steps["eager"],
            reference_bf16_steps["compiled"])):
        np.testing.assert_array_equal(tl, el, err_msg=f"step {step}")
        np.testing.assert_array_equal(tlen, elen)
        span = np.abs(cl).max()
        np.testing.assert_allclose(tl, cl, rtol=0, atol=0.02 * span,
                                   err_msg=f"step {step} vs compiled")
        np.testing.assert_array_equal(tl.argmax(-1), cl.argmax(-1))


def _prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab, size=n).tolist() for n in PLENS]


@pytest.fixture(scope="module")
def reference_bf16_engine(qwen):
    cfg, jp, _ = qwen
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(JExecutor, "flush", _race_free_flush(JExecutor.flush))
        eng = JEngine(cfg, jp, policy=jtier_policy("bf16"), **KW)
        done = eng.run([JRequest(prompt=p, max_new_tokens=GEN, id=i)
                        for i, p in enumerate(_prompts(cfg)[:3])])
    return [f.tokens for f in done]


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_bf16_engine_matches_reference_engine(qwen, reference_bf16_engine,
                                              backend):
    cfg, _, tp = qwen
    eng = ServingEngine(cfg, tp, policy=tier_policy("bf16", backend=backend),
                        device="cpu", **KW)
    done = eng.run([Request(prompt=p, max_new_tokens=GEN, id=i)
                    for i, p in enumerate(_prompts(cfg)[:3])])
    eng.check_invariants()
    assert eng.tier == "bf16"
    assert [f.tokens for f in done] == reference_bf16_engine


@pytest.fixture(scope="module")
def reference_ladder(qwen):
    cfg, jp, _ = qwen
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(JExecutor, "flush", _race_free_flush(JExecutor.flush))
        router = JRouter(cfg, jp, tiers=LADDER, routing="tiered", **KW)
        done = router.run([JRequest(prompt=p, max_new_tokens=GEN, id=i)
                           for i, p in enumerate(_prompts(cfg))])
        st = router.stats()
    return ({f.id: f.tokens for f in done}, {f.id: f.tier for f in done},
            st["tier_placed"], st["dispatched"])


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_four_rung_fleet_matches_reference_router(qwen, reference_ladder,
                                                  backend):
    cfg, _, tp = qwen
    want_toks, want_tiers, want_placed, want_dispatched = reference_ladder
    bank = TieredWeights(tp, LADDER)
    router = EngineRouter(cfg, bank, tiers=LADDER, routing="tiered",
                          backend=backend, device="cpu", **KW)
    done = router.run([Request(prompt=p, max_new_tokens=GEN, id=i)
                       for i, p in enumerate(_prompts(cfg))])
    router.check_invariants()
    st = router.stats()
    assert {f.id: f.tier for f in done} == want_tiers
    assert want_placed == {t: 2 for t in LADDER}        # every rung served
    assert st["tier_placed"] == want_placed
    assert st["dispatched"] == want_dispatched
    assert {f.id: f.tokens for f in done} == want_toks
    assert all(len(t) == GEN for t in want_toks.values())
