"""PyTorch port: cross-tier speculative decoding — the executor's verify
step, `SpecDecodeCoordinator`, the router's `spec_decode` and the serve
CLI's `--spec-decode` — against the JAX reference and against the port's
own verify-tier engine (CPU).

  * The verify step (reduced Qwen2.5-14B, paged, bf16): its token grid,
    feedback buffer and lengths equal the reference executor's, run
    eagerly (`jax.disable_jit`; compiled, the reference's bf16 logits
    move by up to 1.1% of their range, tests/test_torch_ladder.py, and at
    FxP4 it drifts from its own eager arithmetic, ROADMAP.md queue 3).
  * Token identity with the verify tier alone, for all four cache
    families (dense, MoE, SSM, hybrid) under the contiguous, paged and
    prefix-cached layouts, for two pairs: an fxp4-policy draft and a
    verifier without a policy over one f32 tree (the reference test's
    pair, `tests/test_spec_decode.py`), and the fxp4 and bf16 tiers of
    one bf16 `TieredWeights` bank (the served pair). Both verifiers'
    numerics do not depend on how a chunk is composed; an FxP verifier's
    per-tensor activation scale spans every row of the dispatch, so
    `fxp4:fxp8` is held for acceptance, rollback and the ledger only.
  * Reduced Qwen2.5-14B (both pairs) and Mamba2-370M (the bank's fxp4
    draft against an f32 verifier), paged: the tokens and every `spec_*`
    counter equal the reference coordinator's (eager, copied uploads,
    `test_torch_serving._race_free_flush`), so the draft's proposals are
    the reference's. Mamba2 under fxp4:bf16: the port's stream equals
    the reference's bf16 engine alone, which the reference's coordinator
    does not (its SSD verify dispatch, ROADMAP.md queue 3).
  * The reference's rollback-ledger, prefix-shared-block, abort,
    EOS-inside-the-window, single/zero-proposal, validation and router
    cases, on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.precision import tier_policy as jtier_policy
from repro.core.qtensor import TieredWeights as JTiered
from repro.models import model as JM
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import SpecDecodeCoordinator as JCoordinator
from repro.serving.executor import ModelExecutor as JExecutor
from repro_torch.convert import from_numpy_tree
from repro_torch.core.precision import tier_policy
from repro_torch.core.qtensor import TieredWeights
from repro_torch.launch import serve as tserve
from repro_torch.serving import (EngineRouter, Request, SamplingParams,
                                 ServingEngine, SpecDecodeCoordinator)
from repro_torch.serving.executor import ModelExecutor
from test_torch_model import numpy_tree
from test_torch_serving import _race_free_flush

ARCHS = ["qwen2_5_14b", "mamba2_370m", "zamba2_1p2b", "deepseek_moe_16b"]
LAYOUTS = ["contig", "paged", "paged_prefix"]
PAIRS = ["fxp4:None", "fxp4:bf16"]


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


def _trees(arch):
    """(cfg, {dtype: (reference tree, port tree)}) from PRNGKey(0): the f32
    tree of the reference test's pair and the bf16 tree of a bank."""
    cfg = get_config(arch).reduced()
    out = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jp = JM.init_params(cfg, jax.random.PRNGKey(0), dtype=dt)
        out[name] = (jp, from_numpy_tree(numpy_tree(jp)))
    return cfg, out


@pytest.fixture(scope="module", params=ARCHS)
def trees(request):
    return _trees(request.param)


@pytest.fixture(scope="module")
def qwen():
    return _trees("qwen2_5_14b")


def _prompts(cfg, layout, n=4):
    rng = np.random.default_rng(1)
    prefix = (rng.integers(0, cfg.vocab, 8).tolist()
              if layout == "paged_prefix" else [])
    plens = [5, 11, 8, 3, 9]
    return [prefix + rng.integers(0, cfg.vocab, plens[i % 5]).tolist()
            for i in range(n)]


def _layout_kw(layout):
    kw = dict(max_slots=2, max_len=28, prefill_chunk=4, seed=0)
    if layout != "contig":
        kw["kv_block_size"] = 4
    if layout == "paged_prefix":
        kw["prefix_cache"] = True
    return kw


def _requests(cfg, layout, n=4, gen=6, **rkw):
    return [Request(prompt=p, max_new_tokens=gen, id=i, **rkw)
            for i, p in enumerate(_prompts(cfg, layout, n))]


def _sides(trees, pair):
    """((draft params, draft policy), (verify params, verify policy)):
    "fxp4:None" an fxp4 policy and no policy over one f32 tree, "fxp4:bf16"
    the two tiers of one bf16 bank, "fxp4:f32" that bank's fxp4 codes and
    the f32 tree without a policy."""
    t = trees[1]
    if pair == "fxp4:None":
        p = t["f32"][1]
        return (p, tier_policy("fxp4")), (p, None)
    bank = TieredWeights(t["bf16"][1], ["fxp4", "bf16"])
    draft = (bank.for_tier("fxp4"), tier_policy("fxp4"))
    if pair == "fxp4:f32":
        return draft, (t["f32"][1], None)
    return draft, (bank.for_tier("bf16"), tier_policy("bf16"))


def _spec(trees, pair, layout, k=4, **extra):
    (dp, dpol), (vp, vpol) = _sides(trees, pair)
    kw = dict(_layout_kw(layout), device="cpu", **extra)
    return SpecDecodeCoordinator(trees[0], dp, vp, draft_policy=dpol,
                                 verify_policy=vpol, k=k, **kw)


def _anchor(trees, pair, layout, reqs, **extra):
    _, (vp, vpol) = _sides(trees, pair)
    eng = ServingEngine(trees[0], vp, policy=vpol,
                        **dict(_layout_kw(layout), device="cpu", **extra))
    return {f.id: f.tokens for f in eng.run(reqs)}


def _drain(co):
    """Run to idle, auditing every tick; terminal events by id."""
    done = {}
    while co.has_work():
        for out in co.step():
            if out.finished:
                done[out.id] = out
        co.check_invariants()
    return done


SPEC_COUNTERS = ("spec_proposed", "spec_accepted", "spec_verify_steps",
                 "spec_rolled_back")


# ---------------------------------------------------------------------------
# the verify step against the reference executor's
# ---------------------------------------------------------------------------

VKW = dict(max_slots=3, max_len=16, prefill_chunk=4, kv_block_size=4)


def _drive_executor(ex, tables, prefill, grids, as_tokens):
    """Block tables, then prefill chunks, then verify dispatches; -> the
    token grids, feedback buffers and length mirrors after each verify."""
    for row, blocks in enumerate(tables):
        for i, blk in enumerate(blocks):
            ex.write_table(row, i, blk)
    ex.flush()
    for row, chunk, take in prefill:
        ex.prefill(row, as_tokens(chunk), take)
    ex.ensure_verify_step(4)
    out = []
    for grid, nv in grids:
        ex.flush()
        toks = ex.verify(grid, nv)
        out.append((np.asarray(toks), np.asarray(ex._token_buf),
                    ex._lengths_host.copy(),
                    np.asarray(ex.cache["lengths"])))
    return out


def test_verify_step_matches_reference():
    """Three rows, prefilled in chunks, then two verify dispatches with
    ragged valid counts (an idle row in each). The fxp4 draft's ingest is
    the same step, held through the coordinator's counters below."""
    tier = "bf16"
    cfg = get_config("qwen2_5_14b").reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    jview = JTiered(jp, [tier]).for_tier(tier)
    tview = TieredWeights(from_numpy_tree(numpy_tree(jp)),
                          [tier]).for_tier(tier)
    rng = np.random.default_rng(5)
    tables = [[3, 0, 7], [1, 5], [2, 4, 6]]
    prefill = []
    for row, plen in enumerate((7, 3, 6)):
        p = rng.integers(0, cfg.vocab, plen)
        for s in range(0, plen, 4):
            chunk = np.zeros((1, 4), np.int64)
            chunk[0, :len(p[s:s + 4])] = p[s:s + 4]
            prefill.append((row, chunk, len(p[s:s + 4])))
    # row 1 idle in the first dispatch; ragged valid counts
    grids = [(rng.integers(0, cfg.vocab, (3, 4)), np.array([4, 0, 2],
                                                           np.int32)),
             (rng.integers(0, cfg.vocab, (3, 4)), np.array([1, 3, 0],
                                                           np.int32))]
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(JExecutor, "flush", _race_free_flush(JExecutor.flush))
        jex = JExecutor(cfg, jview, policy=jtier_policy(tier), **VKW)
        want = _drive_executor(jex, tables, prefill, grids,
                               lambda c: jnp.asarray(c, jnp.int32))
    tex = ModelExecutor(cfg, tview, policy=tier_policy(tier, "kernels"),
                        device="cpu", **VKW)
    got = _drive_executor(tex, tables, prefill, grids, torch.from_numpy)
    for (gt, gb, gl, gc), (wt, wb, wl, wc), (_, nv) in zip(got, want, grids):
        live = np.arange(4)[None, :] < nv[:, None]
        np.testing.assert_array_equal(gt[live], wt[live])
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gc, wc)
    assert got[-1][2].tolist() == [7 + 4 + 1, 3 + 3, 6 + 2]


def test_verify_width_checked():
    cfg = get_config("qwen2_5_14b").reduced()
    params = from_numpy_tree(numpy_tree(JM.init_params(
        cfg, jax.random.PRNGKey(0))))
    ex = ModelExecutor(cfg, params, device="cpu", **VKW)
    with pytest.raises(ValueError, match="token grid"):
        ex.verify(np.zeros((3, 4), np.int64), np.zeros((3,), np.int32))
    with pytest.raises(ValueError, match="does not fit"):
        ex.ensure_verify_step(6)
    ex.ensure_verify_step(5)
    with pytest.raises(ValueError, match="token grid"):
        ex.verify(np.zeros((3, 4), np.int64), np.zeros((3,), np.int32))


# ---------------------------------------------------------------------------
# token identity with the verify tier alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_decode_identity(trees, layout, pair):
    """Every family under every layout: the speculative greedy streams
    equal the verify tier's alone. The SSM and hybrid rows take the
    checkpoint, restore and replay rollback."""
    cfg = trees[0]
    anchor = _anchor(trees, pair, layout, _requests(cfg, layout))
    co = _spec(trees, pair, layout)
    for r in _requests(cfg, layout):
        co.submit(r)
    done = _drain(co)
    assert {i: o.tokens for i, o in done.items()} == anchor
    st = co.stats()
    assert st["spec_verify_steps"] > 0 and st["spec_proposed"] > 0
    assert 0 <= st["spec_accepted"] <= st["spec_proposed"]
    assert st["spec_rolled_back"] > 0
    for out in done.values():
        assert out.spec_verify_steps > 0
        assert out.spec_accepted <= out.spec_proposed
    if layout == "paged_prefix" and not co.verify.ex.has_ssm:
        # the SSM and hybrid engines make prefix_cache a no-op
        assert st["prefix_tokens_reused"] > 0


# ---------------------------------------------------------------------------
# against the reference coordinator
# ---------------------------------------------------------------------------

def _reference_coordinator(cfg, t, pair):
    kw = dict(_layout_kw("paged"))
    if pair == "fxp4:None":
        jp = t["f32"][0]
        return JCoordinator(cfg, jp, jp, draft_policy=jtier_policy("fxp4"),
                            verify_policy=None, k=4, **kw)
    if pair == "fxp4:f32":
        return JCoordinator(cfg, JTiered(t["bf16"][0], ["fxp4"]).for_tier(
            "fxp4"), t["f32"][0], draft_policy=jtier_policy("fxp4"),
            verify_policy=None, k=4, **kw)
    return JCoordinator.from_tiers(cfg, t["bf16"][0], "fxp4", "bf16", k=4,
                                   **kw)


@pytest.mark.parametrize("arch,pair", [
    ("qwen2_5_14b", "fxp4:None"), ("qwen2_5_14b", "fxp4:bf16"),
    ("mamba2_370m", "fxp4:f32")])
def test_spec_matches_reference_coordinator(arch, pair):
    """The draft's proposals, and so every counter, are the reference's
    where both packages' draft steps agree bit for bit: the fxp4 codes of
    a bf16 bank, or Qwen's fxp4 policy on f32 weights. (Mamba2 under an
    fxp4 policy on f32 weights is not such a draft: the two packages' f32
    rmsnorms differ by an ulp, and FxP4 snaps it into a code step.)"""
    trees = _trees(arch)
    cfg, t = trees
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(JExecutor, "flush", _race_free_flush(JExecutor.flush))
        jco = _reference_coordinator(cfg, t, pair)
        want = {f.id: f for f in jco.run([
            JRequest(prompt=p, max_new_tokens=5, id=i)
            for i, p in enumerate(_prompts(cfg, "paged", 3))])}
        jst = jco.stats()
    co = _spec(trees, pair, "paged")
    got = {f.id: f for f in co.run(_requests(cfg, "paged", 3, 5))}
    co.check_invariants()
    st = co.stats()
    assert {i: f.tokens for i, f in got.items()} == {
        i: f.tokens for i, f in want.items()}
    for c in SPEC_COUNTERS + ("spec_tokens_per_verify_step",
                              "generated_tokens", "prompt_tokens"):
        assert st[c] == jst[c], c
    for i, f in got.items():
        assert [getattr(f, c) for c in SPEC_COUNTERS] == [
            getattr(want[i], c) for c in SPEC_COUNTERS]
    assert st["spec_rolled_back"] > 0


def test_ssm_bf16_spec_equals_reference_verify_tier_alone():
    """Mamba2 under fxp4:bf16: the port's speculative stream equals the
    reference's bf16 engine alone (eager, paged), while the reference's
    coordinator does not: its verify dispatch runs the SSD continuation,
    which rounds the carried state to bf16 and sums in another order than
    the one-token recurrence (ROADMAP.md queue 3). The draft keeps the
    SSD, so its proposals are the reference's."""
    trees = _trees("mamba2_370m")
    cfg, t = trees
    jp = t["bf16"][0]
    reqs = [JRequest(prompt=p, max_new_tokens=6, id=i)
            for i, p in enumerate(_prompts(cfg, "paged", 2))]
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(JExecutor, "flush", _race_free_flush(JExecutor.flush))
        alone = {f.id: f.tokens for f in JEngine(
            cfg, jp, policy=jtier_policy("bf16"),
            **_layout_kw("paged")).run(reqs)}
        jco = _reference_coordinator(cfg, t, "fxp4:bf16")
        ref_spec = {f.id: f.tokens for f in jco.run([
            JRequest(prompt=r.prompt, max_new_tokens=6, id=r.id)
            for r in reqs])}
    co = _spec(trees, "fxp4:bf16", "paged")
    got = {f.id: f.tokens for f in co.run(_requests(cfg, "paged", 2))}
    assert got == alone
    assert ref_spec != alone
    assert co.stats()["spec_rolled_back"] > 0


# ---------------------------------------------------------------------------
# the reference's rollback, abort, EOS, budget and validation cases
# ---------------------------------------------------------------------------

def test_rollback_keeps_block_ledger_consistent(qwen):
    """Rejected suffixes roll back, every rollback round leaves both paged
    ledgers clean, and after the drain every block is back."""
    co = _spec(qwen, "fxp4:None", "paged")
    for r in _requests(qwen[0], "paged"):
        co.submit(r)
    _drain(co)
    assert co.stats()["spec_rolled_back"] > 0
    for sched in (co.verify.sched, co.draft.sched):
        s = sched.stats()
        assert s["held_blocks"] == 0
        assert s["free_blocks"] + s["cached_blocks"] == s["kv_blocks"]


def test_rollback_never_pops_prefix_shared_blocks(qwen):
    """Prefix-cached layout: rollback frees only private blocks (the
    scheduler asserts it on every pop), right behind shared prompts."""
    co = _spec(qwen, "fxp4:None", "paged_prefix")
    for r in _requests(qwen[0], "paged_prefix"):
        co.submit(r)
    _drain(co)
    st = co.stats()
    assert st["spec_rolled_back"] > 0 and st["prefix_tokens_reused"] > 0


def test_fxp_verifier_accepts_and_rolls_back(qwen):
    """fxp4:fxp8 off one bank: an FxP verifier's stream depends on the
    dispatch's rows, so only acceptance, rollback and the ledger hold."""
    cfg, t = qwen
    co = SpecDecodeCoordinator.from_tiers(
        cfg, t["bf16"][1], "fxp4", "fxp8", backend="kernels", k=3,
        device="cpu", **_layout_kw("paged"))
    assert (co.draft_tier, co.tier) == ("fxp4", "fxp8")
    for r in _requests(cfg, "paged"):
        co.submit(r)
    done = _drain(co)
    assert sorted(done) == [0, 1, 2, 3]
    assert all(len(o.tokens) == 6 and o.tier == "fxp8"
               for o in done.values())
    st = co.stats()
    assert st["spec_rolled_back"] > 0
    assert st["spec_proposed"] == st["spec_accepted"] + st["spec_rolled_back"]
    assert st["held_blocks"] == 0 and st["generated_tokens"] == 24


def test_abort_queued_and_mid_speculation(qwen):
    cfg = qwen[0]
    co = _spec(qwen, "fxp4:None", "paged", max_slots=1)
    for r in _requests(cfg, "paged", n=3, gen=8):
        co.submit(r)
    assert co.abort(2)                   # never left the admission queue
    events = []
    for _ in range(4):
        events.extend(co.step())
    assert any(o.id == 0 and o.new_tokens and not o.finished
               for o in events), "rid 0 never reached speculation"
    assert co.abort(0)
    co.check_invariants()
    assert co.verify.sched.slots[0] is None
    assert co.draft.sched.slots[0] is None
    done = _drain(co)
    done.update({o.id: o for o in events if o.finished})
    assert done[0].finish_reason == "aborted" and done[0].tokens
    assert done[2].finish_reason == "aborted" and not done[2].tokens
    assert done[1].finish_reason == "length"
    for sched in (co.verify.sched, co.draft.sched):
        assert sched.stats()["held_blocks"] == 0
    assert not co.abort(99)


def test_eos_inside_accepted_window(qwen):
    cfg = qwen[0]
    plain = _anchor(qwen, "fxp4:None", "paged",
                    _requests(cfg, "paged", n=2, gen=8))
    eos = plain[0][2]

    def reqs():
        return _requests(cfg, "paged", n=2, gen=8, eos_id=eos)
    anchor = _anchor(qwen, "fxp4:None", "paged", reqs())
    assert anchor[0] == plain[0][:plain[0].index(eos) + 1]
    co = _spec(qwen, "fxp4:None", "paged")
    for r in reqs():
        co.submit(r)
    done = _drain(co)
    assert {i: o.tokens for i, o in done.items()} == anchor
    assert done[0].finish_reason == "eos" and done[0].tokens[-1] == eos


def test_single_and_zero_proposal_rounds(qwen):
    """max_new_tokens 1 finishes at the prefill seed, 2 forces verify-only
    rounds (k_row 0); both equal the anchor's prefixes."""
    cfg = qwen[0]
    anchor = _anchor(qwen, "fxp4:None", "contig",
                     _requests(cfg, "contig", n=2, gen=6))
    for gen in (1, 2):
        co = _spec(qwen, "fxp4:None", "contig")
        for r in _requests(cfg, "contig", n=2, gen=gen):
            co.submit(r)
        done = _drain(co)
        assert {i: o.tokens for i, o in done.items()} == {
            i: t[:gen] for i, t in anchor.items()}


def test_submit_and_ctor_validation(qwen):
    cfg = qwen[0]
    co = _spec(qwen, "fxp4:None", "contig")
    prompt = _prompts(cfg, "contig")[0]
    with pytest.raises(ValueError, match="greedy"):
        co.submit(Request(prompt=prompt, max_new_tokens=4,
                          sampling=SamplingParams(temperature=0.5)))
    with pytest.raises(ValueError, match="greedy"):
        co.submit(Request(prompt=prompt, max_new_tokens=4,
                          sampling=SamplingParams(top_k=8)))
    with pytest.raises(ValueError, match="k"):
        _spec(qwen, "fxp4:None", "contig", k=0)
    with pytest.raises(ValueError, match="verify window"):
        _spec(qwen, "fxp4:None", "contig", k=6)   # prefill_chunk 4: k <= 5


def test_stream_and_stats(qwen):
    cfg = qwen[0]
    anchor = _anchor(qwen, "fxp4:bf16", "paged", _requests(cfg, "paged"))
    co = _spec(qwen, "fxp4:bf16", "paged")
    reqs = _requests(cfg, "paged")
    for r in reqs[:3]:
        co.submit(r)
    seen = []
    for out in co.stream(reqs[3]):
        assert out.id == 3
        seen.extend(out.new_tokens)
    assert seen == anchor[3]
    rest = {o.id: o.tokens for o in co.events() if o.finished}
    assert rest == {i: anchor[i] for i in range(3)}
    st = co.stats()
    assert st["spec_draft_tier"] == "fxp4" and st["tier"] == "bf16"
    assert st["generated_tokens"] == 24 and st["overlap"] is False
    assert st["spec_tokens_per_verify_step"] == pytest.approx(
        24 / st["spec_verify_steps"])


# ---------------------------------------------------------------------------
# the router and the serve CLI
# ---------------------------------------------------------------------------

RKW = dict(max_slots=2, max_len=28, prefill_chunk=4, seed=0, device="cpu")


def _router_reqs(cfg, tier="bf16"):
    return [Request(prompt=p, max_new_tokens=6, tier=tier, id=i)
            for i, p in enumerate(_prompts(cfg, "contig", 3))]


def test_router_spec_decode_tiered_identity(qwen):
    """tiers + spec_decode: only the verify-tier class turns speculative,
    and requests pinned there stream what a plain tiered fleet's verify
    replica streams; the fxp4 class is plain and unchanged."""
    cfg, t = qwen
    bank = TieredWeights(t["bf16"][1], ["fxp4", "bf16"])
    plain = EngineRouter(cfg, bank, tiers=["fxp4", "bf16"],
                         routing="tiered", **RKW)
    spec = EngineRouter(cfg, bank, tiers=["fxp4", "bf16"], routing="tiered",
                        spec_decode="fxp4:bf16", spec_k=3, **RKW)
    assert isinstance(spec.engines[1], SpecDecodeCoordinator)
    assert isinstance(spec.engines[0], ServingEngine)
    for tier in ("bf16", "fxp4"):
        want = {f.id: f.tokens for f in plain.run(_router_reqs(cfg, tier))}
        got = {f.id: f.tokens for f in spec.run(_router_reqs(cfg, tier))}
        spec.check_invariants()
        assert got == want, tier
    st = spec.stats()
    assert st["spec_decode"] == "fxp4:bf16" and st["spec_k"] == 3
    assert st["spec_verify_steps"] > 0
    assert st["spec_proposed"] == st["spec_accepted"] + st["spec_rolled_back"]
    with pytest.raises(ValueError, match="greedy"):
        spec.submit(Request(prompt=[1, 2, 3], max_new_tokens=4,
                            sampling=SamplingParams(temperature=1.0)))


def test_router_untiered_spec_fleet(qwen):
    """No tiers: every replica is a coordinator over the pair's bank."""
    cfg, t = qwen
    router = EngineRouter(cfg, t["bf16"][1], engines=2,
                          spec_decode="fxp4:bf16", **RKW)
    assert router.tiered_weights.tier_names == ("fxp4", "bf16")
    assert all(isinstance(e, SpecDecodeCoordinator) and e.tier == "bf16"
               for e in router.engines)
    done = router.run(_router_reqs(cfg, tier=None))
    router.check_invariants()
    assert len(done) == 3 and router.stats()["dispatched"] == [2, 1]


def test_router_spec_decode_validation(qwen):
    cfg, t = qwen
    params = t["bf16"][1]
    kw = dict(RKW)
    with pytest.raises(ValueError, match="draft:verify"):
        EngineRouter(cfg, params, engines=1, spec_decode="fxp4", **kw)
    with pytest.raises(ValueError, match="below"):
        EngineRouter(cfg, params, engines=1, spec_decode="bf16:fxp4", **kw)
    with pytest.raises(ValueError, match="no replica"):
        EngineRouter(cfg, params, tiers=["fxp4", "fxp8"],
                     spec_decode="fxp4:bf16", **kw)
    with pytest.raises(ValueError, match="not both"):
        EngineRouter(cfg, params, engines=1, spec_decode="fxp4:bf16",
                     policy=tier_policy("bf16"), **kw)
    bank = TieredWeights(params, ["fxp8", "bf16"])
    with pytest.raises(ValueError, match="no bank"):
        EngineRouter(cfg, bank, tiers=["fxp8", "bf16"],
                     spec_decode="fxp4:bf16", **kw)


def test_serve_cli_spec_decode(capsys):
    """`--tiers` with all four rungs and `--spec-decode fxp4:bf16` on the
    CPU: every bank's bytes, the speculative counters, the placements."""
    tserve.main(["--arch", "qwen2_5_14b", "--reduced", "--device", "cpu",
                 "--tiers", "fxp4,fxp8,fxp16,bf16", "--routing", "tiered",
                 "--spec-decode", "fxp4:bf16", "--spec-k", "3",
                 "--kv-block-size", "4", "--requests", "8", "--slots", "2",
                 "--prompt-len", "6", "--gen", "4", "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    banks = out.split("tiered weight banks: ")[1].splitlines()[0]
    assert [b.split()[0] for b in banks.split(", ")] == [
        "fxp4", "fxp8", "fxp16", "bf16"]
    assert "speculative: fxp4:bf16 k=3" in out
    assert "placed {fxp4: 2, fxp8: 2, fxp16: 2, bf16: 2}" in out
    tserve.main(["--arch", "mamba2_370m", "--reduced", "--device", "cpu",
                 "--spec-decode", "fxp4:fxp8", "--engines", "2",
                 "--requests", "3", "--slots", "2", "--prompt-len", "6",
                 "--gen", "5", "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "tiered weight banks: fxp4" in out and "fxp8" in out
    assert "speculative: fxp4:fxp8 k=4" in out
    assert "router: 2 engines" in out
