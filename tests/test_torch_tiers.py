"""PyTorch port, slice 4: the precision-tiered fleet — `TieredWeights`,
`TierPolicy`, the routing policies and `EngineRouter` — against the JAX
reference package and against the port's own single engine (CPU).

  * `TieredWeights`: every tier's codes and scales bit-equal to the
    reference's `TieredWeights` and to the port's own `quantize_params`
    for fxp4, fxp8 and fxp16 (dense [L, K, N] leaves and MoE [L, E, K, N]
    banks); the bf16 view is the source itself; `bytes_by_tier`; the
    reference's error cases; `consume` drops each float weight once its
    codes exist.
  * `TierPolicy` and the routing policies: the reference's unit cases
    (tests/test_tiered_routing.py, tests/test_router.py) that need no
    prefix cache, run on the port's router over reduced Qwen2.5-14B
    replicas.
  * The reduced fleet (`fxp8,fxp16`, tiered routing, paged KV) against
    the reference's `EngineRouter` with the same flags: the same tier
    stamped on every request and the same greedy tokens, on a prompt draw
    without a near-tie of the top logits (tests/test_torch_serving.py says
    why that matters). The reference runs eagerly (`jax.disable_jit`) with
    copied uploads (ROADMAP.md queue 3): compiled, its fxp16 replica drifts
    from its own eager arithmetic (on the draw of seed 2 the first token of
    an fxp16 request differs between the two), and the port matches the
    eager one.
  * The pin contract: a fleet whose requests are all pinned to one tier
    gives the tokens of a single port engine of that tier built from the
    same bank (the same batch composition, so the same per-tensor
    activation scales)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.qtensor import QuantizedTensor as JQT
from repro.core.qtensor import TieredWeights as JTiered
from repro.models import model as JM
from repro.serving import EngineRouter as JRouter
from repro.serving import Request as JRequest
from repro.serving.executor import ModelExecutor as JExecutor
from repro_torch.convert import from_numpy_tree
from repro_torch.core.precision import PrecisionPolicy, tier_policy
from repro_torch.core.qtensor import QuantizedTensor, TieredWeights
from repro_torch.core.qtensor import quantize_params
from repro_torch.launch import serve as tserve
from repro_torch.serving import (EngineRouter, Request, ServingEngine,
                                 TierPolicy)
from repro_torch.serving.router import PrefixAffinity, make_routing_policy
from test_torch_serving import _race_free_flush, numpy_tree

TIERS3 = ["fxp4", "fxp8", "fxp16"]
FLEET = ["fxp8", "fxp16"]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module", params=["qwen2_5_14b", "deepseek_moe_16b"])
def float_params(request):
    cfg = get_config(request.param).reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jp


def _port_tree(jp):
    return from_numpy_tree(numpy_tree(jp))


# ---------------------------------------------------------------------------
# TieredWeights
# ---------------------------------------------------------------------------

def test_tiered_weights_bit_equal_to_reference_and_surgery(float_params):
    cfg, jp = float_params
    jbank = JTiered(jp, TIERS3)
    bank = TieredWeights(_port_tree(jp), TIERS3)
    n_quant = 0
    for t in TIERS3:
        want = dict(_leaves(jbank.for_tier(t)))
        surgery = dict(_leaves(quantize_params(_port_tree(jp), t)))
        for path, got in _leaves(bank.for_tier(t)):
            ref = want[path]
            if isinstance(ref, JQT):
                n_quant += 1
                assert isinstance(got, QuantizedTensor), path
                assert (got.fmt_name, got.n, got.packed) == (
                    ref.fmt_name, ref.n, ref.packed)
                for leaf in (got, surgery[path]):
                    np.testing.assert_array_equal(
                        leaf.data.numpy(), np.asarray(ref.data),
                        err_msg=f"{t} {path}")
                    np.testing.assert_array_equal(
                        leaf.scale.numpy(), np.asarray(ref.scale),
                        err_msg=f"{t} {path}")
            else:
                assert not isinstance(got, QuantizedTensor), path
    assert n_quant >= 3 * 7


def test_tiered_weights_views_share_source_and_bytes():
    cfg = get_config("qwen2_5_14b").reduced()
    params = _port_tree(JM.init_params(cfg, jax.random.PRNGKey(0)))
    bank = TieredWeights(params, TIERS3 + ["bf16"])
    assert bank.for_tier("bf16") is params        # one float source
    assert bank.for_tier("fxp8")["embed"] is params["embed"]
    by = bank.bytes_by_tier()
    assert by["fxp4"] < by["fxp8"] < by["fxp16"] < by["bf16"]
    assert by["fxp8"] == sum(
        leaf.nbytes for _, leaf in _leaves(bank.for_tier("fxp8"))
        if isinstance(leaf, QuantizedTensor))
    assert by["bf16"] == sum(leaf.numel() * leaf.element_size()
                             for _, leaf in _leaves(params))
    # each quantized tier's scale is the one amax over its qmax
    w8 = bank.for_tier("fxp8")["blocks"]["attn"]["wq"]
    w16 = bank.for_tier("fxp16")["blocks"]["attn"]["wq"]
    np.testing.assert_allclose(w8.scale.numpy() * 127,
                               w16.scale.numpy() * 32767, rtol=1e-6)


def test_tiered_weights_consume_drops_float_leaves():
    cfg = get_config("qwen2_5_14b").reduced()
    params = _port_tree(JM.init_params(cfg, jax.random.PRNGKey(0)))
    want = quantize_params(_port_tree(JM.init_params(
        cfg, jax.random.PRNGKey(0))), "fxp16")
    bank = TieredWeights(params, FLEET, consume=True)
    assert "wq" not in params["blocks"]["attn"]
    assert "lm_head" not in params and "embed" in params
    assert bank.source is params
    got = bank.for_tier("fxp16")["blocks"]["attn"]["wq"]
    assert torch.equal(got.data, want["blocks"]["attn"]["wq"].data)
    # a bank that serves bf16 keeps its source whole
    params = _port_tree(JM.init_params(cfg, jax.random.PRNGKey(0)))
    TieredWeights(params, ["fxp8", "bf16"], consume=True)
    assert "wq" in params["blocks"]["attn"]


def test_tiered_weights_errors_and_dedupe():
    cfg = get_config("qwen2_5_14b").reduced()
    params = _port_tree(JM.init_params(cfg, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="unknown precision tier"):
        TieredWeights(params, ["fxp8", "fxp7"])
    with pytest.raises(ValueError, match="at least one"):
        TieredWeights(params, [])
    bank = TieredWeights(params, ["fxp8", "fxp8", "bf16"])
    assert bank.tier_names == ("fxp8", "bf16")
    assert "fxp8" in bank and "fxp4" not in bank
    with pytest.raises(ValueError, match="fxp4"):
        bank.for_tier("fxp4")


# ---------------------------------------------------------------------------
# TierPolicy and the routing policies
# ---------------------------------------------------------------------------

def test_tier_policy_unit():
    tp = TierPolicy(["fxp16", "fxp8"])          # order normalises to ladder
    assert tp.ladder == ["fxp8", "fxp16"]
    assert tp.best == "fxp16" and tp.cheapest == "fxp8"
    lo = {"fxp8": 0.5, "fxp16": 0.5}
    hi = {"fxp8": 0.5, "fxp16": 1.5}
    r = Request(prompt=[1], max_new_tokens=1)
    assert tp.pick(r, lo) == "fxp16"
    assert tp.pick(r, hi) == "fxp8"            # degrade under pressure
    assert tp.pick(Request(prompt=[1], max_new_tokens=1, priority=1),
                   hi) == "fxp16"
    assert tp.pick(Request(prompt=[1], max_new_tokens=1, priority=-1),
                   lo) == "fxp8"
    assert tp.pick(Request(prompt=[1], max_new_tokens=1, tier="fxp8"),
                   lo) == "fxp8"
    assert tp.pick(r, {"fxp8": 2.0, "fxp16": 2.0}) == "fxp8"
    with pytest.raises(ValueError):
        TierPolicy([])
    with pytest.raises(ValueError):
        TierPolicy(["fxp8"], threshold=0.0)


def test_routing_policy_parse_errors():
    with pytest.raises(ValueError, match="unknown routing policy"):
        make_routing_policy("fastest-first")
    with pytest.raises(ValueError, match="stickiness"):
        PrefixAffinity(stickiness=-1)
    assert make_routing_policy("prefix-affinity",
                               stickiness=2).stickiness == 2


@pytest.fixture(scope="module")
def qwen():
    """Reduced Qwen2.5-14B: its float tree (port tensors, from the
    reference's seed) and the bank of the fleet's two tiers."""
    cfg = get_config("qwen2_5_14b").reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jp, TieredWeights(_port_tree(jp), FLEET)


def _prompt(i, plen, cfg):
    return np.random.default_rng(100 + i).integers(0, cfg.vocab,
                                                   plen).tolist()


def _reqs(cfg, n=6, gen=3, tier=None, priority=0):
    return [Request(prompt=_prompt(i, 4 + (i % 3) * 2, cfg),
                    max_new_tokens=gen, id=i, tier=tier, priority=priority)
            for i in range(n)]


KW = dict(max_slots=2, max_len=32, prefill_chunk=4, kv_block_size=4,
          device="cpu")


def _router(cfg, bank, tiers=FLEET, **over):
    return EngineRouter(cfg, bank, tiers=tiers, routing="tiered",
                        backend="kernels", **dict(KW, **over))


def _drive(target, reqs, audit=False):
    for r in reqs:
        target.submit(r)
    toks, tiers = {}, {}
    while target.has_work():
        for o in target.step():
            if o.finished:
                toks[o.id], tiers[o.id] = o.tokens, o.tier
        if audit:
            target.check_invariants()
    return toks, tiers


@pytest.mark.parametrize("tier", FLEET)
def test_pinned_tier_token_identical_to_single_engine(qwen, tier):
    """All requests pinned to one tier through the fleet == a single port
    engine at that tier's policy over the same bank, and never degraded."""
    cfg, _, bank = qwen
    eng = ServingEngine(cfg, bank.for_tier(tier),
                        policy=tier_policy(tier, backend="kernels"), **KW)
    anchor, _ = _drive(eng, _reqs(cfg))
    router = _router(cfg, bank)
    toks, served = _drive(router, _reqs(cfg, tier=tier), audit=True)
    assert toks == anchor
    assert set(served.values()) == {tier}
    st = router.stats()
    assert st["tier_degraded"] == 0 and st["tier_pinned"] == 6


def test_mixed_pins_each_served_at_their_tier(qwen):
    cfg, _, bank = qwen
    router = _router(cfg, bank)
    reqs = _reqs(cfg, n=6)
    for r in reqs:
        r.tier = FLEET[r.id % 2]
    _, served = _drive(router, reqs, audit=True)
    assert served == {r.id: r.tier for r in reqs}
    st = router.stats()
    assert st["tier_pinned"] == 6 and st["tier_degraded"] == 0
    assert st["tier_placed"] == {"fxp8": 3, "fxp16": 3}


def test_pressure_degradation_triggers_and_recovers(qwen):
    """2 slots per replica, threshold 1.0: the first two priority-0
    requests take the best tier, the overflow degrades, and a request
    after the fleet drains takes the best tier again."""
    cfg, _, bank = qwen
    router = _router(cfg, bank)
    _, served = _drive(router, _reqs(cfg, n=6), audit=True)
    st = router.stats()
    assert served[0] == served[1] == "fxp16"
    assert st["tier_degraded"] >= 2
    assert st["tier_placed"]["fxp8"] == st["tier_degraded"]
    late = Request(prompt=_prompt(99, 5, cfg), max_new_tokens=3, id=99)
    _, served_late = _drive(router, [late])
    assert served_late[99] == "fxp16"


def test_tier_threshold_and_priority_classes(qwen):
    cfg, _, bank = qwen
    router = _router(cfg, bank, tier_threshold=4.0)
    _, served = _drive(router, _reqs(cfg, n=6), audit=True)
    assert set(served.values()) == {"fxp16"}
    assert router.stats()["tier_degraded"] == 0
    _, hi = _drive(_router(cfg, bank), _reqs(cfg, n=4, priority=1))
    assert set(hi.values()) == {"fxp16"}
    _, lo = _drive(_router(cfg, bank), _reqs(cfg, n=4, priority=-1))
    assert set(lo.values()) == {"fxp8"}


def test_unknown_and_unsupported_tier_rejected_leak_free(qwen):
    cfg, _, bank = qwen
    router = _router(cfg, bank)
    before = (len(router.pending), len(router._active_ids),
              [e.load for e in router.engines])
    with pytest.raises(ValueError, match="unknown precision tier"):
        router.submit(Request(prompt=_prompt(0, 5, cfg), max_new_tokens=3,
                              tier="fxp999"))
    with pytest.raises(ValueError, match="fleet serves"):
        router.submit(Request(prompt=_prompt(0, 5, cfg), max_new_tokens=3,
                              tier="bf16"))
    assert (len(router.pending), len(router._active_ids),
            [e.load for e in router.engines]) == before
    assert router.submit(Request(prompt=_prompt(0, 5, cfg), max_new_tokens=3,
                                 tier="fxp8", id=0)) == 0
    with pytest.raises(ValueError, match="already pending or in flight"):
        router.submit(Request(prompt=_prompt(1, 5, cfg), max_new_tokens=3,
                              id=0, tier="fxp16"))


def test_router_ctor_validation(qwen):
    cfg, jp, bank = qwen
    params = _port_tree(jp)
    with pytest.raises(ValueError, match="requires a heterogeneous fleet"):
        EngineRouter(cfg, params, engines=2, routing="tiered", **KW)
    with pytest.raises(ValueError, match="not both"):
        EngineRouter(cfg, params, tiers=FLEET,
                     policy=PrecisionPolicy.bf16(), **KW)
    with pytest.raises(ValueError, match="unknown precision tier"):
        EngineRouter(cfg, params, tiers=["fxp8", "fxp7"], **KW)
    with pytest.raises(ValueError, match="no bank"):
        EngineRouter(cfg, bank, tiers=["fxp4", "fxp8"], **KW)
    with pytest.raises(ValueError, match="no bank"):
        EngineRouter(cfg, bank, tiers=FLEET, spec_decode="fxp4:fxp16", **KW)


def test_per_tier_fleet_stats(qwen):
    cfg, _, bank = qwen
    router = _router(cfg, bank)
    _drive(router, _reqs(cfg, n=5), audit=True)
    st = router.stats()
    assert st["tiers"] == FLEET
    assert [pe["tier"] for pe in st["per_engine"]] == FLEET
    assert sum(st["tier_placed"].values()) == 5 == sum(st["dispatched"])
    assert sum(pe["generated_tokens"] for pe in st["per_engine"]) \
        == st["generated_tokens"] == 15
    for tl in st["tier_loads"].values():
        assert tl["load"] == 0 and tl["capacity"] == 2
    router.submit(Request(prompt=_prompt(50, 5, cfg), max_new_tokens=3,
                          id=50, tier="fxp16"))
    router.step()
    assert router.tier_loads()["fxp16"]["load"] == 1


# untiered fleets of one FxP8 tier: one slot per replica, so a request's
# batch is itself alone wherever it lands and its tokens do not depend on
# placement (the per-tensor activation scale spans the batch)
ONE = dict(max_slots=1, max_len=32, prefill_chunk=4, device="cpu")


@pytest.fixture(scope="module")
def fxp8(qwen):
    cfg, _, bank = qwen
    return cfg, bank.for_tier("fxp8"), tier_policy("fxp8",
                                                   backend="kernels")


def _untiered(fxp8, routing="least-loaded", engines=2, **kw):
    cfg, params, pol = fxp8
    return EngineRouter(cfg, params, engines=engines, routing=routing,
                        policy=pol, **dict(ONE, **kw))


def _single(fxp8, reqs, **kw):
    cfg, params, pol = fxp8
    return _drive(ServingEngine(cfg, params, policy=pol, **dict(ONE, **kw)),
                  reqs)[0]


@pytest.mark.parametrize("routing", ["round-robin", "least-loaded",
                                     "prefix-affinity"])
def test_router_token_identical_and_spreads(fxp8, routing):
    cfg = fxp8[0]
    single = _single(fxp8, _reqs(cfg, n=6))
    router = _untiered(fxp8, routing)
    toks, served = _drive(router, _reqs(cfg, n=6), audit=True)
    assert toks == single and set(served.values()) == {"fxp8"}
    st = router.stats()
    assert sum(st["dispatched"]) == 6 and min(st["dispatched"]) > 0
    if routing == "round-robin":
        assert st["dispatched"] == [3, 3]


def test_prefix_affinity_sticks_without_a_prefix_cache(fxp8):
    """The port's engines have no prefix cache (`prefix_peek` is 0), so
    the router's sticky map alone steers a shared prefix: with a generous
    bound every request of it lands on one replica; with stickiness 0 it
    spills across the fleet."""
    cfg = fxp8[0]
    shared = _prompt(77, 8, cfg)
    reqs = [Request(prompt=shared + _prompt(i, 3, cfg), max_new_tokens=2,
                    id=i) for i in range(4)]
    router = _untiered(fxp8, "prefix-affinity", stickiness=8,
                       kv_block_size=4)
    assert all(e.prefix_peek(router._chain_keys(reqs[0].prompt)) == 0
               for e in router.engines)
    _drive(router, reqs)
    st = router.stats()
    assert sorted(st["dispatched"]) == [0, 4] and st["affinity_spills"] == 0
    reqs = [Request(prompt=shared + _prompt(i, 3, cfg), max_new_tokens=2,
                    id=i) for i in range(4)]
    router = _untiered(fxp8, "prefix-affinity", stickiness=0,
                       kv_block_size=4)
    _drive(router, reqs)
    st = router.stats()
    assert st["affinity_spills"] > 0 and min(st["dispatched"]) > 0


def test_least_loaded_holds_queue_when_saturated(fxp8):
    cfg = fxp8[0]
    router = _untiered(fxp8)
    for r in _reqs(cfg, n=5):
        router.submit(r)
    router.step()
    st = router.stats()
    assert st["pending_requests"] == 3          # 2 placed, 3 held
    assert all(pe["queue_depth"] == 0 for pe in st["per_engine"])
    done = {}
    while router.has_work():
        done.update({o.id: o.tokens for o in router.step() if o.finished})
        router.check_invariants()
    assert len(done) == 5 and router.stats()["pending_requests"] == 0


def test_abort_queued_at_router(fxp8):
    cfg = fxp8[0]
    baseline = _single(fxp8, [r for r in _reqs(cfg, n=4) if r.id != 3])
    router = _untiered(fxp8)
    for r in _reqs(cfg, n=4):
        router.submit(r)
    assert router.abort(3)
    events = []
    while router.has_work():
        events.extend(router.step())
        router.check_invariants()
    aborted = [o for o in events if o.id == 3]
    assert len(aborted) == 1 and aborted[0].finish_reason == "aborted"
    assert aborted[0].tokens == []
    assert {o.id: o.tokens for o in events
            if o.finished and o.id != 3} == baseline
    assert not router.abort(3)


def test_abort_in_flight_on_replica(fxp8):
    cfg = fxp8[0]
    baseline = _single(fxp8, [r for r in _reqs(cfg, n=4, gen=8)
                              if r.id != 1], kv_block_size=4)
    router = _untiered(fxp8, "round-robin", kv_block_size=4)
    for r in _reqs(cfg, n=4, gen=8):
        router.submit(r)
    events = []
    for _ in range(4):
        events.extend(router.step())
        router.check_invariants()
    assert router.abort(1)
    router.check_invariants()
    while router.has_work():
        events.extend(router.step())
        router.check_invariants()
    term = [o for o in events if o.id == 1 and o.finished]
    assert len(term) == 1 and term[0].finish_reason == "aborted"
    assert len(term[0].tokens) < 8
    assert {o.id: o.tokens for o in events
            if o.finished and o.id != 1} == baseline
    assert not router.abort(1)


def test_duplicate_submit_and_validation(fxp8):
    cfg = fxp8[0]
    router = _untiered(fxp8, "round-robin")
    router.submit(Request(prompt=_prompt(0, 5, cfg), max_new_tokens=2, id=7))
    with pytest.raises(ValueError, match="already pending or in flight"):
        router.submit(Request(prompt=_prompt(1, 5, cfg), max_new_tokens=2,
                              id=7))
    router.step()                                # placed on a replica
    with pytest.raises(ValueError, match="already pending or in flight"):
        router.submit(Request(prompt=_prompt(1, 5, cfg), max_new_tokens=2,
                              id=7))
    while router.has_work():
        router.step()
    assert router.submit(Request(prompt=_prompt(1, 5, cfg),
                                 max_new_tokens=2, id=7)) == 7
    with pytest.raises(ValueError, match="empty prompt"):
        router.submit(Request(prompt=[]))
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        router.submit(Request(prompt=_prompt(0, 5, cfg),
                              max_new_tokens=1000))


def test_router_stream_single_request(fxp8):
    cfg = fxp8[0]
    single = _single(fxp8, _reqs(cfg, n=3))
    router = _untiered(fxp8)
    for r in _reqs(cfg, n=3)[:2]:
        router.submit(r)
    seen = []
    for out in router.stream(_reqs(cfg, n=3)[2]):
        assert out.id == 2
        seen.extend(out.new_tokens)
    assert seen == single[2]
    assert {o.id: o.tokens for o in router.events() if o.finished} == {
        0: single[0], 1: single[1]}


# ---------------------------------------------------------------------------
# the reduced fleet against the reference's EngineRouter
# ---------------------------------------------------------------------------

FLEET_KW = dict(max_slots=2, max_len=16, prefill_chunk=4, kv_block_size=4)
PLENS, GEN = (7, 4, 10, 6, 9), 5


def _fleet_prompts(cfg):
    # a draw whose greedy decode meets no near-tie of the top logits on
    # either tier (seed 2's does: a last token of its second request)
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab, size=n).tolist() for n in PLENS]


@pytest.fixture(scope="module")
def reference_fleet(qwen):
    cfg, jp, _ = qwen
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(JExecutor, "flush", _race_free_flush(JExecutor.flush))
        router = JRouter(cfg, jp, tiers=FLEET, routing="tiered", **FLEET_KW)
        done = router.run([JRequest(prompt=p, max_new_tokens=GEN, id=i)
                           for i, p in enumerate(_fleet_prompts(cfg))])
        st = router.stats()
    return ({f.id: f.tokens for f in done}, {f.id: f.tier for f in done},
            st["tier_placed"])


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_fleet_matches_reference_router(qwen, reference_fleet, backend):
    cfg, _, bank = qwen
    want_toks, want_tiers, want_placed = reference_fleet
    router = EngineRouter(cfg, bank, tiers=FLEET, routing="tiered",
                          backend=backend, device="cpu", **FLEET_KW)
    done = router.run([Request(prompt=p, max_new_tokens=GEN, id=i)
                       for i, p in enumerate(_fleet_prompts(cfg))])
    router.check_invariants()
    assert {f.id: f.tier for f in done} == want_tiers
    assert set(want_tiers.values()) == set(FLEET)       # both tiers served
    assert router.stats()["tier_placed"] == want_placed
    assert {f.id: f.tokens for f in done} == want_toks
    assert all(len(t) == GEN for t in want_toks.values())


def test_serve_cli_fleet_reports_tiers(capsys):
    """`--tiers` on the CPU: one bank, both replicas, the placements and
    the per-mode GEMM launches (0 on the CPU: the plain versions)."""
    tserve.main(["--arch", "qwen2_5_14b", "--reduced", "--device", "cpu",
                 "--tiers", "fxp8,fxp16", "--routing", "tiered",
                 "--kv-block-size", "4", "--requests", "3", "--slots", "1",
                 "--prompt-len", "6", "--gen", "2", "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "tiered weight banks: fxp8" in out and "fxp16" in out
    # one slot each: the first request takes fxp16, the second degrades,
    # the third waits at the router for the first free slot (fxp16's)
    assert "tiers: placed {fxp8: 1, fxp16: 2}, 0 pinned, 1 degraded" in out
    assert "fxp_gemm_fused launches by mode: int8 0" in out
    assert "engine 1 [fxp16]: 2 requests" in out
