"""PyTorch port, prefix caching with copy-on-write on the paged pool: the
port's versions of the reference's tests/test_prefix_cache.py cases
(CPU), and the port's prefix-cached engine against the reference's.

  * cold (paged, no cache) == warm (prefix cache) == overlapped (prefix
    cache, overlap loop) == contiguous, per family: f32 weights without
    a policy, as the reference's case, and flexpe(8) with quantize-once
    weights and the int8 KV pool (codes and per-position scales shared);
    on the SSM and hybrid families the flag does nothing;
  * the port's prefix-cached engine (sync and overlap) against the
    reference's, under flexpe(8), reduced Qwen2.5-14B (compiled, plain
    backend, as tests/test_torch_serving.py) and DeepSeekMoE-16B (Pallas
    backend, eager: tests/test_torch_ssm.py), both with copied uploads;
  * the exact counts of skipped matched blocks, the CoW fork of a
    fully matched prompt (the writer diverges, the cached blocks and
    later readers do not), `copy_pool_blocks`, cached blocks kept out of
    the free list, LRU eviction under pressure, reservation with cached
    residency, per-tick control-array updates, and the ledger invariants
    after every tick;
  * `--prefix-cache/--shared-prefix` through the serve CLI;
  * prefix-affinity routing steered by the replicas' real prefix peeks.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import PrecisionPolicy as JPolicy
from repro.core.qtensor import quantize_params as jquantize_params
from repro.models import model as JM
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving.executor import ModelExecutor as JExecutor
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.core.qtensor import quantize_params
from repro_torch.models import model as M
from repro_torch.serving import EngineRouter, Request, ServingEngine
from test_torch_model import numpy_tree
from test_torch_serving import _race_free_flush
from test_torch_ssm import eager_reference

ARCHS = ("qwen2_5_14b", "deepseek_moe_16b", "mamba2_370m", "zamba2_1p2b")
KW = dict(max_slots=2, max_len=24, prefill_chunk=4)


def _prompt(i, plen, cfg, shared=0, system_seed=2):
    """`shared` leading tokens common to every i, then `plen` of its own."""
    system = np.random.default_rng(system_seed).integers(0, cfg.vocab, shared)
    tail = np.random.default_rng(100 + i).integers(0, cfg.vocab, plen)
    return np.concatenate([system, tail]).tolist()


def _req(i, plen, cfg, gen=4, shared=0, **kw):
    return Request(prompt=_prompt(i, plen, cfg, shared), max_new_tokens=gen,
                   id=i, **kw)


def _drain_checked(eng, reqs):
    """Run to completion through the event stream, checking the ledger
    after every tick, overlapped ticks included."""
    for r in reqs:
        eng.submit(r)
    done = {}
    while eng.has_work():
        for out in eng.step():
            if out.finished:
                done[out.id] = out.tokens
        eng.check_invariants()
    return done


_PARAMS = {}


def _params(arch, quantized=False):
    """Port params from seed 0: f32, or bf16 with FxP8 quantize-once
    weights."""
    key = (arch, quantized)
    if key not in _PARAMS:
        cfg = get_config(arch).reduced()
        if quantized:
            _PARAMS[key] = quantize_params(M.init_params(cfg, 0, device="cpu"),
                                           "fxp8")
        else:
            _PARAMS[key] = M.init_params(cfg, 0, device="cpu",
                                         dtype=torch.float32)
    return _PARAMS[key]


def _engine(arch, quantized=False, **kw):
    cfg = get_config(arch).reduced()
    pol = TPolicy.flexpe(8) if quantized else None
    return ServingEngine(cfg, _params(arch, quantized), policy=pol,
                         device="cpu", **dict(KW, **kw))


# ---------------------------------------------------------------------------
# bit-exactness per family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True],
                         ids=["f32", "fxp8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_shared_prefix_decode_matches_cold(arch, quantized):
    cfg = get_config(arch).reduced()
    lens = [(0, 3), (1, 7), (2, 5), (3, 2)]

    def run(**kw):
        eng = _engine(arch, quantized, **kw)
        return _drain_checked(eng, [_req(i, pl, cfg, shared=8)
                                    for i, pl in lens]), eng

    cont, _ = run()
    cold, _ = run(kv_block_size=4)
    ovl, _ = run(kv_block_size=4, prefix_cache=True, overlap=True)
    warm, eng = run(kv_block_size=4, prefix_cache=True)
    assert cont == cold == warm == ovl
    st = eng.stats()
    if cfg.family in ("dense", "moe"):
        assert st["prefix_tokens_reused"] > 0
        assert st["prefill_tokens_computed"] < st["prompt_tokens"]
    else:                          # a recurrent state: the flag does nothing
        assert "prefix_cache" not in st and st["prefix_tokens_reused"] == 0
        assert eng.prefix_peek(["x"]) == 0


# ---------------------------------------------------------------------------
# against the reference's prefix-cached engine
# ---------------------------------------------------------------------------

REF_LENS = [(0, 3), (1, 6), (2, 4)]


@pytest.fixture(scope="module", params=["qwen2_5_14b", "deepseek_moe_16b"])
def reference_prefix_run(request):
    """The reference engine with the prefix cache (paged, block 4, sync
    loop, copied uploads) under flexpe(8): -> (arch, cfg, port params,
    tokens by id, its prefix figures)."""
    arch = request.param
    cfg = jget_config(arch).reduced()
    jparams = jquantize_params(JM.init_params(cfg, jax.random.PRNGKey(0)),
                               "fxp8")
    moe = cfg.family == "moe"
    pol = JPolicy.flexpe(8, backend="pallas-interpret" if moe
                         else "reference")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JExecutor, "flush", _race_free_flush(JExecutor.flush))
        with eager_reference() if moe else contextlib.nullcontext():
            eng = JEngine(cfg, jparams, policy=pol, kv_block_size=4,
                          prefix_cache=True, **KW)
            done = eng.run([JRequest(prompt=_prompt(i, pl, cfg, 8),
                                     max_new_tokens=4, id=i)
                            for i, pl in REF_LENS])
    st = eng.stats()
    figures = {k: st[k] for k in ("prefix_tokens_reused",
                                  "prefill_tokens_computed", "cow_copies")}
    return (arch, cfg, from_numpy_tree(numpy_tree(jparams)),
            {f.id: f.tokens for f in done}, figures)


@pytest.mark.parametrize("overlap", [False, True])
def test_prefix_engine_matches_reference_engine(reference_prefix_run,
                                                overlap):
    arch, cfg, tparams, want, figures = reference_prefix_run
    eng = ServingEngine(cfg, tparams, policy=TPolicy.flexpe(8),
                        device="cpu", kv_block_size=4, prefix_cache=True,
                        overlap=overlap, **KW)
    got = _drain_checked(eng, [_req(i, pl, cfg, shared=8)
                               for i, pl in REF_LENS])
    assert got == want
    st = eng.stats()
    assert {k: st[k] for k in figures} == figures
    assert figures["prefix_tokens_reused"] > 0


# ---------------------------------------------------------------------------
# skipped blocks, CoW
# ---------------------------------------------------------------------------

def test_prefill_skips_matched_blocks():
    """Serial identical-prefix requests through one slot: followers start
    prefill at the matched block boundary."""
    cfg = get_config("qwen2_5_14b").reduced()
    eng = _engine("qwen2_5_14b", max_slots=1, kv_block_size=4,
                  prefix_cache=True)
    done = _drain_checked(eng, [_req(i, 3, cfg, shared=8) for i in range(4)])
    assert len(done) == 4
    st = eng.stats()
    # 4 requests x 11 prompt tokens; followers each matched 8 (2 blocks)
    assert st["prompt_tokens"] == 44
    assert st["prefix_tokens_reused"] == 3 * 8
    assert st["prefill_tokens_computed"] == 44 - 3 * 8
    assert st["prefix_cache"]["hits"] >= 6


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "fxp8"])
def test_cow_fork_writer_diverges_reader_unchanged(quantized):
    """An 8-token prompt is two full blocks: followers match all of it,
    recompute only its last token, and append into a CoW fork of the last
    shared block; every follower still decodes the cold run's tokens."""
    cfg = get_config("qwen2_5_14b").reduced()
    ref = _engine("qwen2_5_14b", quantized, max_slots=1).run(
        [_req(0, 0, cfg, shared=8)])
    eng = _engine("qwen2_5_14b", quantized, max_slots=1, kv_block_size=4,
                  prefix_cache=True)
    done = _drain_checked(eng, [_req(i, 0, cfg, shared=8) for i in range(3)])
    assert all(done[i] == ref[0].tokens for i in range(3))
    st = eng.stats()
    assert st["cow_copies"] == 2          # both followers forked the tail
    assert st["prefix_tokens_reused"] == 2 * 7   # a full match caps at P-1


def test_cow_pool_copy_preserves_source_block():
    """`copy_pool_blocks` forks dst <- src across codes and per-position
    scales of every layer, touching no other block."""
    cfg = get_config("qwen2_5_14b").reduced()
    cache = M.init_cache(cfg, 2, 16, TPolicy.flexpe(8), kv_block_size=4,
                         device="cpu")
    gen = torch.Generator().manual_seed(0)
    for name, leaf in cache["kv"].items():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen))
        else:
            leaf.copy_(torch.rand(leaf.shape, generator=gen))
    before = {n: a.clone() for n, a in cache["kv"].items()}
    out = M.copy_pool_blocks(cache, [1], [3])
    keep = [b for b in range(before["k"].shape[1]) if b != 3]
    for name, a in out["kv"].items():
        assert torch.equal(a[:, 3], before[name][:, 1]), name
        assert torch.equal(a[:, keep], before[name][:, keep]), name


# ---------------------------------------------------------------------------
# refcounted release, LRU eviction, reservation
# ---------------------------------------------------------------------------

def test_release_keeps_cached_blocks_out_of_free_list():
    cfg = get_config("qwen2_5_14b").reduced()
    eng = _engine("qwen2_5_14b", max_slots=1, kv_block_size=4,
                  prefix_cache=True)
    _drain_checked(eng, [_req(0, 3, cfg, shared=8)])
    st = eng.stats()
    assert st["cached_blocks"] == 2               # the two full blocks
    assert st["held_blocks"] == 0
    assert st["free_blocks"] == st["kv_blocks"] - 2
    assert st["committed_blocks"] == 0


def test_eviction_under_pressure_leaves_no_stale_kv():
    """A 5-block pool cannot keep two prefixes cached: alternating them
    evicts on every admission after the first, and recycled blocks decode
    like solo runs."""
    cfg = get_config("qwen2_5_14b").reduced()

    def req(i, system_seed):
        return Request(prompt=_prompt(i, 3, cfg, 8, system_seed),
                       max_new_tokens=4, id=i)

    eng = _engine("qwen2_5_14b", max_slots=1, kv_block_size=4, kv_blocks=5,
                  prefix_cache=True)
    for i, system in enumerate((2, 3, 2)):
        done = _drain_checked(eng, [req(i, system)])
        solo = _engine("qwen2_5_14b", max_slots=1).run([req(i, system)])
        assert done[i] == solo[0].tokens, i
    assert eng.stats()["prefix_cache"]["evictions"] > 0


def test_reservation_still_queues_with_cache_resident():
    cfg = get_config("qwen2_5_14b").reduced()
    eng = _engine("qwen2_5_14b", max_slots=2, kv_block_size=4, kv_blocks=6,
                  prefix_cache=True)
    # each needs ceil((8 + 1 + 4) / 4) = 4 blocks: one at a time
    done = _drain_checked(eng, [_req(i, 1, cfg, shared=8) for i in range(3)])
    assert len(done) == 3
    for i in range(3):
        solo = _engine("qwen2_5_14b", max_slots=1).run(
            [_req(i, 1, cfg, shared=8)])
        assert done[i] == solo[0].tokens, i


# ---------------------------------------------------------------------------
# control-array updates and the ledger
# ---------------------------------------------------------------------------

def test_control_updates_coalesce_per_tick():
    cfg = get_config("qwen2_5_14b").reduced()
    eng = _engine("qwen2_5_14b", max_slots=4, prefill_chunk=8,
                  kv_block_size=4, prefix_cache=True)
    for i in range(4):
        eng.submit(_req(i, 8, cfg))
    before = eng.stats()["h2d_updates"]
    eng.step()          # 4 admissions, 2 blocks each
    assert eng.stats()["h2d_updates"] - before <= 2
    before = eng.stats()["h2d_updates"]
    eng.step()
    assert eng.stats()["h2d_updates"] - before <= 1
    while eng.has_work():
        eng.step()
        eng.check_invariants()


@pytest.mark.parametrize("overlap", [False, True])
def test_ledger_invariants_after_every_tick(overlap):
    cfg = get_config("qwen2_5_14b").reduced()
    eng = _engine("qwen2_5_14b", True, kv_block_size=4, prefix_cache=True,
                  overlap=overlap)
    for r in [_req(i, 3 + i, cfg, shared=4) for i in range(4)]:
        eng.submit(r)
    while eng.has_work():
        eng.step()
        st = eng.stats()
        assert (st["free_blocks"] + st["held_blocks"]
                + st["cached_blocks"] == st["kv_blocks"])
        assert st["committed_blocks"] >= 0
        eng.check_invariants()
    assert eng.stats()["prefix_tokens_reused"] > 0


def test_prefix_cache_needs_paged_layout():
    with pytest.raises(ValueError, match="prefix_cache requires"):
        _engine("qwen2_5_14b", prefix_cache=True)


# ---------------------------------------------------------------------------
# the serve CLI and the router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2_5_14b", "zamba2_1p2b"])
def test_serve_cli_prefix_cache(capsys, arch):
    from repro_torch.launch import serve as serve_cli
    argv = ["--arch", arch, "--reduced", "--device", "cpu",
            "--kv-block-size", "4", "--requests", "4", "--slots", "2",
            "--prompt-len", "8", "--gen", "3", "--prefill-chunk", "4",
            "--shared-prefix", "8"]
    cold = serve_cli.main(argv)
    capsys.readouterr()
    warm = serve_cli.main(argv + ["--prefix-cache"])
    out = capsys.readouterr().out
    assert [o.tokens for o in warm] == [o.tokens for o in cold]
    assert all(o.prompt_len == 16 for o in warm)
    if arch == "qwen2_5_14b":
        line = next(ln for ln in out.splitlines()
                    if ln.startswith("prefix cache: "))
        assert int(line.split()[2]) > 0          # prompt tokens reused
    else:
        assert "prefix cache: " not in out


def test_prefix_affinity_routes_by_real_peeks():
    """Two replicas with prefix caches: once one of them holds a prefix,
    a request sharing it goes there by that replica's `prefix_peek` alone
    (the router's sticky map emptied) and reuses its blocks."""
    cfg = get_config("qwen2_5_14b").reduced()
    router = EngineRouter(cfg, _params("qwen2_5_14b", True), engines=2,
                          policy=TPolicy.flexpe(8), routing="prefix-affinity",
                          device="cpu", kv_block_size=4, prefix_cache=True,
                          **KW)
    # a request without the prefix first, so least-loaded placement
    # would send the next one elsewhere than the holder
    router.run([_req(0, 9, cfg, shared=0), _req(1, 3, cfg, shared=8)])
    keys = router._chain_keys(_prompt(2, 3, cfg, 8))
    peeks = [e.prefix_peek(keys) for e in router.engines]
    holder = int(np.argmax(peeks))
    assert peeks[holder] == 2 and peeks[1 - holder] == 0
    router._sticky.clear()
    out = router.run([_req(2, 3, cfg, shared=8)])
    assert router.dispatched[holder] == 2
    assert out[0].prefix_hit_tokens == 8
    st = router.stats()
    assert st["prefix_tokens_reused"] == 8
    assert st["per_engine"][holder]["prefix_hit_rate"] > 0
