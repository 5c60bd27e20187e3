"""PyTorch port, serving the SSM (Mamba2-370M) and hybrid (Zamba2-1.2B)
families: the port's `ServingEngine` against the JAX reference's engine
(greedy, reduced models under flexpe(8), quantize-once weights, 2 slots,
3 requests of mixed length, so the third reuses a slot and its recurrent
state must be reset), the port's layouts and loop modes against each
other, and the executor's SSM row reset, checkpoint and restore against
the reference executor's (CPU).

The reference engine runs on its Pallas backend (interpret mode), whose
CORDIC gate snaps in f32 as the port's does, eagerly (compiled, it drifts
from its own eager arithmetic: ROADMAP.md queue 3) with each Pallas entry
compiled once (`test_torch_ssm.eager_reference`), and with copied
uploads (`test_torch_serving._race_free_flush`). Its tokens here are
bit-equal to the port's: the SSM layers are bit-equal (tests/
test_torch_ssm.py), and Zamba2's two attention applications per step
stay inside the greedy margin on this draw.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import PrecisionPolicy as JPolicy
from repro.core.qtensor import quantize_params as jquantize_params
from repro.models import model as JM
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving.executor import ModelExecutor as JExecutor
from repro_torch.convert import from_numpy_tree
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.executor import ModelExecutor
from test_torch_model import numpy_tree
from test_torch_serving import _race_free_flush
from test_torch_ssm import eager_reference

PLENS, GEN = (7, 4, 10), 4
ENGINE_KW = dict(max_slots=2, max_len=16, prefill_chunk=4)
FAMILIES = ("mamba2_370m", "zamba2_1p2b")


def _prompts(cfg):
    rng = np.random.default_rng(2)
    return [rng.integers(0, cfg.vocab, size=n).tolist() for n in PLENS]


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(cfg, reference params, port params, the reference engine's tokens:
    paged (block 4; a no-op for Mamba2, which has no KV), sync loop)."""
    cfg = get_config(request.param).reduced()
    jparams = jquantize_params(JM.init_params(cfg, jax.random.PRNGKey(0)),
                               "fxp8")
    with pytest.MonkeyPatch.context() as mp, eager_reference():
        mp.setattr(JExecutor, "flush", _race_free_flush(JExecutor.flush))
        eng = JEngine(cfg, jparams,
                      policy=JPolicy.flexpe(8, backend="pallas-interpret"),
                      kv_block_size=4, **ENGINE_KW)
        done = eng.run([JRequest(prompt=p, max_new_tokens=GEN, id=i)
                        for i, p in enumerate(_prompts(cfg))])
    return (cfg, jparams, from_numpy_tree(numpy_tree(jparams)),
            [f.tokens for f in done])


def _port_engine(family, backend="kernels", **kw):
    cfg, _, tparams, _ = family
    return ServingEngine(cfg, tparams,
                         policy=TPolicy.flexpe(8, backend=backend),
                         device="cpu", **dict(ENGINE_KW, **kw))


def _port_tokens(family, backend="kernels", **kw):
    eng = _port_engine(family, backend, **kw)
    done = eng.run([Request(prompt=p, max_new_tokens=GEN, id=i)
                    for i, p in enumerate(_prompts(family[0]))])
    eng.check_invariants()
    return [f.tokens for f in done], eng


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_engine_matches_reference_engine(family, backend):
    tokens, eng = _port_tokens(family, backend, kv_block_size=4)
    assert tokens == family[3]
    assert eng.ex.has_ssm and eng.sched.has_ssm
    assert eng.paged == (family[0].family == "hybrid")


@pytest.mark.parametrize("layout,overlap", [
    ("contiguous", False), ("paged", True), ("contiguous", True)])
def test_engine_layouts_and_loop_modes_agree(family, layout, overlap):
    kw = {"overlap": overlap}
    if layout == "paged":
        kw["kv_block_size"] = 4
    assert _port_tokens(family, **kw)[0] == family[3]


def test_reset_ssm_row_across_slot_reuse(family):
    """One slot, three requests one after another: each request's tokens
    are those of the same request served alone, so admission zeroes the
    recurrent state and conv window the previous request left in the
    slot; each admission is one queued reset applied at the next flush."""
    cfg = family[0]
    prompts = _prompts(cfg)
    eng = _port_engine(family, max_slots=1)
    resets = []
    orig = eng.ex.reset_ssm_row
    eng.ex.reset_ssm_row = lambda row: (resets.append(row), orig(row))
    shared = [f.tokens for f in eng.run(
        [Request(prompt=p, max_new_tokens=GEN, id=i)
         for i, p in enumerate(prompts)])]
    assert resets == [0, 0, 0]
    alone = [_port_engine(family, max_slots=1).run(
        [Request(prompt=p, max_new_tokens=GEN)])[0].tokens for p in prompts]
    assert shared == alone
    # the state a finished request leaves behind is not zero, so the
    # reset is what made the difference
    assert any(a.abs().sum() > 0 for a in eng.ex.cache["ssm"])


def _ssm_fill(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def test_executor_ssm_rows_reset_checkpoint_restore_like_reference(family):
    """`reset_ssm_row` + `flush` zeroes exactly the queued rows (one
    device update for all of them), `checkpoint_ssm` is a copy, and
    `restore_ssm_rows` rewinds exactly the named rows: the same arrays as
    the reference executor's on the same state."""
    cfg, jparams, tparams, _ = family
    kw = dict(max_slots=3, max_len=8, prefill_chunk=4)
    jex = JExecutor(cfg, jparams, policy=JPolicy.flexpe(8), **kw)
    tex = ModelExecutor(cfg, tparams, policy=TPolicy.flexpe(8),
                        device="cpu", **kw)
    shapes = [tuple(a.shape) for a in tex.cache["ssm"]]
    assert shapes == [tuple(a.shape) for a in jex.cache["ssm"]]

    def load(vals):
        jex.cache["ssm"] = tuple(
            jax.numpy.asarray(v).astype(a.dtype)
            for v, a in zip(vals, jex.cache["ssm"]))
        for a, v in zip(tex.cache["ssm"], vals):
            a.copy_(torch.from_numpy(v))

    def same():
        for t, j in zip(tex.cache["ssm"], jex.cache["ssm"]):
            np.testing.assert_array_equal(
                t.float().numpy(), np.asarray(j.astype(np.float32)))

    load(_ssm_fill(shapes, 0))
    for ex in (jex, tex):
        before = ex.h2d_updates
        ex.reset_ssm_row(2)
        ex.reset_ssm_row(0)
        ex.reset_ssm_row(2)
        ex.flush()
        assert ex.h2d_updates == before + 1
    same()
    assert all((a[:, [0, 2]] == 0).all() and (a[:, 1] != 0).any()
               for a in tex.cache["ssm"])
    saved_j, saved_t = jex.checkpoint_ssm(), tex.checkpoint_ssm()
    load(_ssm_fill(shapes, 1))
    jex.restore_ssm_rows([2, 1], saved_j)
    tex.restore_ssm_rows([2, 1], saved_t)
    same()
    # the checkpoint is a copy, not a view of the live cache
    assert all(s.data_ptr() != a.data_ptr()
               for s, a in zip(saved_t, tex.cache["ssm"]))
