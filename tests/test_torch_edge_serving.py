"""PyTorch port, slice 3 serving: the port's `ServingEngine` against the
JAX reference's engine with the same layout and flags (greedy, reduced
Qwen2.5-14B, 2 slots, 3 requests of mixed length) under edge4 (packed
FxP4 weights) and under integer attention (`flexpe(8, af_impl="exact")`
with `int_attention=True`), on the port's kernels backend (the plain
versions on the CPU) (CPU).

The reference engine runs eagerly (`jax.disable_jit`) with copied uploads,
for the reasons tests/test_torch_edge.py and tests/test_torch_serving.py
give. Each layout is held against the reference's run of the same layout:
under edge4 the reference's own paged and contiguous engines give other
tokens for the request that follows a finished one. A released contiguous
row keeps its stale K/V, its idle attention output enters the per-tensor
FxP4 activation scale of the next GEMM, and at seven levels that moves the
active rows' codes (zeroing the released row makes the layouts agree;
ROADMAP.md queue 3). The port does the same on both layouts."""
import dataclasses

import jax
import numpy as np
import pytest

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
from test_torch_serving import _race_free_flush, numpy_tree

POLICIES = {
    "edge4": (JPolicy.edge4(), TPolicy.edge4(backend="kernels"), "fxp4"),
    "int-attention": (
        dataclasses.replace(JPolicy.flexpe(8, af_impl="exact"),
                            int_attention=True),
        dataclasses.replace(TPolicy.flexpe(8, af_impl="exact",
                                           backend="kernels"),
                            int_attention=True),
        "fxp8"),
}
PLENS, GEN = (7, 4, 10), 5
ENGINE_KW = dict(max_slots=2, max_len=16, prefill_chunk=4)
LAYOUTS = {"paged": dict(kv_block_size=4), "contiguous": {}}


def _prompts(cfg):
    # a draw whose greedy decode meets no near-tie of the top logits under
    # either policy (tests/test_torch_serving.py says why that matters)
    rng = np.random.default_rng(2)
    return [rng.integers(0, cfg.vocab, size=n).tolist() for n in PLENS]


@pytest.fixture(scope="module", params=sorted(POLICIES))
def model(request):
    jpol, tpol, fmt = POLICIES[request.param]
    cfg = get_config("qwen2_5_14b").reduced()
    jparams = jquantize_params(JM.init_params(cfg, jax.random.PRNGKey(0)),
                               fmt)
    return cfg, jparams, from_numpy_tree(numpy_tree(jparams)), jpol, tpol


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_engine_matches_reference_engine(model, layout):
    cfg, jparams, tparams, jpol, tpol = model
    kw = dict(ENGINE_KW, **LAYOUTS[layout])
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(JExecutor, "flush", _race_free_flush(JExecutor.flush))
        eng = JEngine(cfg, jparams, policy=jpol, **kw)
        want = [f.tokens for f in eng.run(
            [JRequest(prompt=p, max_new_tokens=GEN, id=i)
             for i, p in enumerate(_prompts(cfg))])]
    eng = ServingEngine(cfg, tparams, policy=tpol, device="cpu", **kw)
    done = eng.run([Request(prompt=p, max_new_tokens=GEN, id=i)
                    for i, p in enumerate(_prompts(cfg))])
    eng.check_invariants()
    assert [f.tokens for f in done] == want
    assert all(len(t) == GEN for t in want)
