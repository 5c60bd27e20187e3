"""PyTorch port, slice 4: DeepSeekMoE-16B under edge4 — packed FxP4 expert
banks on the batched GEMM's packed mode — port against the JAX reference
package on the same seeded inputs (CPU).

  * `fxp_gemm_fused_batched(..., packed=True)`'s plain version against the
    reference's per-expert loop of `fxp_gemm_fused_pallas(..., packed=True)`
    in interpret mode (its `expert_matmul` loops the per-expert packed
    GEMMs): bit-equal, with and without the fused SiLU, with an empty
    expert queue and ragged N. Integer sums do not depend on order.
  * `dispatch.expert_matmul` on a packed quantize-once bank under edge4,
    both port backends against the reference's on its Pallas backend:
    bit-equal.
  * `moe_ffn` under edge4 (FxP4 router softmax, FxP4-stage CORDIC SiLU,
    packed banks and shared experts): both port backends bit-equal to the
    reference's on its Pallas backend (interpret mode), the same routing.
    Router probabilities on the FxP4 grid tie far more often than at
    FxP8; `moe.top_k` breaks ties toward the lower index as JAX does.
  * Reduced DeepSeekMoE-16B under edge4: one prefill block and three
    greedy decode steps, teacher-forced with the reference's tokens,
    logits within 10% of their range per step; greedy tokens equal where
    the reference's top two logits are further apart than twice the
    step's largest difference, as tests/test_torch_moe.py holds FxP8.
    The reference runs eagerly (`jax.disable_jit`; ROADMAP.md queue 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import PrecisionPolicy as JPolicy
from repro.core.qtensor import quantize_params as jquantize_params
from repro.kernels import dispatch as jdispatch
from repro.kernels.fxp_gemm.fxp_gemm import fxp_gemm_fused_pallas
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch.convert import from_numpy_tree
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels.fxp_gemm.fxp_gemm import fxp_gemm_fused_batched
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from test_torch_edge import _f32, _t
from test_torch_serving import numpy_tree

JPAL4 = JPolicy.edge4(backend="pallas-interpret")


@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("af", [None, "silu"])
def test_packed_batched_plain_bit_equal_to_reference_loop(af, n):
    rng = np.random.default_rng(n + 3)
    e, m, k = 4, 8, 256
    x = rng.integers(-8, 8, (e, m, k)).astype(np.int8)
    x[1] = 0                                     # an empty expert queue
    wb = rng.integers(-128, 128, (e, k, n // 2)).astype(np.int8)
    scale = (rng.random((e, 1, n)) * 1e-2).astype(np.float32)
    want = np.stack([np.asarray(fxp_gemm_fused_pallas(
        jnp.asarray(x[i]), jnp.asarray(wb[i]), jnp.asarray(scale[i]),
        packed=True, af=af, hr_stages=4, lv_stages=4, blocks=(m, n, 128),
        interpret=True)) for i in range(e)])
    got = fxp_gemm_fused_batched(_t(x), _t(wb), _t(scale), af=af,
                                 hr_stages=4, lv_stages=4, packed=True)
    assert got.shape == (e, m, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def cfg():
    return get_config("deepseek_moe_16b").reduced()


@pytest.fixture(scope="module")
def moe_params(cfg):
    jp = jquantize_params(jmoe.moe_init(jax.random.PRNGKey(0), cfg), "fxp4")
    tp = from_numpy_tree(numpy_tree(jp))
    assert tp["w1"].packed and tp["w1"].data.dtype == torch.int32
    return jp, tp


def _bf16_input(shape, seed):
    x = jnp.asarray(np.random.default_rng(seed).normal(size=shape)
                    ).astype(jnp.bfloat16)
    return x, _t(x)


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_packed_expert_matmul_matches_reference(cfg, moe_params, backend):
    jp, tp = moe_params
    jx, tx = _bf16_input((1, cfg.n_experts, 4, cfg.d_model), seed=5)
    want = jdispatch.expert_matmul(jx, jp["w1"], JPAL4, "pallas-interpret")
    got = tdispatch.expert_matmul(tx, tp["w1"], TPolicy.edge4(backend=backend),
                                  backend=backend)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


@pytest.mark.parametrize("backend", ["reference", "kernels"])
@pytest.mark.parametrize("shape", [(1, 4), (2, 8)])
def test_moe_ffn_edge4_matches_reference(cfg, moe_params, backend, shape):
    jp, tp = moe_params
    jx, tx = _bf16_input(shape + (cfg.d_model,), seed=sum(shape))
    want, _ = jmoe.moe_ffn(jp, jx, cfg, JPAL4, dropless=True)
    got = tmoe.moe_ffn(tp, tx, cfg, TPolicy.edge4(backend=backend),
                       dropless=True)
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


CHUNK, SLOTS, MAX_LEN, BS = 8, 2, 24, 4


def _tables():
    nb = SLOTS * (MAX_LEN // BS)
    tables = np.full((SLOTS, MAX_LEN // BS), nb, np.int32)
    tables[0] = [5, 0, 3, 7, 9, 11]
    tables[1] = [1, 4, 6, 2, 8, 10]
    return tables


@pytest.fixture(scope="module")
def model(cfg):
    jparams = jquantize_params(JM.init_params(cfg, jax.random.PRNGKey(0)),
                               "fxp4")
    return jparams, from_numpy_tree(numpy_tree(jparams))


@pytest.fixture(scope="module")
def reference_steps(cfg, model):
    """The reference's ragged prefill block then three greedy decode
    steps, eager: [(tokens, n_valid, last-position logits)] per step."""
    jparams, _ = model
    jcache = JM.init_cache(cfg, SLOTS, MAX_LEN, JPAL4, kv_block_size=BS)
    jcache["block_tables"] = jnp.asarray(_tables())
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (SLOTS, CHUNK))
    n_valid = np.array([CHUNK, 6], np.int32)
    steps = []
    with jax.disable_jit():
        for _ in range(4):
            jl, jcache = JM.decode_step(cfg, jparams, jcache,
                                        jnp.asarray(tokens, jnp.int32),
                                        policy=JPAL4,
                                        n_valid=jnp.asarray(n_valid),
                                        last_only=True)
            jl = _f32(jl)[:, -1, :cfg.vocab]
            steps.append((tokens, n_valid, jl))
            tokens = jl.argmax(-1)[:, None].astype(np.int64)
            n_valid = np.ones((SLOTS,), np.int32)
    return steps


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_moe_edge4_prefill_then_greedy_decode_matches_reference(
        cfg, model, reference_steps, backend):
    _, tparams = model
    tpol = TPolicy.edge4(backend=backend)
    tcache = TM.init_cache(cfg, SLOTS, MAX_LEN, tpol, kv_block_size=BS,
                           device="cpu")
    tcache["block_tables"] = torch.from_numpy(_tables())
    rows = np.arange(SLOTS)
    for step, (tokens, n_valid, jl) in enumerate(reference_steps):
        tl, tcache = TM.decode_step(cfg, tparams, tcache,
                                    torch.from_numpy(tokens), policy=tpol,
                                    n_valid=torch.from_numpy(n_valid),
                                    last_only=True)
        tl = tl.float().numpy()[:, -1, :cfg.vocab]
        diff = np.abs(tl - jl).max()
        assert diff <= 0.1 * np.abs(jl).max(), f"step {step}"
        jt, tt = jl.argmax(-1), tl.argmax(-1)
        top2 = np.sort(jl, -1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 2 * diff
        np.testing.assert_array_equal(tt[decided], jt[decided],
                                      err_msg=f"step {step}")
        assert (jl[rows, tt] >= jl.max(-1) - 2 * diff).all(), f"step {step}"
