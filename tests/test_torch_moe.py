"""PyTorch port, the MoE slice: reduced DeepSeekMoE-16B under flexpe(8)
with quantize-once weights, port against the JAX reference (CPU).

  * `top_k` breaks ties toward the lower index, as `jax.lax.top_k` does.
  * The quantized [L, E, K, N] banks convert leaf for leaf and slice by
    layer.
  * `moe_ffn`: the reference's `moe_ffn` on its Pallas backend (interpret
    mode) and the port's, on both of its backends, are bit-equal
    (tolerance 0) with the same routing: the router product is f32 on
    both sides, the CORDIC softmax, the expert GEMMs and the CORDIC
    activation are bit-equal, the k weighted choices are summed in f32
    and rounded to bf16 once on both sides (jnp.sum upcasts bf16). The
    reference's plain backend snaps the bf16 expert activations on the
    bf16 grid instead (ROADMAP.md queue 3), so it is not the oracle here.
  * The model step: one chunked-prefill block then six greedy decode
    steps through `decode_step`, teacher-forced with the reference's
    tokens, logits within 10% of their range per step (observed: at most
    3.8%). The attention reductions run in another order than XLA's, as
    in the dense test, and the MoE router turns such an ulp into a
    probability one FxP8 step apart and so into other gate weights.
    Greedy tokens are equal wherever the reference's own top-two logits
    are further apart than twice the step's largest logit difference;
    at a closer near-tie the port's token must score within that much of
    the reference's best (the draw here has one such row).
    The reference runs eagerly (`jax.disable_jit`). Compiled, XLA
    rewrites some of its float arithmetic — `amax / qmax` of every
    per-tensor scale becomes `amax * (1 / qmax)`, reductions are fused —
    and through the MoE routing the compiled reference drifts from its
    own eager result (ROADMAP.md queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import PrecisionPolicy as JPolicy
from repro.core.precision import qmatmul as jqmatmul
from repro.core.qtensor import quantize_params as jquantize_params
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.core import qtensor as tqt
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.core.precision import qmatmul as tqmatmul
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from test_torch_model import numpy_tree

JPAL = JPolicy.flexpe(8, backend="pallas-interpret")


@pytest.fixture(scope="module")
def cfg():
    return jget_config("deepseek_moe_16b").reduced()


@pytest.fixture(scope="module")
def moe_params(cfg):
    jp = jquantize_params(jmoe.moe_init(jax.random.PRNGKey(0), cfg), "fxp8")
    return jp, from_numpy_tree(numpy_tree(jp))


def _bf16_input(shape, seed):
    x = jnp.asarray(np.random.default_rng(seed).normal(size=shape)
                    ).astype(jnp.bfloat16)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)


def test_top_k_breaks_ties_like_jax():
    x = np.array([0.1, 0.3, 0.3, 0.2, 0.3, 0.1], np.float32)
    vals, idx = tmoe.top_k(torch.from_numpy(x), 3)
    assert idx.tolist() == [1, 2, 4]
    # probabilities on an FxP8 grid: ties everywhere
    grid = np.random.default_rng(3).integers(0, 6, size=(4, 7, 64))
    x = (grid / 127.0).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    tv, ti = tmoe.top_k(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_quantized_moe_banks_convert_and_slice(cfg, moe_params):
    jp, tp = moe_params
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.expert_ff
    assert tp["w1"].data.shape == (e, d, ff)
    assert tp["w2"].scale.shape == (e, 1, d)
    assert tp["router"].dtype == torch.float32         # not quantized
    # the stacked [L, E, K, N] bank of the model quantizes per (layer,
    # expert, channel), as the reference's does, and slices by layer
    w = np.random.default_rng(4).normal(size=(2, e, d, ff)).astype(
        np.float32) * 0.05
    jq = jquantize_params({"moe": {"w1": jnp.asarray(w)}}, "fxp8")["moe"]
    tq = tqt.quantize_params({"moe": {"w1": torch.from_numpy(w)}},
                             "fxp8")["moe"]
    conv = from_numpy_tree(numpy_tree(jq))["w1"]
    for got in (tq["w1"], conv):
        assert got.data.shape == (2, e, d, ff)
        assert got.scale.shape == (2, e, 1, ff)
        np.testing.assert_array_equal(got.data.numpy(),
                                      np.asarray(jq["w1"].data))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(jq["w1"].scale))
        np.testing.assert_array_equal(got.layer(1).data.numpy(),
                                      np.asarray(jq["w1"].data[1]))


def test_quantize_params_consume_drops_float_leaves():
    tree = {"blocks": {"w1": torch.ones((2, 8, 4)), "norm": torch.ones(8)}}
    q = tqt.quantize_params(tree, "fxp8", consume=True)
    assert isinstance(q["blocks"]["w1"], tqt.QuantizedTensor)
    assert "w1" not in tree["blocks"] and "norm" in tree["blocks"]


@pytest.mark.parametrize("backend", ["reference", "kernels"])
@pytest.mark.parametrize("shape,dropless,n_groups", [
    ((1, 4), True, 0),            # a decode batch: 4 slots, one token each
    ((2, 8), True, 0),            # prefill rows
    ((1, 32), False, 4),          # capacity 4 per group of 8: drops
])
def test_moe_ffn_matches_reference(cfg, moe_params, backend, shape,
                                   dropless, n_groups):
    jp, tp = moe_params
    jx, tx = _bf16_input(shape + (cfg.d_model,), seed=sum(shape))
    want, aux = jmoe.moe_ffn(jp, jx, cfg, JPAL, n_groups=n_groups,
                             dropless=dropless)
    assert (float(aux["dropped"]) > 0) == (not dropless)
    tpol = TPolicy.flexpe(8, backend=backend)
    got = tmoe.moe_ffn(tp, tx, cfg, tpol, n_groups=n_groups,
                       dropless=dropless)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # the same routing: router logits, CORDIC probabilities, top-k
    jl = jqmatmul(jx.reshape(-1, cfg.d_model).astype(jnp.float32),
                  jp["router"], None)
    tl = tqmatmul(tx.reshape(-1, cfg.d_model).float(), tp["router"], None)
    ji = jax.lax.top_k(JPAL.softmax(jl), cfg.top_k)[1]
    ti = tmoe.top_k(tpol.softmax(tl), cfg.top_k)[1]
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_moe_ffn_raises_on_shard(cfg, moe_params):
    _, tp = moe_params
    with pytest.raises(NotImplementedError, match="sharded MoE"):
        tmoe.moe_ffn(tp, torch.zeros((1, 1, cfg.d_model)), cfg,
                     shard=object())


CHUNK, SLOTS, MAX_LEN, BS = 8, 2, 24, 4


@pytest.fixture(scope="module")
def model(cfg):
    jparams = jquantize_params(JM.init_params(cfg, jax.random.PRNGKey(0)),
                               "fxp8")
    return jparams, from_numpy_tree(numpy_tree(jparams))


def _tables():
    nb = SLOTS * (MAX_LEN // BS)
    tables = np.full((SLOTS, MAX_LEN // BS), nb, np.int32)
    tables[0] = [5, 0, 3, 7, 9, 11]
    tables[1] = [1, 4, 6, 2, 8, 10]
    return tables


@pytest.fixture(scope="module")
def reference_steps(cfg, model):
    """The reference's ragged prefill block then six greedy decode steps,
    eager: [(tokens, n_valid, last-position logits)] per step."""
    jparams, _ = model
    jcache = JM.init_cache(cfg, SLOTS, MAX_LEN, JPAL, kv_block_size=BS)
    jcache["block_tables"] = jnp.asarray(_tables())
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (SLOTS, CHUNK))
    n_valid = np.array([CHUNK, 6], np.int32)
    steps = []
    with jax.disable_jit():
        for _ in range(7):
            jl, jcache = JM.decode_step(cfg, jparams, jcache,
                                        jnp.asarray(tokens, jnp.int32),
                                        policy=JPAL,
                                        n_valid=jnp.asarray(n_valid),
                                        last_only=True)
            jl = np.asarray(jl.astype(jnp.float32))[:, -1, :cfg.vocab]
            steps.append((tokens, n_valid, jl))
            tokens = jl.argmax(-1)[:, None].astype(np.int64)
            n_valid = np.ones((SLOTS,), np.int32)
    return steps


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_moe_prefill_then_greedy_decode_matches_reference(
        cfg, model, reference_steps, backend):
    _, tparams = model
    tpol = TPolicy.flexpe(8, backend=backend)
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


def test_moe_init_shapes_and_entry_point_device():
    cfg = get_config("deepseek_moe_16b").reduced()
    p = TM.init_params(cfg, 0, device="cpu")
    moe = p["blocks"]["moe"]
    L, d, e, ff = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.expert_ff
    assert moe["router"].shape == (L, d, e)
    assert moe["router"].dtype == torch.float32
    assert moe["w1"].shape == (L, e, d, ff) and moe["w2"].shape == (L, e,
                                                                    ff, d)
    assert moe["shared"]["w1"].shape == (L, d, cfg.n_shared_experts * ff)
    assert "mlp" not in p["blocks"]
    # the reference's scales: N(0, 1/d) routed w1, N(0, 1/ff) w2
    assert abs(moe["w1"].float().std().item() * d ** 0.5 - 1) < 0.05
    assert abs(moe["w2"].float().std().item() * ff ** 0.5 - 1) < 0.05
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TM.init_params(cfg, 0)
