"""PyTorch port, the dense model step: reduced Qwen2.5-14B under
flexpe(8) with quantize-once weights and the paged int8 KV pool, one
chunked-prefill block then six greedy decode steps, port against the JAX
reference's `decode_step` on the same converted weights (CPU).

Tolerance on the logits: 10% of their range per step (observed: at most
5.7%). Embedding, rmsnorm and the GEMMs agree bit for bit; RoPE's sin and
cos may differ by an f32 ulp; the attention reductions (scores, row sum,
AV) run in another order than XLA's, which moves f32 results by an ulp,
and the CORDIC LV divide at 10 stages turns an ulp at a decision boundary
into a 2^-9 step. One bf16 ulp in the attention output then flips single
FxP8 activation codes of the next GEMM, each a 1/127 step of the
per-tensor grid. Greedy tokens must be equal at every step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import PrecisionPolicy as JPolicy
from repro.core.qtensor import QuantizedTensor as JQT
from repro.core.qtensor import quantize_params as jquantize_params
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

CHUNK, SLOTS, MAX_LEN, BS = 8, 2, 24, 4


def numpy_tree(tree):
    """Reference param tree -> nested numpy dicts (QuantizedTensor leaves
    as {"data", "scale", "fmt", "n", "packed"})."""
    if isinstance(tree, JQT):
        return {"data": np.asarray(tree.data), "scale": np.asarray(tree.scale),
                "fmt": tree.fmt_name, "n": tree.n, "packed": tree.packed}
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def setup():
    cfg = jget_config("qwen2_5_14b").reduced()
    jparams = jquantize_params(JM.init_params(cfg, jax.random.PRNGKey(0)),
                               "fxp8")
    return cfg, jparams, from_numpy_tree(numpy_tree(jparams))


def _tables():
    """Row 0 holds blocks [5, 0, 3, ...], row 1 [1, 4, 6, ...] — non-
    contiguous physical blocks; the rest of the pool is unallocated."""
    nb = SLOTS * (MAX_LEN // BS)
    t = np.full((SLOTS, MAX_LEN // BS), nb, np.int32)
    t[0] = [5, 0, 3, 7, 9, 11]
    t[1] = [1, 4, 6, 2, 8, 10]
    return t


@pytest.mark.parametrize("arch", ["qwen2_5_14b", "deepseek_moe_16b",
                                  "zamba2_1p2b", "musicgen_large"])
def test_config_copy_is_identical(arch):
    j, t = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_prefill_then_greedy_decode_matches_reference(setup, backend):
    cfg, jparams, tparams = setup
    jpol = JPolicy.flexpe(8)
    tpol = TPolicy.flexpe(8, backend=backend)
    tables = _tables()
    jcache = JM.init_cache(cfg, SLOTS, MAX_LEN, jpol, kv_block_size=BS)
    jcache["block_tables"] = jnp.asarray(tables)
    tcache = TM.init_cache(cfg, SLOTS, MAX_LEN, tpol, kv_block_size=BS,
                           device="cpu")
    tcache["block_tables"] = torch.from_numpy(tables)
    jstep = jax.jit(lambda c, t, n: JM.decode_step(
        cfg, jparams, c, t, policy=jpol, n_valid=n, last_only=True))

    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (SLOTS, CHUNK))
    n_valid = np.array([CHUNK, 5], np.int32)      # ragged prefill block
    tokens = prompt
    for step in range(7):
        jl, jcache = jstep(jcache, jnp.asarray(tokens, jnp.int32),
                           jnp.asarray(n_valid))
        tl, tcache = TM.decode_step(cfg, tparams, tcache,
                                    torch.from_numpy(tokens),
                                    policy=tpol,
                                    n_valid=torch.from_numpy(n_valid),
                                    last_only=True)
        jl = np.asarray(jl.astype(jnp.float32))[:, -1, :cfg.vocab]
        tl = tl.float().numpy()[:, -1, :cfg.vocab]
        span = np.abs(jl).max()
        np.testing.assert_allclose(tl, jl, rtol=0, atol=0.1 * span,
                                   err_msg=f"step {step}")
        jt, tt = jl.argmax(-1), tl.argmax(-1)
        np.testing.assert_array_equal(tt, jt, err_msg=f"step {step}")
        assert (tcache["lengths"].numpy()
                == np.asarray(jcache["lengths"])).all()
        tokens = jt[:, None].astype(np.int64)
        n_valid = np.ones((SLOTS,), np.int32)
    # layer 0 sees bit-equal inputs (embedding, rmsnorm, exact GEMMs); only
    # RoPE's sin/cos may differ by an f32 ulp, so its pool codes agree to
    # one step and its scales to a few ulps
    for leaf in ("k", "v"):
        d = (tcache["kv"][leaf][0].numpy().astype(np.int32)
             - np.asarray(jcache["kv"][leaf][0]).astype(np.int32))
        assert np.abs(d).max() <= 1
    for leaf in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tcache["kv"][leaf][0].numpy(),
                                   np.asarray(jcache["kv"][leaf][0]),
                                   rtol=1e-6)


def test_entry_points_need_cuda_unless_asked_for_cpu(setup):
    cfg = setup[0]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_params(get_config("qwen2_5_14b").reduced(), 0)


def test_cache_writes_match_reference():
    """Paged (drop-mode scatter through the block table, a sentinel entry,
    an idle row) and contiguous (ragged window) writes land where the
    reference's do; the port writes in place."""
    rng = np.random.default_rng(5)
    pool = rng.normal(size=(6, 2, 1, 3)).astype(np.float32)     # NB=6, bs=2
    tables = np.array([[2, 0, 6], [1, 3, 6], [6, 6, 6]], np.int32)
    new = rng.normal(size=(3, 3, 1, 3)).astype(np.float32)
    start = np.array([1, 4, 0], np.int32)
    count = np.array([3, 2, 0], np.int32)     # row 1 runs into the sentinel
    want = JL.paged_cache_update(jnp.asarray(pool), jnp.asarray(new),
                                 jnp.asarray(tables), jnp.asarray(start),
                                 jnp.asarray(count))
    got = torch.from_numpy(pool.copy())
    TL.paged_cache_update(got, torch.from_numpy(new),
                          torch.from_numpy(tables), torch.from_numpy(start),
                          torch.from_numpy(count))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    buf = rng.normal(size=(3, 8, 1, 3)).astype(np.float32)
    want = JL.ragged_cache_update(jnp.asarray(buf), jnp.asarray(new),
                                  jnp.asarray(start), jnp.asarray(count))
    got = torch.from_numpy(buf.copy())
    TL.ragged_cache_update(got, torch.from_numpy(new),
                           torch.from_numpy(start), torch.from_numpy(count))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
