"""PyTorch port, serving: the port's `ServingEngine` against the JAX
reference's engine with the same layout and flags (greedy, reduced
Qwen2.5-14B and reduced DeepSeekMoE-16B under flexpe(8), quantize-once
weights, 2 slots, 3 requests of mixed length), the port's own layout and
loop-mode invariants, the serve CLI, the reference's mock-executor
scheduler tests run against the port's copied scheduler, and the port's
isolation from JAX (CPU).

The MoE reference engine runs on its Pallas backend (interpret mode),
whose CORDIC activation snaps in f32 as the port's does on both backends,
and eagerly (`jax.disable_jit`): compiled, XLA rewrites some of its float
arithmetic and the MoE routing carries the difference into other tokens
(tests/test_torch_moe.py, ROADMAP.md queue 3)."""
import ast
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import test_scheduler as ref_sched_tests
from repro.configs import get_config
from repro.core import PrecisionPolicy as JPolicy
from repro.core.qtensor import QuantizedTensor as JQT
from repro.core.qtensor import quantize_params as jquantize_params
from repro.models import model as JM
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving.executor import ModelExecutor as JExecutor
from repro_torch import serving as tserving
from repro_torch.convert import from_numpy_tree
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import scheduler as tscheduler

ROOT = Path(__file__).resolve().parents[1]
PLENS, GEN = (7, 4, 10), 5
ENGINE_KW = dict(max_slots=2, max_len=16, prefill_chunk=4)


def numpy_tree(tree):
    if isinstance(tree, JQT):
        return {"data": np.asarray(tree.data), "scale": np.asarray(tree.scale),
                "fmt": tree.fmt_name, "n": tree.n, "packed": tree.packed}
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _prompts(cfg):
    # Greedy decode of the random reduced model meets near-ties of the top
    # logits, where an f32 ulp (XLA's and torch's attention reductions run
    # in other orders) picks the other token; for some prompt draws the
    # two packages break such a tie differently (ROADMAP.md queue 3).
    # This draw has none.
    rng = np.random.default_rng(2)
    return [rng.integers(0, cfg.vocab, size=n).tolist() for n in PLENS]


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen2_5_14b").reduced()
    jparams = jquantize_params(JM.init_params(cfg, jax.random.PRNGKey(0)),
                               "fxp8")
    return cfg, jparams, from_numpy_tree(numpy_tree(jparams))


def _race_free_flush(flush):
    """The reference executor's `flush` uploads its host mirrors with
    `jnp.asarray`, which on the CPU backend may alias the numpy buffer;
    the host then edits the mirror in place while the step it dispatched
    may not have read it yet (ROADMAP.md queue 3). Upload private copies,
    so the reference's tokens here do not depend on thread timing."""
    def wrapped(self):
        mirrors = {n: getattr(self, n) for n in ("_lengths_host",
                                                 "_tables_host")
                   if hasattr(self, n)}
        for n, a in mirrors.items():
            setattr(self, n, a.copy())
        try:
            flush(self)
        finally:
            for n, a in mirrors.items():
                setattr(self, n, a)
    return wrapped


@pytest.fixture(scope="module")
def reference_tokens(model):
    """The reference engine, paged (block 4), sync loop."""
    cfg, jparams, _ = model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JExecutor, "flush", _race_free_flush(JExecutor.flush))
        eng = JEngine(cfg, jparams, policy=JPolicy.flexpe(8),
                      kv_block_size=4, **ENGINE_KW)
        done = eng.run([JRequest(prompt=p, max_new_tokens=GEN, id=i)
                        for i, p in enumerate(_prompts(cfg))])
    return [f.tokens for f in done]


def _port_tokens(model, backend="kernels", **kw):
    cfg, _, tparams = model
    eng = ServingEngine(cfg, tparams, policy=TPolicy.flexpe(8,
                                                            backend=backend),
                        device="cpu", **dict(ENGINE_KW, **kw))
    done = eng.run([Request(prompt=p, max_new_tokens=GEN, id=i)
                    for i, p in enumerate(_prompts(cfg))])
    eng.check_invariants()
    return [f.tokens for f in done]


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_engine_matches_reference_engine(model, reference_tokens, backend):
    assert _port_tokens(model, backend, kv_block_size=4) == reference_tokens


@pytest.mark.parametrize("layout,overlap", [
    ("contiguous", False), ("paged", True), ("contiguous", True)])
def test_engine_layouts_and_loop_modes_agree(model, reference_tokens,
                                             layout, overlap):
    """Paged vs contiguous cache, overlap vs sync loop: the same tokens
    (and the reference's)."""
    kw = {"overlap": overlap}
    if layout == "paged":
        kw["kv_block_size"] = 4
    assert _port_tokens(model, **kw) == reference_tokens


@pytest.fixture(scope="module")
def moe_model():
    cfg = get_config("deepseek_moe_16b").reduced()
    jparams = jquantize_params(JM.init_params(cfg, jax.random.PRNGKey(0)),
                               "fxp8")
    return cfg, jparams, from_numpy_tree(numpy_tree(jparams))


@pytest.fixture(scope="module")
def moe_reference_tokens(moe_model):
    """The reference engine, Pallas backend in interpret mode, paged
    (block 4), sync loop, eager."""
    cfg, jparams, _ = moe_model
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(JExecutor, "flush", _race_free_flush(JExecutor.flush))
        eng = JEngine(cfg, jparams,
                      policy=JPolicy.flexpe(8, backend="pallas-interpret"),
                      kv_block_size=4, **ENGINE_KW)
        done = eng.run([JRequest(prompt=p, max_new_tokens=GEN, id=i)
                        for i, p in enumerate(_prompts(cfg))])
    return [f.tokens for f in done]


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_moe_engine_matches_reference_engine(moe_model, moe_reference_tokens,
                                             backend):
    assert (_port_tokens(moe_model, backend, kv_block_size=4)
            == moe_reference_tokens)


def test_moe_engine_layouts_and_loop_modes_agree(moe_model,
                                                 moe_reference_tokens):
    """The MoE family through the contiguous cache and the overlap loop:
    the same tokens."""
    assert (_port_tokens(moe_model, overlap=True)
            == moe_reference_tokens)


def test_serve_cli_moe_reports_every_kernel(capsys):
    from repro_torch.launch import serve as serve_cli
    finished = serve_cli.main([
        "--arch", "deepseek_moe_16b", "--reduced", "--device", "cpu",
        "--kv-block-size", "4", "--requests", "3", "--slots", "2",
        "--prompt-len", "8", "--gen", "3", "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert len(finished) == 3 and all(len(o.tokens) == 3 for o in finished)
    # CPU tensors run the plain versions: no kernel launches
    assert ("kernel launches: fxp_gemm_fused 0, paged_attention_float 0, "
            "cordic_af 0, cordic_softmax 0") in out
    assert "arch deepseek-moe-16b-smoke" in out


def test_engine_events_stream_and_abort(model):
    cfg, _, tparams = model
    eng = ServingEngine(cfg, tparams, policy=TPolicy.flexpe(8),
                        device="cpu", kv_block_size=4, overlap=True,
                        **ENGINE_KW)
    p0, p1, p2 = _prompts(cfg)
    rid = eng.submit(Request(prompt=p1, max_new_tokens=GEN))
    eng.submit(Request(prompt=p2, max_new_tokens=GEN))
    queued = eng.submit(Request(prompt=p0, max_new_tokens=GEN))
    assert eng.abort(queued)                 # still pending: leaves queue
    streamed = list(eng.stream(Request(prompt=p0, max_new_tokens=3)))
    assert streamed[-1].finished and len(streamed[-1].tokens) == 3
    assert [o.new_tokens[0] for o in streamed] == streamed[-1].tokens
    rest = [o for o in eng.events() if o.finished]
    assert {o.id for o in rest} >= {rid}
    assert not eng.abort(rid)                # already finished
    eng.check_invariants()
    st = eng.stats()
    assert st["aborted_requests"] == 1 and st["held_blocks"] == 0


def test_sampled_decode_is_loop_mode_invariant(model):
    """Temperature sampling draws from one generator per request, so the
    sync and overlap loops (the same dispatch sequence) agree."""
    cfg, _, tparams = model
    outs = []
    for overlap in (False, True):
        eng = ServingEngine(cfg, tparams, policy=TPolicy.flexpe(8),
                            device="cpu", kv_block_size=4, overlap=overlap,
                            seed=3, **ENGINE_KW)
        done = eng.run([Request(prompt=p, max_new_tokens=GEN,
                                sampling=tserving.SamplingParams(
                                    temperature=0.8, top_k=20))
                        for p in _prompts(cfg)])
        outs.append([f.tokens for f in done])
    assert outs[0] == outs[1]


def test_engine_needs_cuda_unless_asked_for_cpu(model):
    cfg, _, tparams = model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, tparams, policy=TPolicy.flexpe(8))
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        ServingEngine(cfg, tparams, policy=TPolicy.flexpe(8), device="cpu",
                      kv_block_size=4, prefix_cache=True)


# ---------------------------------------------------------------------------
# the reference's mock-executor scheduler tests, on the port's scheduler
# ---------------------------------------------------------------------------

def _rebind(fn, env):
    """`fn` with its module globals replaced by `env`."""
    out = types.FunctionType(fn.__code__, env, fn.__name__, fn.__defaults__,
                             fn.__closure__)
    out.__kwdefaults__ = fn.__kwdefaults__
    return out


MOCK_TESTS = sorted(n for n in dir(ref_sched_tests) if n.startswith("test_"))


@pytest.mark.parametrize("name", MOCK_TESTS)
def test_reference_scheduler_cases_on_port(name):
    fn = getattr(ref_sched_tests, name)
    env = dict(vars(ref_sched_tests), Request=tserving.Request,
               PrefixCache=tserving.PrefixCache,
               Scheduler=tscheduler.Scheduler,
               SchedulingPolicy=tscheduler.SchedulingPolicy,
               ShortestPromptFirst=tscheduler.ShortestPromptFirst,
               POLICIES=tscheduler.POLICIES,
               make_policy=tscheduler.make_policy)
    env["_sched"] = _rebind(ref_sched_tests._sched, env)
    env["_req"] = _rebind(ref_sched_tests._req, env)
    _rebind(fn, env)()


# ---------------------------------------------------------------------------
# isolation
# ---------------------------------------------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list((ROOT / "src" / "repro_torch").rglob("*.py"))
    + [ROOT / "chip_smoke.py"]))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imports(ROOT / path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, f"{path} imports {bad}"


def test_importing_port_serving_loads_no_jax():
    code = ("import sys; import repro_torch.serving, repro_torch.launch.serve;"
            " print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
