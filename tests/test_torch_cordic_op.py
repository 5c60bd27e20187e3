"""PyTorch port, the CORDIC ops on the CPU against the JAX reference, at the
cases the one-launch CUDA kernels' fused phases must keep.

On a CUDA tensor `cordic_af` and `cordic_softmax` are one launch each
(`csrc/cordic_af.cu`, `csrc/cordic_softmax.cu`): both per-tensor FxP
snaps, the AF or the row softmax, and the cast. On the card they are held
bit for bit against the plain op (`cordic_af_reference`,
`cordic_softmax_reference`) by `tests/test_torch_cuda.py`. Here that plain
op, which the CPU path runs, is pinned against the reference package:

  * every kernel AF at FxP4, FxP8 and FxP16, f32 and bf16 in and out:
    bit-equal to the reference's eager `flex_af` on the f32 values (cast
    to the input dtype), and to its jitted `cordic_af` op (Pallas in
    interpret mode) within one step of the output grid: under jit, XLA
    rewrites the scale's `amax / qmax` into `amax * (1 / qmax)`
    (ROADMAP.md queue 3), a scale an f32 ulp away, which can move a code
    of either snap;
  * the softmax at the same formats and dtypes: within one LV step
    (2^-lv) plus one step of the output grid of the reference's op and
    of its eager `flex_af` at the op's stage counts (`flex_af`'s own
    default, the AF's LV 5, cannot resolve 1/64), which sum rows in XLA's
    order;
  * the inputs: seeded normals, a tensor of zeros (the scale from the
    1e-12 clamp), all negatives (relu's output all 0, its snap from the
    clamp too), values on half-code ties of the FxP8 grid (max 127: scale
    1, round half to even), -0.0 among them (the codes' round trip gives
    +0.0), and for the softmax rows whose per-tensor max sits in one row.

FxP8 normals in f32 are `tests/test_torch_kernels.py`'s cases and are not
repeated here."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.activation import flex_af as jflex_af
from repro.core.cordic import PARETO_STAGES
from repro.core.fxp import FORMATS as JFORMATS
from repro.kernels.cordic_af.ops import cordic_af as jcordic_af
from repro.kernels.cordic_softmax.ops import cordic_softmax as jcordic_softmax
from repro_torch.core.activation import softmax_lv_stages
from repro_torch.kernels.cordic_af.cordic_af import (KERNEL_AFS, cordic_af,
                                                     cordic_af_reference)
from repro_torch.kernels.cordic_softmax.cordic_softmax import (
    cordic_softmax, cordic_softmax_reference)

FORMATS = ("fxp4", "fxp8", "fxp16")
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(case: str, shape=(6, 96)) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    if case == "normal":
        return (rng.normal(size=shape) * 3).astype(np.float32)
    if case == "zero":
        return np.zeros(shape, np.float32)
    if case == "negative":
        return (-np.abs(rng.normal(size=shape)) - 0.1).astype(np.float32)
    if case == "ties":
        half = shape[1] // 2
        x = np.arange(-half, half, dtype=np.float32)[None].repeat(shape[0], 0)
        x[:-1] += 0.5
        x[-1, 0] = 127.0                       # the per-tensor max
        x[0, ::4] = -0.0
        return x
    if case == "max-in-one-row":
        x = rng.normal(size=shape).astype(np.float32)
        x[2] *= 16
        return x
    raise ValueError(case)


@pytest.fixture
def flush_denormals():
    # XLA's CPU backend flushes f32 denormals; torch's does not unless
    # asked. Per-thread state: switched back off after the test.
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _cases(names):
    """(precision, dtype, case) over every format, dtype and case but
    tests/test_torch_kernels.py's FxP8 f32 normals."""
    return [(p, d, c) for p in FORMATS for d in DTYPES for c in names
            if (p, d, c) != ("fxp8", "f32", "normal")]


def _bf16_ulp(v) -> float:
    return float(np.spacing(np.float32(v))) * 2 ** 16


def _port_and_ref(x32: np.ndarray, dtype: str):
    """The same values as the port's tensor and the reference's array."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(x32).to(tdt)
    j = jnp.asarray(x32).astype(jdt)
    return t, j


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32
                  ).numpy()


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def test_ties_sit_on_half_codes():
    """The ties case is what its name says at FxP8: max 127 gives scale 1
    (both as a divide and as the jitted reciprocal), so every value but
    the max and the zeros is a half code, and round half to even picks
    the even neighbour."""
    x = _inputs("ties")
    q = JFORMATS["fxp8"].qmax
    assert np.float32(127.0) / np.float32(q) == 1.0
    assert np.float32(127.0) * (np.float32(1) / np.float32(q)) == 1.0
    halves = x[:-1] - np.floor(x[:-1])
    assert ((halves == 0.5) | (x[:-1] == 0)).all()
    got = cordic_af_reference(torch.from_numpy(x), "relu",
                              precision="fxp8").numpy()
    np.testing.assert_array_equal(got[:-1], np.maximum(np.rint(x[:-1]), 0))
    assert not np.signbit(got).any()          # -0.0 snaps to +0.0


@pytest.mark.parametrize("precision,dtype,case", _cases(
    ["normal", "zero", "negative", "ties"]))
def test_af_op_bit_equal_to_eager_flex_af(precision, dtype, case,
                                          flush_denormals):
    t, j = _port_and_ref(_inputs(case), dtype)
    for af in KERNEL_AFS:
        got = cordic_af(t, af, precision=precision)
        assert got.dtype == t.dtype and got.shape == t.shape
        np.testing.assert_array_equal(
            _bits(got), _bits(cordic_af_reference(t, af,
                                                  precision=precision)))
        want = jflex_af(j.astype(jnp.float32), af,
                        precision=precision).astype(j.dtype)
        np.testing.assert_array_equal(_f32(got), _f32(want), err_msg=af)


@pytest.mark.parametrize("precision,dtype,case", _cases(
    ["normal", "zero", "negative", "ties"]))
def test_af_op_matches_jitted_reference_op(precision, dtype, case,
                                           flush_denormals):
    t, j = _port_and_ref(_inputs(case), dtype)
    qmax = JFORMATS[precision].qmax
    for af in ("silu", "relu"):
        got = _f32(cordic_af(t, af, precision=precision))
        want = _f32(jcordic_af(j, af, precision=precision, interpret=True))
        top = np.abs(want).max()
        tol = top / qmax + (_bf16_ulp(top) if dtype == "bf16" else 0.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=af)
        if case in ("zero", "negative") and af == "relu":
            np.testing.assert_array_equal(got, 0.0)


@pytest.mark.parametrize("precision,dtype,case", _cases(
    ["normal", "zero", "ties", "max-in-one-row"]))
def test_softmax_op_matches_reference(precision, dtype, case,
                                      flush_denormals):
    x = _inputs(case, shape=(6, 64))
    t, j = _port_and_ref(x, dtype)
    got = cordic_softmax(t, precision=precision)
    assert got.dtype == t.dtype and got.shape == t.shape
    np.testing.assert_array_equal(
        _bits(got), _bits(cordic_softmax_reference(t, precision=precision)))
    got = _f32(got)
    lv = softmax_lv_stages(64, precision)
    hr = PARETO_STAGES[JFORMATS[precision].bits][0]
    for want in (jcordic_softmax(j, precision=precision, interpret=True),
                 jflex_af(j.astype(jnp.float32), "softmax",
                          precision=precision, stages=(hr, lv)
                          ).astype(j.dtype)):
        want = _f32(want)
        tol = 2.0 ** -(lv - 1) + np.abs(want).max() / JFORMATS[
            precision].qmax
        if dtype == "bf16":
            tol += _bf16_ulp(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if case == "zero":                         # every row uniform
        np.testing.assert_array_equal(got, np.full_like(got, got[0, 0]))
