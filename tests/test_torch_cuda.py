"""PyTorch port, on the card: the CUDA kernels against their plain PyTorch
versions on the same seeded inputs. Every test here needs an NVIDIA GPU
and skips without one (the kernels have no CPU mode). This file imports
neither JAX nor the reference package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances: the GEMM is bit-equal with and without its AF epilogue (an
exact int32 product, then the same f32 operations in the same order),
and so is its expert-batched entry against the loop of single launches;
the attention output is bf16 and its reductions run in another order
than the plain einsums, so it is held within 1% of the output's range;
the CORDIC AF and the CORDIC softmax are bit-equal (the same f32
operations, the softmax's row sum in the same fixed order), and each op
with its per-tensor FxP snaps is one launch and one device record,
bit-equal to the plain op (NaN where it gives NaN), twice and under a
CUDA graph's replay; a reduced
MoE layer through the kernels is bit-equal to the plain backend. The
packed-FxP4 GEMM and the raw code GEMMs are bit-equal (exact int32 sums),
and so is the x32 mode on FxP24/32 codes (the exact sum in 128 bits,
rounded once to f32), also at the ends of int32; the integer attention's
dots are exact, but its softmax sums and exponentiates in another order than torch's, and a p x v_scale code that
flips with that moves the output by one v step times the row scale: it
is held within 1% of the output's range. The GEMM's wide mode (int16
codes, byte planes on the tensor cores) takes the exact integer sum and
rounds it once to f32, as its plain version does: bit-equal, with and
without its AF; its packed expert-bank mode is bit-equal to the
per-expert loop of the packed plain version. Every fused mode (int8 and
packed, dense and expert banks, int16 and int32 codes) and the raw int8,
int16 and packed GEMMs run on the tensor-core core, whose profiler record
is `fxp_gemm_tc_kernel`; the
bank tests also route no expert, one and every expert, and launch twice
with other routing (a semaphore left dirty would show)."""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.activation import softmax_lv_stages
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.qtensor import quantize_params
from repro_torch.kernels import dispatch
from repro_torch.kernels.cordic_af.cordic_af import (KERNEL_AFS, cordic_af,
                                                     cordic_af_plain,
                                                     cordic_af_reference)
from repro_torch.kernels.cordic_softmax.cordic_softmax import (
    cordic_softmax, cordic_softmax_plain, cordic_softmax_reference)
from repro_torch.core.fxp import FORMATS, quantize
from repro_torch.kernels.fxp_gemm.fxp_gemm import (
    FUSED_AFS, fxp4_gemm_packed, fxp4_gemm_packed_plain, fxp_gemm_codes,
    fxp_gemm_codes_plain, fxp_gemm_fused, fxp_gemm_fused_batched,
    fxp_gemm_fused_batched_plain, fxp_gemm_fused_plain)
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention_float, paged_attention_float_plain, paged_attention_int,
    cluster_plan, paged_attention_int_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(4, 512, 1000), (13, 1030, 384),
                                   (20, 96, 130), (16, 5120, 1024)])
@pytest.mark.parametrize("af", (None,) + FUSED_AFS)
def test_gemm_kernel_bit_equal_to_plain(cuda, m, k, n, af):
    rng = np.random.default_rng(m * 7 + n)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    scale = torch.from_numpy((rng.random(n) * 1e-3).astype(np.float32))
    x, w, scale = x.to(cuda), w.to(cuda), scale.to(cuda)
    before = fxp_gemm_fused.launches
    got = fxp_gemm_fused(x, w, scale, af=af)
    assert fxp_gemm_fused.launches == before + 1
    assert torch.equal(got, fxp_gemm_fused_plain(x, w, scale, af=af))


@pytest.mark.parametrize("m,k,n,nb", [(4, 512, 1000, 500), (13, 1030, 384, 192),
                                      (20, 96, 130, 65), (16, 5120, 1024, 512),
                                      (4, 5120, 5117, 2560),
                                      (16, 1030, 1001, 501),
                                      (32, 200, 513, 257),
                                      (32, 5120, 5120, 2560),
                                      (33, 2056, 768, 384)])
@pytest.mark.parametrize("af", [None, "silu"])
def test_packed_gemm_kernel_bit_equal_to_plain(cuda, m, k, n, nb, af):
    """Packed FxP4 weights [K, nb] bytes holding N <= 2 nb columns on the
    tensor-core core: rows copied in 16-byte chunks (nb a multiple of 16)
    and byte by byte (nb 500, 65, 501, 257), ragged and odd N, K not a
    multiple of a 128-row stage, row tiles of 8 (M <= 8), 16 (M 13, 16)
    and 32 rows (M 20, 32; M 33 two tiles), K split or whole."""
    rng = np.random.default_rng(m * 13 + n)
    x = torch.from_numpy(rng.integers(-8, 8, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (k, nb), dtype=np.int8))
    scale = torch.from_numpy((rng.random(n) * 1e-2).astype(np.float32))
    x, w, scale = x.to(cuda), w.to(cuda), scale.to(cuda)
    before = fxp_gemm_fused.launches
    got = fxp_gemm_fused(x, w, scale, af=af, packed=True)
    assert fxp_gemm_fused.launches == before + 1
    assert torch.equal(got, fxp_gemm_fused_plain(x, w, scale, af=af,
                                                 packed=True))


@pytest.mark.parametrize("m,k,n", [(32, 5120, 512), (5, 1030, 130),
                                   (17, 96, 64), (32, 5120, 5120),
                                   (33, 1000, 1000), (64, 2056, 136)])
def test_code_gemm_kernels_bit_equal_to_plain(cuda, m, k, n):
    """The raw int32 code GEMMs: int8 codes, FxP12 codes in int16 (inside
    the caller's bound K * qmax^2 < 2^31) and packed FxP4 weights, all on
    the tensor-core core, small int32 codes (the tiled int32 kernel), and
    int8 against int16; one to four row tiles of 8 to 32 rows (M 32, 33
    and 64 for the packed weights too), N not a multiple of 16
    (code-by-code copies of int8 rows; for packed bytes, N / 2 not a
    multiple of 16) and K not a multiple of 32."""
    rng = np.random.default_rng(m + k + n)

    def codes(shape, q, dtype):
        return torch.from_numpy(rng.integers(-q, q + 1, shape).astype(
            dtype)).to(cuda)
    kq = min(2047, int((2 ** 31 / k) ** 0.5) - 1)
    cases = [(codes((m, k), 127, np.int8), codes((k, n), 127, np.int8)),
             (codes((m, k), kq, np.int16), codes((k, n), kq, np.int16)),
             (codes((m, k), 300, np.int32), codes((k, n), 300, np.int32)),
             (codes((m, k), 127, np.int8), codes((k, n), kq, np.int16))]
    for x, w in cases:
        before = fxp_gemm_codes.launches
        got = fxp_gemm_codes(x, w)
        assert fxp_gemm_codes.launches == before + 1
        assert got.dtype == torch.int32
        assert torch.equal(got, fxp_gemm_codes_plain(x, w)), (x.dtype,
                                                                w.dtype)
    x = codes((m, k), 7, np.int8)
    wp = codes((k, n // 2), 127, np.int8)
    before = fxp4_gemm_packed.launches
    got = fxp4_gemm_packed(x, wp)
    assert fxp4_gemm_packed.launches == before + 1
    assert torch.equal(got, fxp4_gemm_packed_plain(x, wp))


# table widths (slots MB, positions per block bs) at which the wrappers'
# rule picks each cluster size for 5 rows x 2 KV heads, and one whose
# score rows do not fit in a CTA's shared memory even at C 8
_WIDTHS = {1: (2, 16), 2: (5, 8), 4: (12, 8), 8: (20, 16)}
_SCRATCH_WIDTH = (4000, 16)


def _layout_tables(mb, bs, seed=5):
    """(tables, meta, nb) of five rows over a table mb slots of bs
    positions wide (S = mb * bs), blocks shuffled over the pool: row 0's
    window of S - 2 positions holds a sentinel entry (as
    clear_table_entry can leave); row 1's window ends mid-block (S / 2 +
    1 positions); row 2 holds one token; row 3 has an empty window (valid
    length 0) over a fully allocated table; row 4 is idle (all sentinel,
    length 0). Unused slots hold the sentinel nb."""
    s = mb * bs
    windows = [s - 2, s // 2 + 1, 1]
    need = [-(-w // bs) for w in windows] + [mb]
    nb = sum(need) + 3
    perm = iter(np.random.default_rng(seed).permutation(nb).tolist())
    tables = np.full((5, mb), nb, np.int32)
    for b, n in enumerate(need):
        tables[b, :n] = [next(perm) for _ in range(n)]
    tables[0, (need[0] - 1) // 2] = nb
    qpos = np.array([w - 1 for w in windows] + [s - 1, 0], np.int32)
    kv_valid = np.array(windows + [0, 0], np.int32)
    meta = np.stack([qpos, kv_valid, qpos], axis=1)
    return torch.from_numpy(tables), torch.from_numpy(meta), nb


def _pools(quant, mb, bs, g, kvh=2, seed=0, hd=None):
    """bf16 q [5, kvh, g, hd] and pools over _layout_tables(mb, bs): int8
    codes with per-position scales, or bf16 values; by default hd 128 at
    g 5 (the paths' head) and 32 otherwise (rows narrower than a score
    lane's chunks)."""
    tables, meta, nb = _layout_tables(mb, bs)
    hd = hd or (128 if g == 5 else 32)
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(5, kvh, g, hd)).astype(np.float32))
    shape = (nb, bs, kvh, hd)
    if quant:
        k = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
        ks = torch.from_numpy((rng.random(shape[:3] + (1,)) * 0.02
                               ).astype(np.float32))
        vs = torch.from_numpy((rng.random(shape[:3] + (1,)) * 0.02
                               ).astype(np.float32))
    else:
        k = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        v = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        k, v, ks, vs = k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    return q.to(torch.bfloat16), k, v, ks, vs, tables, meta


def _plan(q, k, tables, integer=False):
    b, kvh, g, hd = q.shape
    return cluster_plan(b, kvh, g, hd, tables.shape[1], k.shape[1],
                        elem_bytes=k.element_size(), integer=integer,
                        device=q.device.index)


def _check_attention(wrapper, run, plain):
    """Two launches against the plain version: one launch a call,
    bit-identical, finite, within 1% of the output's range (bf16 output,
    reductions in another order than the plain einsums), and the empty
    window's row (the mean of V over the table width) within 1% of its
    own range. Returns (kernel, plain) outputs in f32."""
    before = wrapper.launches
    got = run()
    assert wrapper.launches == before + 1
    again = run()
    assert torch.equal(got, again)
    got, want = got.float(), plain().float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()
    assert want[3].abs().max().item() > 0
    assert ((got[3] - want[3]).abs().max().item()
            <= 1e-2 * want[3].abs().max().item())
    return got, want


# (cluster size, scores in global scratch, g): every size at g 1, 5 and 8,
# and the scratch branch at g 8
_CASES = [(c, False, g) for c in _WIDTHS for g in (1, 5, 8)] + [(8, True, 8)]
_IDS = [f"C{c}-g{g}" + ("-scores-in-global-scratch" if s else "")
        for c, s, g in _CASES]


@pytest.mark.parametrize("c,scratch,g", _CASES, ids=_IDS)
@pytest.mark.parametrize("quant", [True, False], ids=["int8-cordic",
                                                      "bf16-exact"])
def test_paged_attention_kernel_matches_plain(cuda, quant, g, c, scratch):
    """Float decode attention against its plain version at each cluster
    size the wrappers' rule picks (forced by the table's width) and both
    branches of the score row, on rows with a sentinel inside the window,
    a window ending mid-block, one token, an empty window over allocated
    blocks and an all-sentinel idle row."""
    mb, bs = _SCRATCH_WIDTH if scratch else _WIDTHS[c]
    q, k, v, ks, vs, tables, meta = [
        t.to(cuda) if t is not None else None
        for t in _pools(quant, mb, bs, g)]
    assert _plan(q, k, tables) == (c, scratch)
    lv = softmax_lv_stages(mb * bs, "fxp8")
    kw = dict(k_scale=ks, v_scale=vs, cordic_softmax=quant, hr_stages=4,
              lv_stages=lv, out_dtype=torch.bfloat16)
    got, _ = _check_attention(
        paged_attention_float,
        lambda: paged_attention_float(q, k, v, tables, meta, **kw),
        lambda: paged_attention_float_plain(q, k, v, tables, meta, **kw))
    # the idle row reads only sentinel blocks (V exactly zero): a zero
    # numerator, exact under the exact divide, within 2^-lv under LV's
    assert got[4].abs().max().item() <= (2.0 ** -(lv - 1) if quant else 0.0)


@pytest.mark.parametrize("c,scratch,g", _CASES, ids=_IDS)
def test_paged_attention_int_kernel_matches_plain(cuda, g, c, scratch):
    """Integer decode attention (exact softmax) against its plain version
    on the same layouts, cluster sizes and score-row branches; the idle
    row reads only sentinel blocks, whose zero V scales give an exact
    zero."""
    mb, bs = _SCRATCH_WIDTH if scratch else _WIDTHS[c]
    q, k, v, ks, vs, tables, meta = [t.to(cuda)
                                     for t in _pools(True, mb, bs, g)]
    assert _plan(q, k, tables, integer=True) == (c, scratch)
    fmt = FORMATS["fxp8"]
    qc, sq = quantize(q.float() / q.shape[-1] ** 0.5, fmt, axis=3)
    args = (qc, sq, k, v, ks, vs, tables, meta)
    kw = dict(fmt=fmt, out_dtype=torch.bfloat16)
    got, _ = _check_attention(
        paged_attention_int, lambda: paged_attention_int(*args, **kw),
        lambda: paged_attention_int_plain(*args, **kw))
    assert (got[4] == 0).all()


def test_unported_paths_raise_on_cuda(cuda):
    """Banks of codes wider than 8 bits have no batched kernel (the
    dispatch runs them per expert on the wide or x32 mode), and codes that
    are not integers no kernel at all: both raise on the card, never fall
    back."""
    for dtype in (torch.int16, torch.int32):
        xb = torch.zeros((2, 3, 16), dtype=dtype, device=cuda)
        wb = torch.zeros((2, 16, 8), dtype=dtype, device=cuda)
        with pytest.raises(NotImplementedError, match="per expert"):
            fxp_gemm_fused_batched(xb, wb, torch.ones((2, 8), device=cuda))
    x = torch.zeros((2, 16), device=cuda)
    with pytest.raises(NotImplementedError, match="int8, int16 or int32"):
        fxp_gemm_fused(x, x.t().contiguous(), torch.ones(2, device=cuda))


def _x32_operands(rng, cuda, m, k, n, ends, q=(1 << 31) - 1):
    """int32 codes in [-q - 1, q] and a scale; `ends`: codes at the ends
    of int32 (+-(2^31 - 1), -2^31, none exact in f32), columns of one
    sign, sums of K * 2^62 past 2^64."""
    if ends:
        x = torch.full((m, k), q, dtype=torch.int32, device=cuda)
        x[1 % m] = -q - 1
        x[-1, ::3] = -q
        cols = torch.arange(n, device=cuda)
        w = torch.where(cols % 2 == 0, q, -q).to(torch.int32)
        w = w.expand(k, n).clone()
        w[:, 2 % n] = -q - 1
        w[::5, 3 % n] = 0
        scale = torch.full((n,), 2.0 ** -70, device=cuda)
    else:
        x = torch.from_numpy(rng.integers(-q - 1, q, (m, k), endpoint=True,
                                          dtype=np.int32)).to(cuda)
        w = torch.from_numpy(rng.integers(-q - 1, q, (k, n), endpoint=True,
                                          dtype=np.int32)).to(cuda)
        scale = torch.from_numpy((rng.random(n) / (float(q) ** 2 * k ** 0.5)
                                  ).astype(np.float32)).to(cuda)
    return x, w, scale


@pytest.mark.parametrize("m,k,n,ends", [
    (4, 5120, 5120, False), (4, 5120, 1024, False), (4, 5120, 13824, False),
    (4, 13824, 5120, False), (4, 5120, 152064, False),
    (16, 5120, 5120, False), (13, 1030, 130, False), (3, 96, 1001, False),
    (1, 40000, 300, False), (4, 13824, 5120, True), (16, 13824, 1001, True),
    (5, 70000, 130, True), (16, 13824, 5120, True), (4, 32768, 8448, True),
    (4, 40000, 8448, True)])
@pytest.mark.parametrize("af", [None, "silu"])
def test_x32_gemm_kernel_bit_equal_to_plain(cuda, m, k, n, ends, af):
    """FxP32 codes in int32 at Qwen2.5-14B's decode and prefill shapes, and
    ragged M, K and N (N 130 and 1001 take the single-code loads; K 40000
    and 70000 split K, whose slices add in 128 bits across blocks): the
    exact integer sum rounded once to f32 on both sides, bit-equal with
    and without the fused SiLU; one launch on the x32 mode a call.
    `ends`: codes at the ends of int32. At N 8448 the column tiles fill
    the card, so K 32768 runs in one slice a block, each warp's int32
    plane groups summing the 8192 rows of their cap, and K 40000 passes
    the block's 32768-row cap (two slices)."""
    rng = np.random.default_rng(m * 31 + n + k)
    x, w, scale = _x32_operands(rng, cuda, m, k, n, ends)
    before = (fxp_gemm_fused.launches,
              fxp_gemm_fused.launches_by_mode["x32"])
    got = fxp_gemm_fused(x, w, scale, af=af, hr_stages=8, lv_stages=10)
    assert (fxp_gemm_fused.launches,
            fxp_gemm_fused.launches_by_mode["x32"]) == (before[0] + 1,
                                                        before[1] + 1)
    assert torch.equal(got, fxp_gemm_fused_plain(x, w, scale, af=af,
                                                 hr_stages=8, lv_stages=10))
    # FxP24 codes, and an int8 operand beside an int32 one (widened)
    x24 = torch.clamp(x, -(1 << 23), (1 << 23) - 1)
    w24 = torch.clamp(w, -(1 << 23), (1 << 23) - 1)
    assert torch.equal(fxp_gemm_fused(x24, w24, scale, af=af),
                       fxp_gemm_fused_plain(x24, w24, scale, af=af))
    x8 = torch.clamp(x, -127, 127).to(torch.int8)
    assert torch.equal(fxp_gemm_fused(x8, w, scale, af=af),
                       fxp_gemm_fused_plain(x8, w, scale, af=af))


@pytest.mark.parametrize("af", FUSED_AFS)
def test_x32_gemm_kernel_every_af_bit_equal(cuda, af):
    rng = np.random.default_rng(3)
    x, w, scale = _x32_operands(rng, cuda, 4, 1030, 384, False)
    for hr, lv in ((8, 10), (6, 8)):
        assert torch.equal(
            fxp_gemm_fused(x, w, scale, af=af, hr_stages=hr, lv_stages=lv),
            fxp_gemm_fused_plain(x, w, scale, af=af, hr_stages=hr,
                                 lv_stages=lv))


def test_x32_gemm_runs_its_own_kernel(cuda):
    """An int32 call's GEMM record is the tensor-core core's int32
    instantiation (`fxp_gemm_tc_kernel<int, ...>`: byte planes on the
    tensor cores) and no other GEMM kernel's, and a CUDA graph of three
    calls holds two kernel nodes (a node type of 0) a call, K split or
    not: the core's workspace fill and the GEMM."""
    rng = np.random.default_rng(4)
    x, w, scale = _x32_operands(rng, cuda, 4, 5120, 1024, False)
    names = _kernel_records(lambda: [fxp_gemm_fused(x, w, scale)
                                     for _ in range(3)])
    gemms = {k for k in names if "fxp_gemm" in k}
    assert gemms and all("fxp_gemm_tc_kernel<int," in k for k in gemms), \
        names
    # K split (8 slices): each call zeroes its workspace (a fill kernel)
    # and launches once; unsplit (a grid that fills the card), the same
    fxp_gemm_fused(x, w, scale)          # builds and loads before capture
    assert _graph_node_types(lambda: fxp_gemm_fused(x, w, scale),
                             3).count(0) == 6
    x, w, scale = _x32_operands(rng, cuda, 4, 512, 40000, False)
    assert _graph_node_types(lambda: fxp_gemm_fused(x, w, scale),
                             3).count(0) == 6


def test_fxp32_quantize_saturates_on_the_card(cuda):
    """The repaired FxP32 quantize on CUDA tensors: 1 / scale is 2^31 in
    f32, which saturates to 2^31 - 1 as XLA's cast does (and as the CPU
    quantize now does); with the same scale the card's codes equal the
    CPU's at FxP24 and FxP32."""
    x = torch.tensor([1.0, -1.0, 0.5, 0.3])
    codes, _ = quantize(x.to(cuda), FORMATS["fxp32"])
    assert codes.dtype == torch.int32
    assert codes.tolist() == [(1 << 31) - 1, -(1 << 31), 1 << 30, 644245120]
    rng = np.random.default_rng(5)
    xr = torch.from_numpy(rng.normal(size=(64, 40)).astype(np.float32))
    for fmt in ("fxp24", "fxp32"):
        scale = quantize(xr, FORMATS[fmt], axis=1)[1]
        assert torch.equal(
            quantize(xr.to(cuda), FORMATS[fmt],
                     scale=scale.to(cuda))[0].cpu(),
            quantize(xr, FORMATS[fmt], scale=scale)[0])
    # PyTorch's own f32 -> int32 cast on the card (PTX cvt.rzi) saturates
    # 2^31, where the CPU's wraps it: without the repair the two devices'
    # FxP32 codes would differ too
    big = torch.tensor([2.0 ** 31, -(2.0 ** 31)], device=cuda)
    assert big.to(torch.int32).tolist() == [(1 << 31) - 1, -(1 << 31)]


@pytest.mark.parametrize("m,k,n,ends", [
    (4, 5120, 5120, False), (4, 5120, 1024, False), (4, 5120, 13824, False),
    (4, 13824, 5120, False), (4, 5120, 152064, False),
    (16, 5120, 5120, False), (13, 1030, 130, False), (3, 96, 1001, False),
    (4, 13824, 5120, True), (16, 13824, 1001, True),
    (4, 33000, 17000, True)])
@pytest.mark.parametrize("af", [None, "silu"])
def test_wide_gemm_kernel_bit_equal_to_plain(cuda, m, k, n, ends, af):
    """FxP16 codes in int16 at Qwen2.5-14B's decode and prefill shapes,
    and ragged M, K and N (N 130 and 1001 take the byte loads): the exact
    integer sum rounded once to f32 on both sides, bit-equal with and
    without the fused SiLU. `ends`: codes at the ends of int16 (+-32767,
    -32768), columns of one sign, sums of K * 2^30 that a wrong int32
    combine of the byte planes would wrap; K 33000 passes a block's
    32768-row cap with N wide enough that the cap alone splits K (two
    blocks per column tile, their int64 sums added across blocks)."""
    rng = np.random.default_rng(m * 31 + n)
    if ends:
        x = torch.full((m, k), 32767, dtype=torch.int16, device=cuda)
        x[1] = -32768
        x[-1, ::3] = -32767
        cols = torch.arange(n, device=cuda)
        w = torch.where(cols % 2 == 0, 32767, -32767).to(torch.int16)
        w = w.expand(k, n).clone()
        w[:, 2] = -32768
        w[::5, 3] = 0
        scale = torch.full((n,), 2.0 ** -40, device=cuda)
    else:
        x = torch.from_numpy(rng.integers(-32767, 32768, (m, k),
                                          dtype=np.int16)).to(cuda)
        w = torch.from_numpy(rng.integers(-32767, 32768, (k, n),
                                          dtype=np.int16)).to(cuda)
        scale = torch.from_numpy((rng.random(n) * 1e-9).astype(np.float32)
                                 ).to(cuda)
    before = (fxp_gemm_fused.launches,
              fxp_gemm_fused.launches_by_mode["wide"])
    got = fxp_gemm_fused(x, w, scale, af=af)
    assert (fxp_gemm_fused.launches,
            fxp_gemm_fused.launches_by_mode["wide"]) == (before[0] + 1,
                                                         before[1] + 1)
    assert torch.equal(got, fxp_gemm_fused_plain(x, w, scale, af=af))
    # FxP12 codes under the reference's wide_exact bound, and an int8
    # operand beside an int16 one (widened)
    x12 = torch.clamp(x, -2047, 2047)[:, :512]
    w12 = torch.clamp(w, -2047, 2047)[:512]
    assert torch.equal(fxp_gemm_fused(x12, w12, scale, af=af),
                       fxp_gemm_fused_plain(x12, w12, scale, af=af))
    x8 = torch.clamp(x, -127, 127).to(torch.int8)
    assert torch.equal(fxp_gemm_fused(x8, w, scale, af=af),
                       fxp_gemm_fused_plain(x8, w, scale, af=af))


@pytest.mark.parametrize("e,m,k,n", [(64, 4, 2048, 1408), (64, 4, 1408, 2048),
                                     (64, 16, 2048, 1408), (5, 3, 256, 130),
                                     (3, 40, 96, 64)])
@pytest.mark.parametrize("af", [None, "silu"])
@pytest.mark.parametrize("fill", ["half", "mixed"])
def test_packed_batched_gemm_kernel_bit_equal_to_plain(cuda, e, m, k, n, af,
                                                       fill):
    """Packed FxP4 expert banks [E, K, N/2] bytes in one launch, at
    DeepSeekMoE-16B's decode and prefill banks and at ragged shapes;
    expert 1's queue is empty and every queue is half filled, as a
    dropless bank's are, or (`mixed`) every third expert has no routed
    row, every third a full queue and the rest one row: bit-equal to the
    per-expert packed plain loop (blocks of an empty expert skip their
    copies and products and still write AF(0))."""
    rng = np.random.default_rng(e * 100 + m + k)
    x = rng.integers(-7, 8, (e, m, k), dtype=np.int8)
    if fill == "half":
        x[:, (m + 1) // 2:] = 0
    else:
        x[0::3, 1:] = 0
        x[1::3] = 0
    x[1] = 0
    x = torch.from_numpy(x).to(cuda)
    nb = -(-n // 2)
    w = torch.from_numpy(rng.integers(-128, 128, (e, k, nb),
                                      dtype=np.int8)).to(cuda)
    scale = torch.from_numpy((rng.random((e, 1, n)) * 1e-2
                              ).astype(np.float32)).to(cuda)
    before = (fxp_gemm_fused.launches,
              fxp_gemm_fused.launches_by_mode["batched_packed"])
    got = fxp_gemm_fused_batched(x, w, scale, af=af, packed=True)
    assert (fxp_gemm_fused.launches,
            fxp_gemm_fused.launches_by_mode["batched_packed"]) == (
                before[0] + 1, before[1] + 1)
    want = fxp_gemm_fused_batched_plain(x, w, scale, af=af, packed=True)
    assert torch.equal(got, want)
    for i in (0, e - 1):
        assert torch.equal(got[i], fxp_gemm_fused(x[i], w[i], scale[i],
                                                  af=af, packed=True))


def _kernel_records(fn):
    """Names of the device kernels one call of `fn()` launches."""
    act = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act):     # takes late records
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0}


@pytest.mark.parametrize("entry", ["dense", "bank", "raw", "int8 dense",
                                   "int8 bank"])
def test_packed_calls_run_on_the_tensor_core_core(cuda, entry):
    """A packed or int8 call's GEMM record is the tensor-core core's
    (`fxp_gemm_tc_kernel`) and no other kernel's (beside it only the
    workspace's zero fill runs)."""
    rng = np.random.default_rng(11)
    e = 4 if "bank" in entry else 1
    x = torch.from_numpy(rng.integers(-7, 8, (e, 4, 1024),
                                      dtype=np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(-128, 128, (e, 1024, 320),
                                      dtype=np.int8)).to(cuda)
    scale = torch.full((e, 640), 1e-3, device=cuda)
    scale8 = torch.full((e, 320), 1e-3, device=cuda)
    calls = {"dense": lambda: fxp_gemm_fused(x[0], w[0], scale[0],
                                             packed=True),
             "bank": lambda: fxp_gemm_fused_batched(x, w, scale, packed=True),
             "raw": lambda: fxp4_gemm_packed(x[0], w[0]),
             "int8 dense": lambda: fxp_gemm_fused(x[0], w[0], scale8[0]),
             "int8 bank": lambda: fxp_gemm_fused_batched(x, w, scale8)}
    names = _kernel_records(calls[entry])
    assert any("fxp_gemm_tc_kernel" in n for n in names), names
    others = {n for n in names if "fxp_gemm_tc_kernel" not in n}
    assert all("fill" in n.lower() or "memset" in n.lower()
               for n in others), names


@pytest.mark.parametrize("e,m,k,n", [(5, 3, 256, 130), (4, 24, 1030, 384),
                                     (3, 40, 96, 64)])
@pytest.mark.parametrize("af", [None, "silu"])
def test_batched_gemm_kernel_bit_equal_to_single_launches(cuda, e, m, k, n,
                                                          af):
    """One launch for all experts; expert 1's queue is empty and every
    other queue is half filled (zero rows), as a dropless MoE bank has."""
    rng = np.random.default_rng(e * 100 + m)
    x = rng.integers(-127, 128, (e, m, k), dtype=np.int8)
    x[:, (m + 1) // 2:] = 0
    x[1] = 0
    x = torch.from_numpy(x).to(cuda)
    w = torch.from_numpy(rng.integers(-127, 128, (e, k, n),
                                      dtype=np.int8)).to(cuda)
    scale = torch.from_numpy((rng.random((e, 1, n)) * 1e-3
                              ).astype(np.float32)).to(cuda)
    before = fxp_gemm_fused.launches
    got = fxp_gemm_fused_batched(x, w, scale, af=af)
    assert fxp_gemm_fused.launches == before + 1
    for i in range(e):
        assert torch.equal(got[i], fxp_gemm_fused(x[i], w[i], scale[i],
                                                  af=af))
        assert torch.equal(got[i], fxp_gemm_fused_plain(x[i], w[i], scale[i],
                                                        af=af))


def _routed_bank(rng, e, m, k, experts, q):
    """Activation codes [e, m, k] whose queues in `experts` hold 1 to m
    rows of codes in [-q, q] (a nonzero first code each), the rest zero."""
    x = np.zeros((e, m, k), dtype=np.int8)
    for i in experts:
        rows = int(rng.integers(1, m + 1))
        x[i, :rows] = rng.integers(-q, q + 1, (rows, k))
        x[i, :rows, 0] = 1
    return x


def _bank_case(rng, cuda, e, m, k, n, packed, experts):
    q = 7 if packed else 127
    x = torch.from_numpy(_routed_bank(rng, e, m, k, experts, q)).to(cuda)
    w = torch.from_numpy(rng.integers(-128 if packed else -127, 128,
                                      (e, k, -(-n // 2) if packed else n),
                                      dtype=np.int8)).to(cuda)
    scale = torch.from_numpy((rng.random((e, 1, n)) * 1e-3
                              ).astype(np.float32)).to(cuda)
    return x, w, scale


# (E, M, K, N): DeepSeekMoE-16B's decode bank (K whole; an int8 bank's
# 704 items handed out to fewer blocks), a bank of 32-row tiles (fewer
# blocks fit on an SM) and a ragged bank whose K is split (a semaphore per
# expert and tile, the hand-out's counter after them)
BANK_SHAPES = [(64, 4, 2048, 1408), (64, 20, 1408, 2048), (6, 4, 1030, 300)]


@pytest.mark.parametrize("e,m,k,n", BANK_SHAPES)
@pytest.mark.parametrize("routed", ["none", "one", "all"])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])
@pytest.mark.parametrize("af", [None, "silu"])
def test_bank_routing_bit_equal_to_plain(cuda, e, m, k, n, routed, packed,
                                         af):
    """Banks with no routed expert (every block empty: AF(0) everywhere),
    one, and every expert: bit-equal to the per-expert plain loop, one
    launch each."""
    rng = np.random.default_rng(e + k + len(routed))
    experts = {"none": [], "one": [e // 2], "all": range(e)}[routed]
    x, w, scale = _bank_case(rng, cuda, e, m, k, n, packed, experts)
    mode = "batched_packed" if packed else "batched"
    before = fxp_gemm_fused.launches_by_mode[mode]
    got = fxp_gemm_fused_batched(x, w, scale, af=af, packed=packed)
    assert fxp_gemm_fused.launches_by_mode[mode] == before + 1
    assert torch.equal(got, fxp_gemm_fused_batched_plain(
        x, w, scale, af=af, packed=packed))


@pytest.mark.parametrize("e,m,k,n", BANK_SHAPES)
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])
def test_bank_back_to_back_launches_with_other_routing(cuda, e, m, k, n,
                                                       packed):
    """Two launches in a row on one stream, the second routing to other
    experts than the first (and the first's outputs still held): each
    equals its plain loop, so no semaphore of the first launch's
    workspace leaks into the second."""
    rng = np.random.default_rng(e * 3 + k)
    first = list(range(0, e, 3))
    second = [i for i in range(e) if i % 3 != 0][:max(1, e // 3)]
    a = _bank_case(rng, cuda, e, m, k, n, packed, first)
    b = _bank_case(rng, cuda, e, m, k, n, packed, second)
    got_a = fxp_gemm_fused_batched(*a, af="silu", packed=packed)
    got_b = fxp_gemm_fused_batched(*b, af="silu", packed=packed)
    for got, args in ((got_a, a), (got_b, b)):
        assert torch.equal(got, fxp_gemm_fused_batched_plain(
            *args, af="silu", packed=packed))


@pytest.mark.parametrize("shape", [(3, 1000), (7, 333), (1, 64, 24, 1408)])
@pytest.mark.parametrize("af", KERNEL_AFS)
def test_cordic_af_kernel_bit_equal_to_plain(cuda, af, shape):
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    x = torch.from_numpy((rng.normal(size=shape) * 3).astype(np.float32)
                         ).to(cuda)
    before = cordic_af.launches
    got = cordic_af(x, af)
    assert cordic_af.launches == before + 1
    assert torch.equal(got, cordic_af_plain(x, af, 4, 5))
    # an unaligned view takes the scalar loop
    flat = x.reshape(-1)[1:]
    assert torch.equal(cordic_af(flat, af), cordic_af_plain(flat, af, 4, 5))
    # the op: FxP8 snaps in and out around the kernel, bf16 in and out
    xb = x.to(torch.bfloat16)
    assert torch.equal(cordic_af(xb, af, precision="fxp8"),
                       cordic_af_reference(xb, af, precision="fxp8"))


@pytest.mark.parametrize("m,n", [(4, 64), (16, 64), (5, 8), (9, 300),
                                 (8, 4096)])
def test_cordic_softmax_kernel_bit_equal_to_plain(cuda, m, n):
    rng = np.random.default_rng(m * n)
    x = torch.from_numpy((rng.normal(size=(m, n)) * 2).astype(np.float32)
                         ).to(cuda)
    lv = softmax_lv_stages(n, "fxp8")
    before = cordic_softmax.launches
    got = cordic_softmax(x, hr_stages=4, lv_stages=lv)
    assert cordic_softmax.launches == before + 1
    assert torch.equal(got, cordic_softmax_plain(x, 4, lv))
    assert torch.equal(cordic_softmax(x, precision="fxp8"),
                       cordic_softmax_reference(x, precision="fxp8"))


# -- the CORDIC ops as one launch each: both per-tensor snaps, the AF or the
# row softmax and the cast in the kernel, held bit for bit against the
# plain op (`cordic_*_reference`, PyTorch on the card)

SNAPS = ("fxp4", "fxp8", "fxp16", None)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# the MoE path's expert activations (decode, a prefill chunk, the shared
# experts), a ragged tail, and a tensor past 16 elements a thread of the
# grid the card holds (the fallback that reads x in each phase)
AF_SHAPES = {"decode": (1, 64, 4, 1408), "prefill": (1, 64, 16, 1408),
             "shared": (1, 4, 2816), "ragged": (7, 333),
             "past-registers": (4, 1 << 20, 2)}


def _same_bits(got, want):
    """Equal bit patterns where `want` is a number, NaN where it is NaN."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    view = torch.int16 if want.element_size() == 2 else torch.int32
    return torch.equal(got[~nan].view(view), want[~nan].view(view))


def _op_records(fn, calls: int):
    """{name: count} of the device records of `calls` calls of `fn()`
    under the profiler."""
    act = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act):     # takes late records
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0}


def _graph_node_types(fn, calls: int) -> list:
    """The node types (CUgraphNodeType, 0 a kernel) of a CUDA graph that
    captured `calls` calls of `fn()`, read with libcuda's
    cuGraphGetNodes: every launch, copy or fill the calls make."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        types.append(kind.value)
    return types


def _af_input(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=shape) * 3).astype(np.float32))
    return x.to("cuda").to(dtype)


def test_cuda_divide_by_host_scalar_is_reciprocal_multiply(cuda):
    """The plain op's scale `amax / qmax` divides a CUDA tensor by a host
    scalar, which PyTorch computes as `amax * f32(1 / qmax)`; the kernels'
    `snap_scale` (csrc/fxp_snap.cuh) repeats that, not an IEEE divide."""
    rng = np.random.default_rng(0)
    a = (rng.random(1 << 16) * 100).astype(np.float32)
    for q in (7, 127, 32767):
        got = (torch.from_numpy(a).to(cuda) / q).cpu().numpy()
        recip = a * (np.float32(1) / np.float32(q))
        np.testing.assert_array_equal(got, recip)
        assert (recip != a / np.float32(q)).any()


@pytest.mark.parametrize("shape", AF_SHAPES.values(), ids=AF_SHAPES.keys())
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("precision", SNAPS)
@pytest.mark.parametrize("af", KERNEL_AFS)
def test_cordic_af_op_one_launch_bit_equal(cuda, af, precision, dtype,
                                           shape):
    x = _af_input(shape, dtype, seed=len(shape) + shape[-1])
    before = cordic_af.launches
    got = cordic_af(x, af, precision=precision)
    assert cordic_af.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _same_bits(got, cordic_af_reference(x, af, precision=precision))
    # an unaligned view of the same storage
    view = x.reshape(-1)[3:]
    assert _same_bits(cordic_af(view, af, precision=precision),
                      cordic_af_reference(view, af, precision=precision))


def _edge_inputs(dtype):
    """The cases the fused phases must keep, each [4, 96]: all zero (the
    scale from the 1e-12 clamp), all negative (relu's output all 0), values
    on half-code ties of the FxP8 grid of max 127 (round half to even),
    -0.0 among them, and a NaN."""
    rng = np.random.default_rng(11)
    ties = (np.arange(-48, 48, dtype=np.float32) + 0.5)
    ties = np.concatenate([ties[None].repeat(3, 0), [[127.0] * 96]])
    neg = -np.abs(rng.normal(size=(4, 96))).astype(np.float32) - 0.1
    signed = rng.normal(size=(4, 96)).astype(np.float32)
    signed[::2, ::3] = -0.0
    nan = rng.normal(size=(4, 96)).astype(np.float32)
    nan[2, 5] = np.nan
    cases = {"zero": np.zeros((4, 96), np.float32), "negative": neg,
             "ties": ties, "minus-zero": signed, "nan": nan}
    return {k: torch.from_numpy(v).to("cuda").to(dtype)
            for k, v in cases.items()}


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("precision", SNAPS)
def test_cordic_ops_edge_cases_bit_equal(cuda, precision, dtype):
    for case, x in _edge_inputs(dtype).items():
        for af in KERNEL_AFS:
            assert _same_bits(cordic_af(x, af, precision=precision),
                              cordic_af_reference(x, af,
                                                  precision=precision)), \
                (case, af)
        assert _same_bits(cordic_softmax(x, precision=precision),
                          cordic_softmax_reference(x, precision=precision)), \
            case


SOFTMAX_SHAPES = {"router-decode": (4, 64), "router-prefill": (16, 64),
                  "router-3d": (1, 16, 64), "narrow": (5, 8),
                  "wide": (9, 300), "past-registers-width": (8, 4096),
                  "past-registers-rows": (70000, 64)}


@pytest.mark.parametrize("shape", SOFTMAX_SHAPES.values(),
                         ids=SOFTMAX_SHAPES.keys())
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("precision", SNAPS)
def test_cordic_softmax_op_one_launch_bit_equal(cuda, precision, dtype,
                                                shape):
    rng = np.random.default_rng(shape[-1] + len(shape))
    x = rng.normal(size=shape).astype(np.float32) * 2
    x[..., 1, :] *= 8            # the per-tensor max sits in one row
    x = torch.from_numpy(x).to(cuda).to(dtype)
    before = cordic_softmax.launches
    got = cordic_softmax(x, precision=precision)
    assert cordic_softmax.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _same_bits(got, cordic_softmax_reference(x, precision=precision))
    view = x.reshape(-1)[shape[-1] - 1:-1].reshape(-1, shape[-1])
    assert _same_bits(cordic_softmax(view, precision=precision),
                      cordic_softmax_reference(view, precision=precision))


@pytest.mark.parametrize("op", ["af", "softmax"])
@pytest.mark.parametrize("precision", SNAPS)
@pytest.mark.parametrize("shape", ["decode", "prefill", "past-registers"])
def test_cordic_op_is_one_device_record(cuda, op, precision, shape):
    """One call, one launch, whose device record is the kernel's: the
    snaps, the cast and the slots' reduction are all in it (no copy, fill
    or PyTorch op)."""
    if op == "af":
        x = _af_input(AF_SHAPES[shape], torch.bfloat16, seed=1)
        call, name = (lambda: cordic_af(x, "silu", precision=precision),
                      "cordic_af_kernel")
    else:
        rows = {"decode": 4, "prefill": 16, "past-registers": 70000}[shape]
        x = _af_input((rows, 64), torch.float32, seed=2)
        call, name = (lambda: cordic_softmax(x, precision=precision),
                      "cordic_softmax_kernel")
    call()
    # five calls captured in a CUDA graph are five kernel nodes and nothing
    # else (CU_GRAPH_NODE_TYPE_KERNEL is 0)
    assert _graph_node_types(call, 5) == [0] * 5
    # the profiler names them. It loses some records of these launches
    # (in a whole run of this file, up to every record of a window, never
    # a PyTorch op's): a window that holds none is taken again, up to five
    # windows, and a window holds the kernel's records and nothing else
    for _ in range(5):
        records = _op_records(call, 5)
        if records:
            break
    assert len(records) == 1, records
    (key, count), = records.items()
    assert name in key and 1 <= count <= 5, records


@pytest.mark.parametrize("precision", ["fxp8", "fxp4", None])
def test_cordic_ops_twice_bit_identical(cuda, precision):
    x = _af_input(AF_SHAPES["decode"], torch.bfloat16, seed=3)
    r = _af_input((16, 64), torch.float32, seed=4)
    assert _same_bits(cordic_af(x, "silu", precision=precision),
                      cordic_af(x, "silu", precision=precision))
    assert _same_bits(cordic_softmax(r, precision=precision),
                      cordic_softmax(r, precision=precision))


@pytest.mark.parametrize("precision", ["fxp8", None])
def test_cordic_ops_captured_in_cuda_graph(cuda, precision):
    """Each op captured once in a CUDA graph, replayed twice after new data
    is copied into its static input: each replay gives the plain op's bits
    on that data (the slots are rewritten by every launch, nothing
    stale)."""
    x = _af_input(AF_SHAPES["decode"], torch.bfloat16, seed=5)
    r = _af_input((16, 64), torch.float32, seed=6)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm up off the capture
        cordic_af(x, "silu", precision=precision)
        cordic_softmax(r, precision=precision)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = cordic_af(x, "silu", precision=precision)
        p = cordic_softmax(r, precision=precision)
    for seed in (7, 8):
        x.copy_(_af_input(AF_SHAPES["decode"], torch.bfloat16, seed) * 0.5)
        r.copy_(_af_input((16, 64), torch.float32, seed + 10) * 4)
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(y, cordic_af_reference(x, "silu",
                                                 precision=precision))
        assert _same_bits(p, cordic_softmax_reference(r,
                                                      precision=precision))


def test_moe_layer_kernels_bit_equal_to_plain_backend(cuda):
    """A reduced DeepSeekMoE block's FFN (2 decode tokens and a prefill
    row): the kernels backend launches one softmax, two AFs and six GEMMs
    (three expert banks, three shared) and gives the plain backend's bits."""
    from repro_torch.models import model as M
    from repro_torch.models.moe import moe_ffn
    cfg = get_config("deepseek_moe_16b").reduced()
    params = quantize_params(M.init_params(cfg, 0, device=cuda), "fxp8")
    bp = M.layer_params(params["blocks"], 0)["moe"]
    gen = torch.Generator(device=cuda).manual_seed(0)
    for shape in ((2, 1), (1, 9)):
        x = torch.randn(shape + (cfg.d_model,), generator=gen,
                        device=cuda).to(torch.bfloat16)
        before = (fxp_gemm_fused.launches, cordic_af.launches,
                  cordic_softmax.launches)
        got = moe_ffn(bp, x, cfg, PrecisionPolicy.flexpe(8, backend="kernels"),
                      dropless=True)
        after = (fxp_gemm_fused.launches, cordic_af.launches,
                 cordic_softmax.launches)
        assert tuple(b - a for a, b in zip(before, after)) == (6, 2, 1)
        want = moe_ffn(bp, x, cfg, PrecisionPolicy.flexpe(8), dropless=True)
        assert torch.equal(got, want)
    # the bank GEMM alone, through dispatch on both backends
    xe = torch.randn((1, cfg.n_experts, 4, cfg.d_model), generator=gen,
                     device=cuda).to(torch.bfloat16)
    pol = PrecisionPolicy.flexpe(8)
    assert torch.equal(
        dispatch.expert_matmul(xe, bp["w1"], pol, backend="kernels"),
        dispatch.expert_matmul(xe, bp["w1"], pol, backend="reference"))


@pytest.mark.parametrize("name", ["edge4", "flexpe-fxp16", "flexpe-fxp32"])
def test_model_step_kernels_bit_equal_to_plain_backend(cuda, name):
    """Reduced DeepSeekMoE-16B under edge4 (packed FxP4 expert banks on
    the packed batched mode, one launch per bank) and reduced Qwen2.5-14B
    under FxP16 (every GEMM on the wide mode) and FxP32 (every GEMM on the
    x32 mode, its KV codes wrapped into the int8 pool, the attention's
    CORDIC softmax at FxP32's stages): a prefill block and a decode step
    through the kernels give the plain backend's logits bit for bit."""
    from repro_torch.models import model as M
    arch = "deepseek_moe_16b" if name == "edge4" else "qwen2_5_14b"
    cfg = get_config(arch).reduced()
    pol = PrecisionPolicy.from_name(name)
    params = quantize_params(M.init_params(cfg, 0, device=cuda), pol.matmul)
    gen = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 5), device=cuda, generator=gen)
    logits = {}
    for backend in ("kernels", "reference"):
        bpol = PrecisionPolicy.from_name(name, backend=backend)
        cache = M.init_cache(cfg, 2, 16, bpol, kv_block_size=4, device=cuda)
        cache["block_tables"][:, :4] = torch.arange(
            8, device=cuda, dtype=torch.int32).reshape(2, 4)
        modes = dict(fxp_gemm_fused.launches_by_mode)
        out = []
        for toks in (tokens, tokens[:, :1]):
            lg, cache = M.decode_step(cfg, params, cache, toks, policy=bpol,
                                      last_only=True)
            out.append(lg)
        logits[backend] = out
        ran = {m: n - modes[m]
               for m, n in fxp_gemm_fused.launches_by_mode.items()
               if n != modes[m]}
        if backend == "kernels":
            want = {"edge4": {"packed", "batched_packed"},
                    "flexpe-fxp16": {"wide"},
                    "flexpe-fxp32": {"x32"}}[name]
            assert set(ran) == want, ran
            if name == "edge4":     # three routed banks per layer and step
                assert ran["batched_packed"] == 2 * 3 * cfg.n_layers
        else:
            assert not ran
    for a, b in zip(logits["kernels"], logits["reference"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the SSM (Mamba2-370M) and hybrid (Zamba2-1.2B) paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 1, 2048), (1, 16, 2048),
                                   (4, 1, 4096), (1, 16, 4096)])
def test_ssm_gate_cordic_af_bit_equal(cuda, shape):
    """The SSM gate (SiLU on bf16 under FxP8) at Mamba2's and Zamba2's
    decode rows and prefill chunks: one launch, the plain op's bits."""
    x = (torch.from_numpy(np.random.default_rng(sum(shape)).normal(
        size=shape).astype(np.float32)) * 3).to(torch.bfloat16).to(cuda)
    before = cordic_af.launches
    got = cordic_af(x, "silu", precision="fxp8")
    assert cordic_af.launches == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, cordic_af_reference(x, "silu", precision="fxp8"))


@pytest.mark.parametrize("m,k,n,af", [
    (4, 1024, 4384, None), (16, 1024, 4384, None),    # mamba2 in_proj
    (4, 2048, 8384, None), (4, 4096, 2048, None),     # zamba2 in/out_proj
    (4, 2048, 8192, "gelu"), (16, 2048, 8192, "gelu"),  # shared w1 + GELU
    (4, 2048, 32000, None)])                          # zamba2 lm_head
def test_ssm_path_gemm_shapes_bit_equal(cuda, m, k, n, af):
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    scale = torch.from_numpy((rng.random(n) * 1e-4).astype(np.float32))
    x, w, scale = x.to(cuda), w.to(cuda), scale.to(cuda)
    before = fxp_gemm_fused.launches
    got = fxp_gemm_fused(x, w, scale, af=af)
    assert fxp_gemm_fused.launches == before + 1
    assert torch.equal(got, fxp_gemm_fused_plain(x, w, scale, af=af))


@pytest.mark.parametrize("mb,bs", [(2, 16), (5, 8), (20, 16)])
def test_paged_attention_mha_hd64_matches_plain(cuda, mb, bs):
    """Zamba2's shared attention: plain multi-head (g 1), 32 KV heads of
    hd 64, on the int8 pool with the CORDIC softmax, over the layouts of
    _layout_tables: within 1% of the plain version."""
    q, k, v, ks, vs, tables, meta = [
        t.to(cuda) if t is not None else None
        for t in _pools(True, mb, bs, 1, kvh=32, hd=64)]
    kw = dict(k_scale=ks, v_scale=vs, cordic_softmax=True, hr_stages=4,
              lv_stages=softmax_lv_stages(mb * bs, "fxp8"),
              out_dtype=torch.bfloat16)
    _check_attention(
        paged_attention_float,
        lambda: paged_attention_float(q, k, v, tables, meta, **kw),
        lambda: paged_attention_float_plain(q, k, v, tables, meta, **kw))


class _KernelNodeParams(ctypes.Structure):
    """`CUDA_KERNEL_NODE_PARAMS_v2` of cuda.h (libcuda)."""
    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in ("grid_x", "grid_y", "grid_z", "block_x",
                                     "block_y", "block_z", "shared_bytes")
    ] + [("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
         ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _graph_kernel_names(fn) -> list:
    """The function names of the kernel nodes of a CUDA graph that
    captured one call of `fn()`, read with libcuda's cuGraphGetNodes,
    cuGraphKernelNodeGetParams_v2 and cuFuncGetName (cuKernelGetName for
    a node that holds a library kernel handle)."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        if kind.value != 0:                       # not a kernel node
            continue
        p = _KernelNodeParams()
        assert cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                ctypes.byref(p)) == 0
        name = ctypes.c_char_p()
        rc = (cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func))
              if p.func else
              cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)))
        assert rc == 0, rc
        names.append(name.value.decode())
    return names


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_1p2b"])
def test_ssm_decode_step_launches_as_graph_kernel_nodes(cuda, arch):
    """One decode step of reduced Mamba2 / Zamba2 under flexpe(8) on the
    kernels backend, captured in a CUDA graph: its kernel nodes hold one
    GEMM per in_proj and out_proj of every SSM layer, per in_proj, q, k,
    v, o, w1 + GELU and w2 of each shared application and one lm_head,
    one CORDIC AF per SSM layer and one float paged attention per shared
    application, and nothing else of the port's; the wrappers' counters
    say the same."""
    from repro_torch.models import model as M
    cfg = get_config(arch).reduced()
    pol = PrecisionPolicy.flexpe(8, backend="kernels")
    params = quantize_params(M.init_params(cfg, 0, device=cuda), "fxp8")
    cache = M.init_cache(cfg, 4, 32, pol, kv_block_size=16, device=cuda)
    if "block_tables" in cache:
        cache["block_tables"][:, :2] = torch.arange(
            8, device=cuda, dtype=torch.int32).reshape(4, 2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (4, 1), device=cuda, generator=gen)
    n_valid = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=cuda)

    def step():
        return M.decode_step(cfg, params, cache, tokens, policy=pol,
                             n_valid=n_valid, last_only=True)
    step()                               # plans and buffers before capture
    torch.cuda.synchronize()
    counters = (fxp_gemm_fused, cordic_af, paged_attention_float,
                cordic_softmax, paged_attention_int)
    before = [c.launches for c in counters]
    names = _graph_kernel_names(step)
    counted = [c.launches - b for c, b in zip(counters, before)]
    apps = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    want = [2 * cfg.n_layers + 7 * apps + 1, cfg.n_layers, apps, 0, 0]
    assert counted == want
    # the kernels' names as the profiler reports them, matched in the
    # (mangled) function names; "paged_attention_kernel" is not a part of
    # "paged_attention_int_kernel"
    nodes = [sum(kernel in name for name in names)
             for kernel in ("fxp_gemm_tc_kernel", "cordic_af_kernel",
                            "paged_attention_kernel", "cordic_softmax_kernel",
                            "paged_attention_int_kernel")]
    assert nodes == want, (nodes, sorted(set(names))[:8])


@pytest.mark.parametrize("tier", ["bf16", "fxp4"])
def test_spec_tier_decode_step_launches_as_graph_kernel_nodes(cuda, tier):
    """One decode step of reduced Qwen2.5-14B on each side of the
    speculative pair (the bf16 and fxp4 views of one bank, kernels
    backend), captured in a CUDA graph. bf16: no GEMM kernel of the port
    (its matmuls are torch.matmul in f32) and one float paged attention
    per layer on the bf16 pool. fxp4, the draft: one packed GEMM per q,
    k, v, o, w1 + SiLU, w3 and w2 of every layer and the lm_head, and one
    float paged attention per layer on the int8 pool. The wrappers'
    counters say the same."""
    from repro_torch.core.precision import tier_policy
    from repro_torch.core.qtensor import TieredWeights
    from repro_torch.models import model as M
    cfg = get_config("qwen2_5_14b").reduced()
    pol = tier_policy(tier, backend="kernels")
    params = TieredWeights(M.init_params(cfg, 0, device=cuda),
                           ["fxp4", "bf16"]).for_tier(tier)
    cache = M.init_cache(cfg, 4, 32, pol, kv_block_size=16, device=cuda)
    assert cache["kv"]["k"].dtype == (torch.bfloat16 if tier == "bf16"
                                      else torch.int8)
    cache["block_tables"][:, :2] = torch.arange(
        8, device=cuda, dtype=torch.int32).reshape(4, 2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (4, 1), device=cuda, generator=gen)
    n_valid = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=cuda)

    def step():
        return M.decode_step(cfg, params, cache, tokens, policy=pol,
                             n_valid=n_valid, last_only=True)
    step()                               # plans and buffers before capture
    torch.cuda.synchronize()
    counters = (fxp_gemm_fused, cordic_af, paged_attention_float,
                cordic_softmax, paged_attention_int)
    before = [c.launches for c in counters]
    packed_before = fxp_gemm_fused.launches_by_mode["packed"]
    names = _graph_kernel_names(step)
    counted = [c.launches - b for c, b in zip(counters, before)]
    gemms = 0 if tier == "bf16" else 7 * cfg.n_layers + 1
    want = [gemms, 0, cfg.n_layers, 0, 0]
    assert counted == want
    assert fxp_gemm_fused.launches_by_mode["packed"] - packed_before == gemms
    nodes = [sum(kernel in name for name in names)
             for kernel in ("fxp_gemm_tc_kernel", "cordic_af_kernel",
                            "paged_attention_kernel", "cordic_softmax_kernel",
                            "paged_attention_int_kernel")]
    assert nodes == want, (nodes, sorted(set(names))[:8])
