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
operations, the softmax's row sum in the same fixed order); a reduced
MoE layer through the kernels is bit-equal to the plain backend. The
packed-FxP4 GEMM and the raw code GEMMs are bit-equal (exact int32 sums);
the integer attention's dots are exact, but its softmax sums and
exponentiates in another order than torch's, and a p x v_scale code that
flips with that moves the output by one v step times the row scale: it
is held within 1% of the output's range. The GEMM's wide mode (int16
codes, byte planes on the tensor cores) takes the exact integer sum and
rounds it once to f32, as its plain version does: bit-equal, with and
without its AF; its packed expert-bank mode is bit-equal to the
per-expert loop of the packed plain version. The packed modes (dense,
expert banks and the raw packed GEMM) run on the tensor-core core, whose
profiler record is `fxp_gemm_tc_kernel`."""
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
    paged_attention_int_plain, scores_in_scratch)


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


def _tables(long_rows):
    """(tables, meta, nb, g, bs). Short: row 0 holds blocks [3, 1] (6
    cached tokens); row 1 SHARES block 3 and adds [2, 5, 9, 7] (17 cached
    tokens). Long: a table 7680 positions wide, whose [g, MB*bs] score row
    does not fit in shared memory; row 0 caches 7500 tokens over 469
    shuffled blocks, row 1 shares row 0's first block and caches 1590
    tokens. Row 2 is idle (all sentinel, length 0) and each active row's
    table ends in sentinel entries."""
    if long_rows:
        nb, mb, g, bs = 600, 480, 8, 16
        perm = np.random.default_rng(5).permutation(nb)
        rows, lengths = [perm[:469], [perm[0], *perm[469:568]]], [7500, 1590]
    else:
        nb, mb, g, bs = 12, 6, 5, 4
        rows, lengths = [[3, 1], [3, 2, 5, 9, 7]], [6, 17]
    tables = np.full((3, mb), nb, np.int32)
    for b, row in enumerate(rows):
        tables[b, :len(row)] = row
    lengths = np.array(lengths + [0], np.int32)
    kv_valid = lengths + np.array([1, 1, 0], np.int32)
    meta = np.stack([lengths, kv_valid, lengths], axis=1)
    return torch.from_numpy(tables), torch.from_numpy(meta), nb, g, bs


def _pools(quant, long_rows, kvh=2, hd=32, seed=0):
    tables, meta, nb, g, bs = _tables(long_rows)
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(3, kvh, g, hd)).astype(np.float32))
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


@pytest.mark.parametrize("long_rows", [False, True],
                         ids=["scores-in-smem", "scores-in-global-scratch"])
@pytest.mark.parametrize("quant", [True, False], ids=["int8-cordic",
                                                      "bf16-exact"])
def test_paged_attention_kernel_matches_plain(cuda, quant, long_rows):
    q, k, v, ks, vs, tables, meta = [
        t.to(cuda) if t is not None else None
        for t in _pools(quant, long_rows)]
    width = tables.shape[1] * k.shape[1]
    # the long table takes the kernel's other branch: its score row lives
    # in a global scratch row instead of shared memory
    assert scores_in_scratch(q.shape[2], q.shape[3], width) == long_rows
    lv = softmax_lv_stages(width, "fxp8")
    kw = dict(k_scale=ks, v_scale=vs, cordic_softmax=quant, hr_stages=4,
              lv_stages=lv, out_dtype=torch.bfloat16)
    before = paged_attention_float.launches
    got = paged_attention_float(q, k, v, tables, meta, **kw).float()
    assert paged_attention_float.launches == before + 1
    want = paged_attention_float_plain(q, k, v, tables, meta, **kw).float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()
    # the idle row reads only sentinel blocks (V exactly zero): a zero
    # numerator, which the LV divide resolves to within 2^-lv
    assert got[2].abs().max().item() <= 2.0 ** -(lv - 1)


@pytest.mark.parametrize("long_rows", [False, True],
                         ids=["scores-in-smem", "scores-in-global-scratch"])
def test_paged_attention_int_kernel_matches_plain(cuda, long_rows):
    """Integer decode attention (exact softmax) against its plain version
    on the short and the long tables (the long one's [g, MB*bs] score row
    lives in a global scratch row); the idle row reads only sentinel
    blocks, whose zero V scales give an exact zero."""
    q, k, v, ks, vs, tables, meta = [
        t.to(cuda) for t in _pools(True, long_rows)]
    fmt = FORMATS["fxp8"]
    qc, sq = quantize(q.float() / q.shape[-1] ** 0.5, fmt, axis=3)
    width = tables.shape[1] * k.shape[1]
    assert scores_in_scratch(q.shape[2], q.shape[3], width,
                             integer=True) == long_rows
    args = (qc, sq, k, v, ks, vs, tables, meta)
    before = paged_attention_int.launches
    got = paged_attention_int(*args, fmt=fmt, out_dtype=torch.bfloat16)
    assert paged_attention_int.launches == before + 1
    want = paged_attention_int_plain(*args, fmt=fmt,
                                     out_dtype=torch.bfloat16)
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()
    assert (got[2] == 0).all()


def test_unported_paths_raise_on_cuda(cuda):
    """Codes wider than 16 bits have no kernel (their f64 sums would not
    be exact), and banks of int16 codes no batched one (the dispatch runs
    them per expert): both raise on the card, never fall back."""
    x = torch.zeros((2, 16), dtype=torch.int32, device=cuda)
    w = torch.zeros((16, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="int8 or int16"):
        fxp_gemm_fused(x, w, torch.ones(8, device=cuda))
    xb = torch.zeros((2, 3, 16), dtype=torch.int16, device=cuda)
    wb = torch.zeros((2, 16, 8), dtype=torch.int16, device=cuda)
    with pytest.raises(NotImplementedError, match="per expert"):
        fxp_gemm_fused_batched(xb, wb, torch.ones((2, 8), device=cuda))


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


@pytest.mark.parametrize("entry", ["dense", "bank", "raw"])
def test_packed_calls_run_on_the_tensor_core_core(cuda, entry):
    """A packed call's kernel record is the tensor-core core's
    (`fxp_gemm_tc_kernel`), not the __dp4a walk's."""
    rng = np.random.default_rng(11)
    e = 4 if entry == "bank" else 1
    x = torch.from_numpy(rng.integers(-7, 8, (e, 4, 1024),
                                      dtype=np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(-128, 128, (e, 1024, 320),
                                      dtype=np.int8)).to(cuda)
    scale = torch.full((e, 640), 1e-3, device=cuda)
    calls = {"dense": lambda: fxp_gemm_fused(x[0], w[0], scale[0],
                                             packed=True),
             "bank": lambda: fxp_gemm_fused_batched(x, w, scale, packed=True),
             "raw": lambda: fxp4_gemm_packed(x[0], w[0])}
    names = _kernel_records(calls[entry])
    assert any("fxp_gemm_tc_kernel" in n for n in names), names
    assert not any("fxp_gemm_fused_kernel" in n for n in names), names


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


@pytest.mark.parametrize("name", ["edge4", "flexpe-fxp16"])
def test_model_step_kernels_bit_equal_to_plain_backend(cuda, name):
    """Reduced DeepSeekMoE-16B under edge4 (packed FxP4 expert banks on
    the packed batched mode, one launch per bank) and reduced Qwen2.5-14B
    under FxP16 (every GEMM on the wide mode): a prefill block and a
    decode step through the kernels give the plain backend's logits bit
    for bit."""
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
            want = ({"packed", "batched_packed"} if name == "edge4"
                    else {"wide"})
            assert set(ran) == want, ran
            if name == "edge4":     # three routed banks per layer and step
                assert ran["batched_packed"] == 2 * 3 * cfg.n_layers
        else:
            assert not ran
    for a, b in zip(logits["kernels"], logits["reference"]):
        assert torch.equal(a, b)
