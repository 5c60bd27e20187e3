"""PyTorch port, on the card: the CUDA kernels against their plain PyTorch
versions on the same seeded inputs. Every test here needs an NVIDIA GPU
and skips without one (the kernels have no CPU mode). This file imports
neither JAX nor the reference package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances: the GEMM is bit-equal with and without its AF epilogue (an
exact int32 product, then the same f32 operations in the same order);
the attention output is bf16 and its reductions run in another order
than the plain einsums, so it is held within 1% of the output's range."""
import numpy as np
import pytest
import torch

from repro_torch.core.activation import softmax_lv_stages
from repro_torch.kernels.fxp_gemm.fxp_gemm import (FUSED_AFS, fxp_gemm_fused,
                                                   fxp_gemm_fused_plain)
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention_float, paged_attention_float_plain, scores_in_scratch)


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


def test_unported_paths_raise_on_cuda(cuda):
    x = torch.zeros((2, 16), dtype=torch.int16, device=cuda)
    w = torch.zeros((16, 8), dtype=torch.int16, device=cuda)
    with pytest.raises(NotImplementedError, match="queue 2, item 7"):
        fxp_gemm_fused(x, w, torch.ones(8, device=cuda))
