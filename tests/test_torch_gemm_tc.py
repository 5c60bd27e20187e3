"""PyTorch port: the arithmetic of the GEMM's tensor-core core, on the CPU.

The raw int8 and int16 code GEMMs and the fused GEMM's wide mode (int16
codes) run on one CUDA core of int8 tensor-core tiles, which splits each
int16 code c into a signed high byte h = c >> 8 and an unsigned low byte
l = c & 255 and combines four int32 plane products exactly in int64.
`byte_plane_matmul` is that arithmetic in plain PyTorch. Here it is held
bit for bit against the exact integer product (int64), against the plain
versions' f64 product `exact_matmul` and, for FxP12 codes inside the
caller's bound K * qmax^2 < 2^31, against `int_matmul` and the reference's
int32 dot (`fxp_gemm_pallas`, interpret mode). The kernels themselves run
only on the card (tests/test_torch_cuda.py); on the CPU their wrappers
give the plain versions, checked here, and the split of K across blocks
keeps each block's slice under the 32768-row cap that keeps the int32
plane sums exact.
"""
import importlib.util
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fxp_gemm.fxp_gemm import (fxp_gemm_fused_pallas,
                                             fxp_gemm_pallas)
from repro_torch.kernels.fxp_gemm import fxp_gemm as fx
from repro_torch.kernels.fxp_gemm.fxp_gemm import (
    byte_plane_matmul, exact_matmul, fxp_gemm_codes, fxp_gemm_codes_plain,
    fxp_gemm_fused, fxp_gemm_fused_plain, int_matmul, k_split)

CAP = 32768          # rows of a block's K slice (kMaxKSplitWide)


def _int16(rng, shape, kind):
    """int16 codes: uniform over the full range, or at its ends."""
    if kind == "uniform":
        v = rng.integers(-32768, 32768, shape)
    else:
        v = rng.choice(np.array([-32768, -32767, 32767]), shape)
    return torch.from_numpy(v.astype(np.int16))


def _exact(x, w):
    return x.to(torch.int64) @ w.to(torch.int64)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (4, 96, 13), (5, 300, 64),
                                   (16, 1030, 33)])
@pytest.mark.parametrize("kind", ["uniform", "ends"])
def test_byte_plane_matmul_is_the_exact_product(m, k, n, kind):
    """Random int16 codes over the full range, or only -32768 and
    +-32767: the byte-plane sum equals the exact int64 product and the
    plain version's f64 product, bit for bit."""
    rng = np.random.default_rng(m * 131 + k + n)
    x, w = _int16(rng, (m, k), kind), _int16(rng, (k, n), kind)
    got = byte_plane_matmul(x, w)
    assert got.dtype == torch.int64
    assert torch.equal(got, _exact(x, w))
    assert torch.equal(got.to(torch.float64), exact_matmul(x, w))


@pytest.mark.parametrize("code", [-32768, -32767, 32767])
def test_byte_plane_matmul_all_extreme_columns(code):
    """Columns of one extreme code against rows of each extreme code:
    sums of up to K * 2^30, far past int32, exact in the int64 combine."""
    k = 4099
    x = torch.tensor([[-32768], [-32767], [32767], [0]],
                     dtype=torch.int16).expand(4, k)
    w = torch.full((k, 3), code, dtype=torch.int16)
    w[:, 1] = -code if code != -32768 else 32767
    got = byte_plane_matmul(x, w)
    assert torch.equal(got, _exact(x, w))
    assert got.abs().max() > 2 ** 31
    assert torch.equal(got.to(torch.float64), exact_matmul(x, w))


@pytest.mark.parametrize("k", [CAP - 1, CAP, CAP + 1, 2 * CAP + 5])
def test_byte_plane_matmul_at_and_past_a_block_boundary(k):
    """Codes at the ends of int16 at K on both sides of a block's
    32768-row slice (a reduced N keeps it cheap): every slice's int32
    plane sums stay exact, and so does their int64 total, whether K fits
    one slice or spills into the next, and whether K is cut at the cap or
    into the smaller slices of split K."""
    rng = np.random.default_rng(k)
    x = _int16(rng, (2, k), "ends")
    x[0] = 32767
    w = _int16(rng, (k, 3), "ends")
    w[:, 0] = -32768
    want = _exact(x, w)
    assert torch.equal(byte_plane_matmul(x, w), want)
    slices = sum(byte_plane_matmul(x[:, k0:k0 + 4096], w[k0:k0 + 4096])
                 for k0 in range(0, k, 4096))
    assert torch.equal(slices, want)


def test_byte_plane_slices_past_the_cap_overflow():
    """Why the cap: one K slice of 40000 rows of low bytes 255 sums
    255^2 * 40000 > 2^31 in an int32 plane (the ll plane, taken whole
    here), which wraps; slices of at most 32768 rows do not."""
    k = 40000
    x = torch.full((1, k), 255, dtype=torch.int16)
    w = torch.full((k, 1), 255, dtype=torch.int16)
    want = _exact(x, w)
    assert torch.equal(byte_plane_matmul(x, w), want)
    ll = (x.to(torch.int64) & 255) @ (w.to(torch.int64) & 255)
    assert not torch.equal(ll.to(torch.int32).to(torch.int64), want)


@pytest.mark.parametrize("m,k,n", [(4, 512, 128), (8, 256, 256),
                                   (16, 128, 64)])
def test_byte_plane_int32_cut_is_the_reference_int32_dot(m, k, n):
    """FxP12 codes (+-2047) inside the caller's bound K * qmax^2 < 2^31:
    the low 32 bits of the byte-plane sum (what the raw int16 kernel
    writes) equal `int_matmul`, `fxp_gemm_codes_plain` and the
    reference's int32 dot, bit for bit."""
    assert k * 2047 ** 2 < 2 ** 31
    rng = np.random.default_rng(m + k + n)
    xn = rng.integers(-2047, 2048, (m, k)).astype(np.int16)
    wn = rng.integers(-2047, 2048, (k, n)).astype(np.int16)
    xn[0, :] = -2047
    wn[:, 0] = -2047
    x, w = torch.from_numpy(xn), torch.from_numpy(wn)
    cut = byte_plane_matmul(x, w).to(torch.int32)
    assert torch.equal(cut, int_matmul(x, w))
    assert torch.equal(cut, fxp_gemm_codes_plain(x, w))
    ref = fxp_gemm_pallas(jnp.asarray(xn), jnp.asarray(wn), interpret=True)
    assert torch.equal(cut, torch.from_numpy(np.array(ref)))


@pytest.mark.parametrize("af", [None, "silu"])
def test_byte_plane_sum_rounds_to_the_reference_under_wide_exact(af):
    """Under the reference's wide_exact bound its int32 sum is exact: the
    byte-plane sum rounded once to f32, times the scale, then the AF, is
    the plain wide mode and the reference's fused kernel, bit for bit."""
    m, k, n = 4, 512, 128
    rng = np.random.default_rng(7)
    xn = rng.integers(-2047, 2048, (m, k)).astype(np.int16)
    wn = rng.integers(-2047, 2048, (k, n)).astype(np.int16)
    sn = (rng.random((1, n)) * 1e-6).astype(np.float32)
    x, w, s = torch.from_numpy(xn), torch.from_numpy(wn), torch.from_numpy(sn)
    plain = fxp_gemm_fused_plain(x, w, s.reshape(-1), af=af)
    if af is None:
        assert torch.equal(byte_plane_matmul(x, w).float() * s, plain)
    ref = fxp_gemm_fused_pallas(jnp.asarray(xn), jnp.asarray(wn),
                                jnp.asarray(sn), af=af, wide_exact=True,
                                interpret=True)
    assert torch.equal(plain, torch.from_numpy(np.array(ref)))


@pytest.mark.parametrize("dtypes", [(torch.int16, torch.int16),
                                    (torch.int8, torch.int16),
                                    (torch.int8, torch.int8)])
def test_wrappers_on_cpu_run_the_plain_versions(dtypes):
    """CPU tensors never reach a kernel: `fxp_gemm_fused` gives
    `fxp_gemm_fused_plain` and `fxp_gemm_codes` gives
    `fxp_gemm_codes_plain`, and no launch is counted."""
    rng = np.random.default_rng(3)
    qx = 127 if dtypes[0] == torch.int8 else 2047
    qw = 127 if dtypes[1] == torch.int8 else 2047
    x = torch.from_numpy(rng.integers(-qx, qx + 1, (5, 200))).to(dtypes[0])
    w = torch.from_numpy(rng.integers(-qw, qw + 1, (200, 24))).to(dtypes[1])
    scale = torch.from_numpy((rng.random(24) * 1e-4).astype(np.float32))
    before = (fxp_gemm_fused.launches, fxp_gemm_codes.launches)
    for af in (None, "silu"):
        assert torch.equal(fxp_gemm_fused(x, w, scale, af=af),
                           fxp_gemm_fused_plain(x, w, scale, af=af))
    assert torch.equal(fxp_gemm_codes(x, w), fxp_gemm_codes_plain(x, w))
    assert (fxp_gemm_fused.launches, fxp_gemm_codes.launches) == before


@pytest.mark.parametrize("m,k,n", [(4, 5120, 5120), (4, 5120, 1024),
                                   (4, 5120, 13824), (4, 13824, 5120),
                                   (4, 5120, 152064), (16, 5120, 5120),
                                   (32, 5120, 5120), (4, 33000, 17000),
                                   (3, 96, 1001), (64, 70000, 64)])
@pytest.mark.parametrize("core", [torch.int8, torch.int16])
def test_core_k_split_stays_under_the_cap(m, k, n, core):
    """The tensor-core core's K split: whole 128-row stages, at most
    32768 rows a block, the slices covering K, one slice where the column
    tiles alone fill the blocks it aims at (one per SM for int8 codes,
    two for int16), else at least half of them where K allows it."""
    kps = k_split(m, k, n, core=core)
    block_n, m_tiles = fx._tiles(m, False, core)
    splits = -(-k // kps)
    assert kps % 128 == 0 and 0 < kps <= CAP
    assert (splits - 1) * kps < k <= splits * kps
    tiles = -(-n // block_n) * m_tiles
    resident = 132 if core == torch.int8 else 2 * 132
    if tiles >= resident:
        assert splits == -(-k // CAP)
    elif k >= 256 * (resident // tiles):
        assert tiles * splits >= resident // 2


def test_tail_timeline_tool_matches_the_kernel_source():
    """tools/gemm_tail_timeline.py builds its probed copies of the core by
    inserting text at anchors of csrc/fxp_gemm.cu, and swaps the package's
    workspace helper for its own: every anchor is still found exactly once
    (`variants` raises otherwise), each of the six phase probes lands in
    the probed copy, the grid copy turns the int8 banks' hand-out off,
    and its workspace helper takes the package's arguments."""
    path = Path(__file__).resolve().parents[1] / "tools/gemm_tail_timeline.py"
    spec = importlib.util.spec_from_file_location("gemm_tail_timeline", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    copies = tool.variants()
    assert set(copies) == {"probed", "loop_only", "grid"}
    assert copies["probed"].count("%%globaltimer") == len(tool.PHASES)
    assert copies["loop_only"].count("return; }") == 1
    assert "kHandOut = false;" in copies["grid"]
    assert (inspect.signature(tool._probe_workspace).parameters.keys()
            == inspect.signature(fx._workspace).parameters.keys())
