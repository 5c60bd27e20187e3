"""PyTorch port: the arithmetic of the fused GEMM's x32 mode (FxP24/32
codes in int32) on the tensor-core core, on the CPU.

The kernel splits each int32 code c into four byte planes, a signed top
byte c >> 24 and three unsigned bytes, takes the 16 plane products on
int8 tensor-core tiles into seven int32 accumulators grouped by their
weight 2^(8s), each summing at most 8192 rows (a warp's share of a
block's 32768-row K slice), and combines the groups into an exact 128-bit
sum that it rounds once to f32. `x32_plane_matmul` is that arithmetic in
plain PyTorch, int32 wrap per accumulator included. Here it is held bit
for bit against the plain version's exact product (`limb_matmul`) and
against Python integers, over random codes and codes at the ends of int32
(+-(2^31 - 1) and -2^31), at the accumulator cap and past it; a slice
past the cap is shown to wrap. Then the core's K split and workspace for
int32 codes, the wrappers' plain path on CPU tensors, and a pin that
ties the kernel source's constants to this package (the tail-timeline
tool's anchors are pinned by tests/test_torch_gemm_tc.py). The kernel
itself runs only on the card (tests/test_torch_cuda.py and chip_smoke.py
hold it bit-equal to `fxp_gemm_fused_plain` there).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.fxp_gemm import fxp_gemm as fx
from repro_torch.kernels.fxp_gemm.fxp_gemm import (
    FUSED_AFS, fxp_gemm_codes, fxp_gemm_codes_plain, fxp_gemm_fused,
    fxp_gemm_fused_plain, k_split, limb_matmul, limbs_to_f32,
    x32_plane_matmul)

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
ACC_ROWS = 8192      # tc::kMaxAccRowsX32: rows one int32 accumulator sums
CAP = 32768          # tc::kMaxKSplitWide: rows of a block's K slice
SRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/fxp_gemm.cu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite's parallel
    workers each take a thread per core, and the small int64 products
    here would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(rng, shape, kind):
    """int32 codes: uniform over the full range, or half of them at the
    range ends and next to them."""
    v = rng.integers(I32_MIN, I32_MAX, shape, endpoint=True)
    if kind == "ends":
        ends = np.array([I32_MAX, I32_MIN, I32_MIN + 1, I32_MAX - 1, 0, -1])
        v = np.where(rng.random(shape) < 0.5,
                     ends[rng.integers(0, len(ends), shape)], v)
    return torch.from_numpy(v.astype(np.int32))


def _limbs_equal(got, want):
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _python_sum(x, w):
    """The exact product as Python integers (object arrays)."""
    return x.numpy().astype(object) @ w.numpy().astype(object)


def _as_int(limbs):
    hi, lo = limbs
    return hi.numpy().astype(object) * (1 << 32) + lo.numpy()


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (4, 33, 7), (5, 300, 16),
                                   (16, 1030, 33)])
@pytest.mark.parametrize("kind", ["uniform", "ends"])
def test_x32_plane_matmul_is_the_exact_sum(m, k, n, kind):
    """Random int32 codes over the full range, or half at its ends: the
    byte-plane sum, limbs and all, equals `limb_matmul` (what the plain
    version rounds) and the Python-integer product."""
    rng = np.random.default_rng(m * 1009 + k + n)
    x, w = _codes(rng, (m, k), kind), _codes(rng, (k, n), kind)
    got = x32_plane_matmul(x, w)
    assert got[0].dtype == got[1].dtype == torch.int64
    assert ((got[1] >= 0) & (got[1] < 1 << 32)).all()
    assert _limbs_equal(got, limb_matmul(x, w))
    assert (_as_int(got) == _python_sum(x, w)).all()


@pytest.mark.parametrize("code", [I32_MAX, I32_MIN, I32_MIN + 1])
def test_x32_plane_matmul_all_extreme_rows(code):
    """Rows of one extreme code against columns of each extreme code and
    of their negations: sums of K * 2^62, past 2^64, exact in the
    128-bit combine; rounded once, the plain version's f32."""
    k = 4099
    x = torch.tensor([[I32_MAX], [I32_MIN], [I32_MIN + 1], [code]],
                     dtype=torch.int32).expand(4, k).contiguous()
    w = torch.tensor([[code, -I32_MAX, I32_MIN, 0]],
                     dtype=torch.int32).expand(k, 4).contiguous()
    got = x32_plane_matmul(x, w)
    sums = _python_sum(x, w)
    assert (_as_int(got) == sums).all()
    assert max(abs(v) for v in sums.ravel()) > 1 << 64
    assert torch.equal(limbs_to_f32(*got), limbs_to_f32(*limb_matmul(x, w)))


def _worst_rows(k):
    """Codes whose three low bytes are 255 (0x00FFFFFF) against
    themselves: the s = 2 plane group, three u8 x u8 products of 255^2 a
    row, the largest any group adds, beside codes at the ends of int32
    (the s = 3 group's two signed products)."""
    x = torch.full((3, k), 0x00FFFFFF, dtype=torch.int32)
    x[1] = I32_MAX
    x[2] = I32_MIN
    w = torch.full((k, 3), 0x00FFFFFF, dtype=torch.int32)
    w[:, 1] = I32_MIN
    w[:, 2] = -I32_MAX
    return x, w


@pytest.mark.parametrize("k", [ACC_ROWS - 1, ACC_ROWS, ACC_ROWS + 1,
                               2 * ACC_ROWS + 5])
def test_x32_plane_matmul_at_the_accumulator_cap(k):
    """The worst codes at K on both sides of an accumulator's 8192 rows:
    every slice's int32 groups stay exact, whether K fits one slice or
    spills into the next, and so does a cut into the kernel's smaller
    slices (exact integer sums do not depend on the cut)."""
    x, w = _worst_rows(k)
    want = limb_matmul(x, w)
    assert _limbs_equal(x32_plane_matmul(x, w), want)
    assert (_as_int(want) == _python_sum(x, w)).all()
    small = x32_plane_matmul(x, w, rows=1024)
    assert _limbs_equal(small, want)


def test_x32_planes_past_the_cap_overflow():
    """Why the cap: the s = 2 group of the worst codes adds 3 * 255^2 =
    195075 a row, so one accumulator over 12000 rows sums 2.34e9 > 2^31
    and wraps, and the emulation with such slices leaves the exact sum;
    at 8192 rows a slice it is exact."""
    k = 12000
    x, w = _worst_rows(k)
    g2 = sum(((x.long() >> 8 * i) & 255)[:1] @ ((w.long() >> 8 * j) & 255)
             [:, :1] for i, j in ((0, 2), (1, 1), (2, 0)))
    assert int(g2) == 3 * 255 ** 2 * k > 2 ** 31
    want = limb_matmul(x, w)
    assert not _limbs_equal(x32_plane_matmul(x, w, rows=k), want)
    assert _limbs_equal(x32_plane_matmul(x, w), want)
    assert 3 * 255 ** 2 * ACC_ROWS < 2 ** 31


@pytest.mark.parametrize("af", (None,) + FUSED_AFS)
def test_x32_plane_sum_rounds_to_the_plain_version(af):
    """The byte-plane sum rounded once to f32 (`limbs_to_f32`), times the
    scale, then the AF, is the fused plain version bit for bit: what the
    kernel is held to on the card."""
    m, k, n = 4, 700, 40
    rng = np.random.default_rng(len(af or ""))
    x, w = _codes(rng, (m, k), "ends"), _codes(rng, (k, n), "uniform")
    scale = torch.from_numpy((rng.random(n) * 2.0 ** -60).astype(np.float32))
    want = fxp_gemm_fused_plain(x, w, scale, af=af, hr_stages=8,
                                lv_stages=10)
    out = limbs_to_f32(*x32_plane_matmul(x, w)) * scale.reshape(1, -1)
    if af is not None:
        out = fx.cordic_af_plain(out, af, 8, 10)
    assert torch.equal(out, want)


@pytest.mark.parametrize("m,k,n,want", [
    (4, 5120, 5120, 3), (4, 5120, 1024, 8), (4, 5120, 13824, 3),
    (4, 13824, 5120, 3), (4, 5120, 152064, 1), (16, 5120, 5120, 3),
    (13, 1030, 130, 1), (4, 32768, 8448, 1), (4, 40000, 8448, 2),
    (5, 70000, 130, 46)])
def test_core_k_split_of_int32_codes(m, k, n, want):
    """The core's K split for int32 codes: whole 128-row stages, at most
    32768 rows a block (a quarter, 8192, a warp, the accumulators' cap),
    the slices covering K; the fewest slices of at least 640 rows whose
    (column tile of 32, row tile, slice) items fill the last wave of two
    blocks an SM to 90% (the K cap may ask for more), else the fullest."""
    kps = k_split(m, k, n, core=torch.int32)
    block_n, m_tiles = fx._tiles(m, core=torch.int32)
    assert block_n == 32 and m_tiles == -(-m // (8 if m <= 8 else 16))
    splits = -(-k // kps)
    assert splits == want
    assert kps % 128 == 0 and 0 < kps <= CAP and kps // 4 <= ACC_ROWS
    assert (splits - 1) * kps < k <= splits * kps
    tiles = -(-n // block_n) * m_tiles

    def fill(s):
        return tiles * s / (-(-tiles * s // 264) * 264)
    rule = fx._x32_splits(k, tiles)
    fills = [fill(s) for s in range(1, max(1, k // 640) + 1)]
    assert fill(rule) >= 0.9 or fill(rule) == max(fills)
    assert all(f < 0.9 for f in fills[:rule - 1])
    # the rule's slices, rounded up to whole stages (which may leave
    # fewer), or the cap's
    asked = max(rule, -(-k // CAP))
    assert kps == -(-(-(-k // asked)) // 128) * 128
    assert kps >= 640 or splits == 1


@pytest.mark.parametrize("m,k,n", [(4, 5120, 1024), (4, 40000, 8448),
                                   (16, 300, 33), (4, 5120, 152064)])
def test_x32_workspace_holds_128_bits_an_entry(m, k, n):
    """With K split the workspace holds four int32 words (one 128-bit
    sum) per output, then one zeroed semaphore per (row tile, column
    tile) of 32 columns; unsplit, one zeroed word."""
    x = torch.zeros((m, k), dtype=torch.int32)
    kps, ws, sem = fx._workspace(x, 1, m, k, n, False, torch.int32)
    assert kps == k_split(m, k, n, core=torch.int32)
    assert ws.dtype == torch.int32 and not ws.any()
    tiles = -(-n // 32) * -(-m // (8 if m <= 8 else 16))
    if kps < k:
        assert ws.numel() == 4 * m * n + tiles
        assert sem == ws[4 * m * n:].data_ptr()
        assert ws.data_ptr() % 16 == 0
    else:
        assert ws.numel() == 1


@pytest.mark.parametrize("dtypes", [(torch.int32, torch.int32),
                                    (torch.int8, torch.int32),
                                    (torch.int32, torch.int16)])
def test_int32_wrappers_on_cpu_run_the_plain_versions(dtypes):
    """CPU tensors never reach a kernel: on int32 codes (or one int32
    operand beside a narrower one) `fxp_gemm_fused` gives
    `fxp_gemm_fused_plain` and `fxp_gemm_codes` gives
    `fxp_gemm_codes_plain`, and no launch is counted."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(-127, 128, (5, 200))).to(dtypes[0])
    w = torch.from_numpy(rng.integers(-2047, 2048, (200, 24))).to(dtypes[1])
    scale = torch.from_numpy((rng.random(24) * 1e-6).astype(np.float32))
    before = (fxp_gemm_fused.launches, dict(fxp_gemm_fused.launches_by_mode),
              fxp_gemm_codes.launches)
    for af in (None, "silu"):
        assert torch.equal(fxp_gemm_fused(x, w, scale, af=af),
                           fxp_gemm_fused_plain(x, w, scale, af=af))
    assert torch.equal(fxp_gemm_codes(x, w), fxp_gemm_codes_plain(x, w))
    assert (fxp_gemm_fused.launches, fxp_gemm_fused.launches_by_mode,
            fxp_gemm_codes.launches) == before


def _constant(name):
    found = re.findall(rf"constexpr int {name} = (\d+);", SRC.read_text())
    assert len(found) == 1, name
    return int(found[0])


def test_kernel_source_constants_match_the_wrapper():
    """The wrapper's split and workspace rest on the kernel's constants:
    the stage's rows and bytes, the block's K cap and the x32 mode's
    accumulator cap, whose arithmetic (the largest group adds 195330 a
    row) keeps 8192 rows under 2^31; the CUDA-core x32 kernel is gone."""
    assert _constant("kRowBytes") == fx._TC_ROW_BYTES == 128
    assert _constant("kBK") == fx._TC_BLOCK_K
    assert _constant("kMaxKSplitWide") == fx._MAX_KPS_WIDE == CAP
    assert _constant("kMaxAccRowsX32") == fx._MAX_ACC_ROWS_X32 == ACC_ROWS
    assert (2 * 255 ** 2 + 2 * 128 * 255) * ACC_ROWS < 2 ** 31
    assert CAP // 4 == ACC_ROWS          # four warps share a block's slice
    src = SRC.read_text()
    assert "fxp_gemm_x32_kernel" not in src
    assert "tc::dispatch<int32_t, false>" in src
