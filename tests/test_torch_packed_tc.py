"""PyTorch port: the packed FxP4 GEMM on the tensor-core core, on the CPU.

The packed modes of the fused GEMM (dense and expert banks) and the raw
packed GEMM run on the CUDA core of int8 tensor-core tiles. There each
weight byte's nibbles become int8 fragments by two logic operations: the
low nibble shifted into the byte's high half, the high nibble masked in
place, each then 16 times its code; the int32 products sum to 16 times
the exact sum, and an arithmetic shift takes the factor back off before
the warps' tiles are summed. Here that arithmetic is modelled in numpy
and plain PyTorch and held bit for bit against `unpack_nibbles` and the
exact product; the packed plain versions, which the wrappers give on the
CPU, are held bit for bit against the reference's Pallas kernels
(`fxp_gemm_fused_pallas(packed=True)`, `fxp4_gemm_packed_pallas`,
interpret mode) at the core's tile edges (16 and 32 rows, N odd and not
a multiple of its 256 columns, K not a multiple of its 128-row stage);
and the grid the wrapper computes (K split, row tiles, workspace) is
checked at every shape the serving paths run. The kernels themselves
run only on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fxp_gemm.fxp_gemm import (fxp4_gemm_packed_pallas,
                                             fxp_gemm_fused_pallas)
from repro_torch.kernels.fxp_gemm import fxp_gemm as fx
from repro_torch.kernels.fxp_gemm.fxp_gemm import (
    fxp4_gemm_packed, fxp4_gemm_packed_plain, fxp_gemm_fused,
    fxp_gemm_fused_batched, fxp_gemm_fused_batched_plain,
    fxp_gemm_fused_plain, k_split, unpack_nibbles)

CAP = 32768          # rows of a block's K slice (kMaxKSplitWide)
SMS = 132

# (E, M, K, N) of every packed GEMM the serving paths and chip_smoke.py
# run: Qwen2.5-14B's projections at decode (4 slots) and a 16-row prefill
# chunk, the raw packed GEMM's 32 rows, DeepSeekMoE-16B's expert banks
PATH_SHAPES = [(1, 4, 5120, 5120), (1, 4, 5120, 1024), (1, 4, 5120, 13824),
               (1, 4, 13824, 5120), (1, 4, 5120, 152064),
               (1, 16, 5120, 5120), (1, 32, 5120, 5120),
               (64, 4, 2048, 1408), (64, 4, 1408, 2048),
               (64, 16, 2048, 1408)]


@pytest.mark.parametrize("e,m,k,n", PATH_SHAPES)
def test_packed_core_grid_at_the_paths_shapes(e, m, k, n):
    """256 columns a block, row tiles of 8, 16 or 32 rows; K slices of
    whole 128-row stages, at most the cap, covering K; grid y and z
    within 65535; where K allows (at least 256 rows a slice), at least
    half the blocks that fit at once (two to an SM, one for 32-row
    tiles; rounding slices up to whole stages loses the rest); the int32
    workspace [E, M, N] plus one semaphore per (expert, tile) when K is
    split, the semaphores right after it."""
    kps = k_split(m, k, n, e, packed=True)
    block_n, m_tiles = fx._tiles(m, packed=True)
    rows = 8 if m <= 8 else 16 if m <= 16 else 32
    assert (block_n, m_tiles) == (256, -(-m // rows))
    splits = -(-k // kps)
    assert kps % 128 == 0 and 0 < kps <= CAP
    assert (splits - 1) * kps < k <= splits * kps
    assert splits <= 65535 and e * m_tiles <= 65535
    tiles = -(-n // block_n) * m_tiles * e
    resident = SMS if rows == 32 else 2 * SMS
    if tiles >= resident:
        assert splits == 1
    elif k >= 256 * (resident // tiles):
        assert tiles * splits >= resident // 2
    x = torch.zeros((e, m, k), dtype=torch.int8)
    got_kps, ws, sem = fx._workspace(x, e, m, k, n, True)
    assert got_kps == kps and ws.dtype == torch.int32
    if splits > 1:
        assert ws.numel() == e * m * n + tiles
        assert sem == ws.data_ptr() + 4 * e * m * n
    else:
        assert ws.numel() == 1 and sem == ws.data_ptr()


def test_packed_core_split_at_n_1024():
    """wk and wv (N 1024) have four column tiles of 256: the K split
    keeps the core's least slice of 256 rows, 20 slices, 80 blocks (the
    int8 core's 128 columns give 14 slices of 384 rows, 112 blocks, about
    one per SM); slices of one 128-row stage would fill the card with 160
    blocks at twice the split-K adds per output, and were not faster on
    the card."""
    kps = k_split(4, 5120, 1024, packed=True)
    assert kps == 256 and -(-5120 // kps) * 4 == 80
    kps = k_split(4, 5120, 1024, core=torch.int8)
    assert kps == 384 and -(-5120 // kps) * 8 == 112


def _words(tile):
    """uint8 [rows, 4] -> uint32 [rows]: byte b of a row is bits 8b.."""
    return tile.astype(np.uint32) @ (256 ** np.arange(4, dtype=np.uint32))


@pytest.mark.parametrize("shift", range(4))
def test_nibble_fragments_are_16_times_the_codes(shift):
    """The kernel's fragments of four rows' words (every byte value, in
    every byte position over the four shifts): transposed so that word b
    holds byte b of rows 0..3, the low nibbles shifted into the bytes'
    high halves and the high nibbles masked in place read, byte j as an
    int8, 16 times the code of row j in column 2b and 2b + 1 that
    `unpack_nibbles` gives."""
    raw = np.roll(np.arange(256, dtype=np.uint8), shift).reshape(64, 4)
    want = unpack_nibbles(torch.from_numpy(raw.view(np.int8))).numpy()
    for r0 in range(0, 64, 4):
        tile = raw[r0:r0 + 4]
        for b in range(4):
            pair = _words(tile[:, b][None, :])[0]     # transpose4's word b
            lo = np.uint32((int(pair) << 4) & 0xF0F0F0F0)
            hi = np.uint32(int(pair) & 0xF0F0F0F0)
            for word, col in ((lo, 2 * b), (hi, 2 * b + 1)):
                got = np.frombuffer(np.uint32(word).tobytes(), np.int8)
                assert np.array_equal(got.astype(np.int32),
                                      16 * want[r0:r0 + 4, col]), (r0, b)


def _x16_matmul(x, w_bytes, n, kps):
    """The core's packed arithmetic in plain PyTorch: int8 codes x [M, K]
    against the weight's nibbles as 16 c (int8), int32 sums over each
    K slice of `kps` rows, each shifted right by 4, then added -> int64
    [M, n]."""
    b = w_bytes.to(torch.int64) & 255
    lo = ((b << 4) & 0xF0).to(torch.uint8).view(torch.int8)
    hi = (b & 0xF0).to(torch.uint8).view(torch.int8)
    w16 = torch.stack([lo, hi], dim=-1).reshape(b.shape[0], -1)[:, :n]
    xs = x.to(torch.int64)
    total = torch.zeros((x.shape[0], n), dtype=torch.int64)
    for k0 in range(0, x.shape[1], kps):
        part = xs[:, k0:k0 + kps] @ w16[k0:k0 + kps].to(torch.int64)
        assert part.abs().max() < 2 ** 31 and (part % 16 == 0).all()
        total += part >> 4
    return total


@pytest.mark.parametrize("m,k,n,kind", [(4, 5120, 1023, "uniform"),
                                        (3, CAP, 5, "ends"),
                                        (2, CAP + 200, 4, "ends"),
                                        (16, 1030, 257, "uniform")])
def test_x16_sum_is_the_exact_product(m, k, n, kind):
    """Sums of 16 times the codes, per K slice of the wrapper's split
    (and of the cap), stay within int32 (16 * 8 * 128 * 32768 = 2^29 at
    codes -128 and -8) and shift back to the exact product, equal to the
    raw packed plain version's int32 sums."""
    rng = np.random.default_rng(m + k + n)
    nb = -(-n // 2)
    if kind == "uniform":
        x = rng.integers(-128, 128, (m, k)).astype(np.int8)
        wb = rng.integers(-128, 128, (k, nb)).astype(np.int8)
    else:
        x = np.full((m, k), -128, dtype=np.int8)
        wb = np.full((k, nb), -120, dtype=np.int8)   # 0x88: codes -8, -8
        x[1:, ::3] = 127
    x, wb = torch.from_numpy(x), torch.from_numpy(wb)
    exact = x.to(torch.int64) @ unpack_nibbles(wb, n).to(torch.int64)
    for kps in (k_split(m, k, n, packed=True), CAP):
        assert torch.equal(_x16_matmul(x, wb, n, kps), exact)
    assert torch.equal(fxp4_gemm_packed_plain(x, wb)[:, :n],
                       exact.to(torch.int32))


# M 16 and 32 rows (the core's row tiles), N odd and not a multiple of
# 256 (N <= 2 NB: the last byte's high nibble belongs to no column), K not
# a multiple of 128
EDGES = [(16, 200, 513), (32, 96, 255), (16, 1030, 1001), (32, 130, 300)]


@pytest.mark.parametrize("m,k,n", EDGES)
@pytest.mark.parametrize("af", [None, "silu"])
def test_packed_plain_is_the_reference_at_the_tile_edges(m, k, n, af):
    """`fxp_gemm_fused_plain(packed=True)` (what the wrapper gives on the
    CPU, and what the card's kernel is held to bit for bit) equals the
    reference's `fxp_gemm_fused_pallas(packed=True)` in interpret mode,
    one block over the whole product, on its first N columns."""
    rng = np.random.default_rng(m * 7 + k + n)
    nb = -(-n // 2)
    xn = rng.integers(-8, 8, (m, k)).astype(np.int8)
    wn = rng.integers(-128, 128, (k, nb)).astype(np.int8)
    sn = (rng.random((1, 2 * nb)) * 1e-2).astype(np.float32)
    ref = fxp_gemm_fused_pallas(jnp.asarray(xn), jnp.asarray(wn),
                                jnp.asarray(sn), packed=True, af=af,
                                blocks=(m, 2 * nb, k), interpret=True)
    got = fxp_gemm_fused_plain(torch.from_numpy(xn), torch.from_numpy(wn),
                               torch.from_numpy(sn[0, :n]), af=af,
                               packed=True)
    assert got.shape == (m, n)
    assert torch.equal(got, torch.from_numpy(np.array(ref)[:, :n]))


@pytest.mark.parametrize("m,k,nb", [(16, 200, 257), (32, 96, 128),
                                    (33, 1030, 65)])
def test_raw_packed_plain_is_the_reference(m, k, nb):
    """`fxp4_gemm_packed_plain` equals the reference's
    `fxp4_gemm_packed_pallas` (interpret mode) bit for bit, activation
    codes over the whole int8 range."""
    rng = np.random.default_rng(m + k + nb)
    xn = rng.integers(-128, 128, (m, k)).astype(np.int8)
    wn = rng.integers(-128, 128, (k, nb)).astype(np.int8)
    ref = fxp4_gemm_packed_pallas(jnp.asarray(xn), jnp.asarray(wn),
                                  blocks=(m, 2 * nb, k), interpret=True)
    got = fxp4_gemm_packed_plain(torch.from_numpy(xn), torch.from_numpy(wn))
    assert torch.equal(got, torch.from_numpy(np.array(ref)))


def test_packed_bank_plain_is_the_reference_per_expert():
    """The packed bank's plain loop, with an expert no row routes to, a
    full queue and a one-row queue, equals the reference's packed kernel
    on each expert (interpret mode), AF(0 * scale) on the empty rows."""
    rng = np.random.default_rng(5)
    e, m, k, n = 3, 16, 200, 301
    nb = -(-n // 2)
    x = rng.integers(-8, 8, (e, m, k)).astype(np.int8)
    x[0] = 0
    x[2, 1:] = 0
    w = rng.integers(-128, 128, (e, k, nb)).astype(np.int8)
    s = (rng.random((e, 1, 2 * nb)) * 1e-2).astype(np.float32)
    got = fxp_gemm_fused_batched_plain(
        torch.from_numpy(x), torch.from_numpy(w),
        torch.from_numpy(s[:, :, :n].copy()), af="silu", packed=True)
    for i in range(e):
        ref = fxp_gemm_fused_pallas(jnp.asarray(x[i]), jnp.asarray(w[i]),
                                    jnp.asarray(s[i]), packed=True, af="silu",
                                    blocks=(m, 2 * nb, k), interpret=True)
        assert torch.equal(got[i], torch.from_numpy(np.array(ref)[:, :n]))


def test_packed_wrappers_on_cpu_run_the_plain_versions():
    """CPU tensors never reach a kernel: the packed dense, bank and raw
    entries give their plain versions, and no launch is counted."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(-8, 8, (2, 5, 160)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (2, 160, 33)
                                      ).astype(np.int8))
    s = torch.from_numpy((rng.random((2, 65)) * 1e-3).astype(np.float32))
    before = (fxp_gemm_fused.launches, dict(fxp_gemm_fused.launches_by_mode),
              fxp4_gemm_packed.launches)
    assert torch.equal(fxp_gemm_fused(x[0], w[0], s[0], af="silu",
                                      packed=True),
                       fxp_gemm_fused_plain(x[0], w[0], s[0], af="silu",
                                            packed=True))
    assert torch.equal(fxp_gemm_fused_batched(x, w, s, packed=True),
                       fxp_gemm_fused_batched_plain(x, w, s, packed=True))
    assert torch.equal(fxp4_gemm_packed(x[0], w[0]),
                       fxp4_gemm_packed_plain(x[0], w[0]))
    assert (fxp_gemm_fused.launches, fxp_gemm_fused.launches_by_mode,
            fxp4_gemm_packed.launches) == before
