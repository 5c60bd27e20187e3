"""PyTorch port: the int8 fused GEMM on the tensor-core core, on the CPU.

The fused GEMM's int8 modes, dense (`fxp_gemm_fused`) and expert banks
(`fxp_gemm_fused_batched`), run on the CUDA core of int8 tensor-core
tiles. The grid splits K across blocks; with K split each block adds its
partial tile into an int32 workspace and the last block of a tile
(counted by its semaphore) applies the epilogue. A bank's work items
(expert, row tile, K slice, column tile) are handed out from a counter to
as many blocks as fit on the card. Here the grid and workspace the
wrapper computes are checked at every int8 shape the serving paths run;
the hand-out's map from item to tile is checked to cover every output
tile once for no, one, some and every expert routed; and the int8 bank's
plain version, which the wrapper gives on the CPU and which the card's
kernel is held to bit for bit, is held per expert against the
reference's `fxp_gemm_fused_pallas` (interpret mode) with and without
SiLU at ragged M, K and N (the dense mode's ragged shapes are in
tests/test_torch_kernels.py). The kernels themselves run only on the
card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fxp_gemm.fxp_gemm import fxp_gemm_fused_pallas
from repro_torch.kernels.fxp_gemm import fxp_gemm as fx
from repro_torch.kernels.fxp_gemm.fxp_gemm import (
    fxp_gemm_fused, fxp_gemm_fused_batched, fxp_gemm_fused_batched_plain,
    fxp_gemm_fused_plain, k_split)

CAP = 32768          # rows of a block's K slice (kMaxKSplitWide)

# (E, M, K, N) of every int8 GEMM the serving paths and chip_smoke.py run:
# Qwen2.5-14B's projections at decode (4 slots) and a 16-row prefill
# chunk, DeepSeekMoE-16B's dense projections (attention, shared experts,
# lm_head) and its decode and prefill expert banks
PATH_SHAPES = [(1, 4, 5120, 5120), (1, 4, 5120, 1024), (1, 4, 5120, 13824),
               (1, 4, 13824, 5120), (1, 4, 5120, 152064),
               (1, 16, 5120, 5120), (1, 4, 2048, 2048), (1, 4, 2048, 2816),
               (1, 4, 2816, 2048), (1, 4, 2048, 102400),
               (64, 4, 2048, 1408), (64, 4, 1408, 2048),
               (64, 16, 2048, 1408)]


@pytest.mark.parametrize("e,m,k,n", PATH_SHAPES)
def test_int8_core_grid_at_the_paths_shapes(e, m, k, n):
    """128 columns a block, row tiles of 8, 16 or 32 rows; K slices of
    whole 128-row stages, at most the cap, covering K, about one block per
    SM (the split that measured fastest on the card); a dense grid's y
    (slices) and z (experts x row tiles) within 65535; the int32
    workspace [E, M, N] and one semaphore per (expert, tile) when K is
    split, the semaphores right after it, then for banks the hand-out's
    counter (its first word when K is not split), all zeroed."""
    kps = k_split(m, k, n, e)
    block_n, m_tiles = fx._tiles(m)
    rows = 8 if m <= 8 else 16 if m <= 16 else 32
    assert (block_n, m_tiles) == (128, -(-m // rows))
    splits = -(-k // kps)
    assert kps % 128 == 0 and 0 < kps <= CAP
    assert (splits - 1) * kps < k <= splits * kps
    tiles = -(-n // block_n) * m_tiles * e
    assert splits <= 65535 and e * m_tiles <= 65535
    # about one block per SM: one slice where the tiles alone fill the
    # SMs, else at least half of them
    if tiles >= 132:
        assert splits == 1
    else:
        assert 66 <= tiles * splits <= 132
    x = torch.zeros((e, m, k), dtype=torch.int8)
    bank = e > 1                          # the hand-out's counter
    got_kps, ws, sem = fx._workspace(x, e, m, k, n, False, handout=bank)
    assert got_kps == kps and ws.dtype == torch.int32
    assert not ws.any()
    if splits > 1:
        assert ws.numel() == e * m * n + tiles + bank
        assert sem == ws.data_ptr() + 4 * e * m * n
    else:
        assert ws.numel() == 1 and sem == ws.data_ptr()


def _bank(rng, e, m, k, routed):
    """int8 codes [e, m, k]: the `routed` experts' queues hold 1 to m
    rows (a nonzero first code each), the rest zero."""
    x = np.zeros((e, m, k), dtype=np.int8)
    for i in routed:
        rows = int(rng.integers(1, m + 1))
        x[i, :rows] = rng.integers(-127, 128, (rows, k))
        x[i, :rows, 0] = 1
    return x


def handout_item(i, gx, gy, m_tiles):
    """The int8 bank kernel's map from the item it claimed to (expert, row
    tile, K slice, column tile): x = i % gx, y = i / gx % gy, z = i /
    (gx gy), z walking (expert, row tile)."""
    z = i // (gx * gy)
    return z // m_tiles, z % m_tiles, i // gx % gy, i % gx


@pytest.mark.parametrize("e,m,k,n,kps", [(64, 4, 2048, 1408, None),
                                         (64, 16, 2048, 1408, None),
                                         (6, 4, 1030, 300, 256),
                                         (5, 20, 700, 260, 256)])
@pytest.mark.parametrize("routed", ["none", "one", "some", "all"])
def test_bank_handout_covers_every_tile_once(e, m, k, n, kps, routed):
    """The items an int8 bank hands out, claimed from the counter in
    order by whichever block is free, cover each (expert, row tile, column
    tile) once per K slice: each semaphore (z gx + x) counts to the
    slices, so the last slice writes each output tile once, and the
    counter, which lies past the last semaphore, is none of them. Only
    items whose A slice holds a code stream weights: none with no expert
    routed; every item still writes its tile (AF(0) when unrouted)."""
    kps = kps or k_split(m, k, n, e)
    block_n, m_tiles = fx._tiles(m)
    rows = 8 if m <= 8 else 16 if m <= 16 else 32
    gx, gy = -(-n // block_n), -(-k // kps)
    items = gx * gy * e * m_tiles
    rng = np.random.default_rng(e * 31 + k + len(routed))
    experts = {"none": [], "one": [e - 1], "some": list(range(0, e, 3)),
               "all": list(range(e))}[routed]
    x = _bank(rng, e, m, k, experts)
    slices, streamed = {}, 0
    for i in range(items):
        expert, mt, sl, nt = handout_item(i, gx, gy, m_tiles)
        sem = (expert * m_tiles + mt) * gx + nt
        if gy > 1:                       # the counter at items / gy
            assert sem < items // gy
        slices.setdefault(sem, []).append(sl)
        streamed += bool(x[expert, mt * rows:(mt + 1) * rows,
                           sl * kps:(sl + 1) * kps].any())
    assert len(slices) == e * m_tiles * gx
    assert all(sorted(s) == list(range(gy)) for s in slices.values())
    live = sum(bool(x[i, mt * rows:(mt + 1) * rows,
                      sl * kps:(sl + 1) * kps].any())
               for i in range(e) for mt in range(m_tiles)
               for sl in range(gy))
    assert streamed == live * gx
    assert (streamed == 0) == (routed == "none")


@pytest.mark.parametrize("m,k,n", [(4, 200, 130), (16, 96, 257),
                                   (20, 1030, 64)])
@pytest.mark.parametrize("routed", ["none", "one", "some", "all"])
@pytest.mark.parametrize("af", [None, "silu"])
def test_int8_bank_is_the_reference_per_expert(m, k, n, routed, af):
    """`fxp_gemm_fused_batched` on int8 CPU tensors (the plain loop) with
    no, one, some and every expert routed equals the reference's fused
    kernel on each expert (interpret mode), AF(0 * scale) on empty
    queues."""
    e = 4
    rng = np.random.default_rng(m + k + n + len(routed))
    experts = {"none": [], "one": [2], "some": [0, 3],
               "all": list(range(e))}[routed]
    x = _bank(rng, e, m, k, experts)
    w = rng.integers(-127, 128, (e, k, n)).astype(np.int8)
    s = (rng.random((e, 1, n)) * 1e-3).astype(np.float32)
    got = fxp_gemm_fused_batched(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(s), af=af)
    assert got.shape == (e, m, n)
    for i in range(e):
        ref = fxp_gemm_fused_pallas(jnp.asarray(x[i]), jnp.asarray(w[i]),
                                    jnp.asarray(s[i]), af=af,
                                    blocks=(m, n, k), interpret=True)
        assert torch.equal(got[i], torch.from_numpy(np.array(ref)))


def test_int8_wrappers_on_cpu_run_the_plain_versions():
    """CPU tensors never reach a kernel: the int8 dense and bank entries
    give their plain versions, and no launch is counted."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-127, 128, (3, 5, 160)
                                      ).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (3, 160, 70)
                                      ).astype(np.int8))
    s = torch.from_numpy((rng.random((3, 70)) * 1e-3).astype(np.float32))
    before = (fxp_gemm_fused.launches, dict(fxp_gemm_fused.launches_by_mode))
    assert torch.equal(fxp_gemm_fused(x[0], w[0], s[0], af="silu"),
                       fxp_gemm_fused_plain(x[0], w[0], s[0], af="silu"))
    assert torch.equal(fxp_gemm_fused_batched(x, w, s, af="silu"),
                       fxp_gemm_fused_batched_plain(x, w, s, af="silu"))
    assert (fxp_gemm_fused.launches,
            fxp_gemm_fused.launches_by_mode) == before
