"""PyTorch port: the plan of the paged decode attentions' cluster launch,
on the CPU.

`cluster_size` picks C, the CTAs of the thread-block cluster that splits
one (row, KV head) of the kernels in csrc/paged_attention.cu, from the
launch's shapes and the CTAs the card holds at once (`slots`, which the
wrapper asks of the occupancy API; here a model of a card with `sms` SMs
holding `per_sm` CTAs each). Held over table widths, block sizes, rows,
KV heads and SM counts: C is one of 1, 2, 4 and 8; every CTA of a full
table can own two pool blocks (2 C <= MB); the grid fits in the card's
slots (B x KV x C <= slots(C)) unless C is 1; no larger C meets both; and
C follows from shapes alone (no `meta`, which lives on the device). On an
H100-sized card, 4 rows x 8 KV heads at 1024-2000 cached tokens split
each row at least two ways. The kernels themselves, and the plan the
wrapper computes on the card, are held in tests/test_torch_cuda.py."""
import inspect

import pytest

from repro_torch.kernels.paged_attention.paged_attention import (
    CLUSTER_SIZES, cluster_size)


def slots_model(sms, per_sm):
    return lambda c: sms * per_sm


# (cached tokens of the widest row, pool block size): table widths from
# the serve paths' rows to Qwen2.5-14B's 131072-token context
WIDTHS = [(80, 16), (1023, 16), (2000, 16), (2000, 32), (12000, 16),
          (131072, 16), (100, 4)]
# (rows, KV heads): decode at 4 slots under Qwen2.5-14B (8 KV heads) and
# DeepSeekMoE-16B (16), a single row, and batches past the card
BATCHES = [(4, 8), (4, 16), (1, 8), (64, 8)]
CARDS = [(132, 3), (66, 2), (8, 1)]


@pytest.mark.parametrize("sms,per_sm", CARDS)
@pytest.mark.parametrize("b,kvh", BATCHES)
@pytest.mark.parametrize("tokens,bs", WIDTHS)
def test_cluster_size_rule(tokens, bs, b, kvh, sms, per_sm):
    mb = -(-(tokens + 1) // bs)
    slots = slots_model(sms, per_sm)
    c = cluster_size(b, kvh, mb, slots)
    assert c in CLUSTER_SIZES
    if c > 1:
        assert 2 * c <= mb
        assert b * kvh * c <= slots(c)
    # the largest that meets both
    for cand in CLUSTER_SIZES:
        if cand > c:
            assert 2 * cand > mb or b * kvh * cand > slots(cand)
    # shapes only: the same call gives the same C
    assert cluster_size(b, kvh, mb, slots) == c


@pytest.mark.parametrize("per_sm", [1, 2, 3])
@pytest.mark.parametrize("tokens", [1024, 1536, 2000])
def test_decode_rows_split_on_an_h100(tokens, per_sm):
    """4 rows x 8 KV heads at 1024-2000 cached tokens (blocks of 16): at
    least two CTAs per row on 132 SMs, and no more than the table's
    blocks."""
    mb = -(-(tokens + 1) // 16) + 2
    c = cluster_size(4, 8, mb, slots_model(132, per_sm))
    assert 2 <= c <= mb


def test_cluster_size_takes_shapes_only():
    assert list(inspect.signature(cluster_size).parameters) == [
        "b", "kvh", "mb", "slots"]
