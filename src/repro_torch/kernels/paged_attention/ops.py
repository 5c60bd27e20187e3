"""Policy-level entry for paged decode attention: turns the model's call
(q [B, 1, H, hd], pools, tables, per-row lengths) into the kernels'
arguments — the [B, 3] (lengths, kv_valid, causal bound) metadata, the
[B, KV, g, hd] query layout, and the exp/divide flavour from the policy
(`attn_softmax == 'cordic'` runs HR exp and the LV divide, whose stage
count follows the table width MB*bs, not the valid length).

Integer attention (`int_attention` with an FxP pool) quantizes q / sqrt(hd)
per head over hd here, as the reference does outside its kernel, and its
causal bound is the query's absolute position; the float path's is the
row's cache length."""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...core.activation import default_stages, softmax_lv_stages
from ...core.fxp import FORMATS, quantize


def paged_attention(q, k_pool, v_pool, k_scale, v_scale, block_tables, *,
                    lengths, kv_valid, positions, fmt=None,
                    int_attention: bool = False,
                    policy: Optional[object] = None, impl, int_impl=None):
    """Decode attention off the block pool through `impl` (the float
    kernel wrapper or its plain version) or, for integer attention,
    `int_impl` (the integer kernel wrapper or its plain version).
    q: [B, 1, H, hd] -> [B, 1, H, hd] in q.dtype."""
    b, s1, h, hd = q.shape
    if s1 != 1:
        raise ValueError("paged decode attention takes one query (Sq = 1)")
    kvh = k_pool.shape[2]
    g = h // kvh
    lens = torch.broadcast_to(torch.as_tensor(lengths, dtype=torch.int32,
                                              device=q.device), (b,))
    kvv = torch.broadcast_to(torch.as_tensor(kv_valid, dtype=torch.int32,
                                             device=q.device), (b,))
    if fmt is not None and int_attention:
        fmt = FORMATS[fmt] if isinstance(fmt, str) else fmt
        meta = torch.stack([lens, kvv, positions[:, 0].to(torch.int32)],
                           dim=1)
        qc, sq = quantize(q.float() / math.sqrt(hd), fmt, axis=3)
        out = int_impl(qc[:, 0].reshape(b, kvh, g, hd),
                       sq[:, 0].reshape(b, kvh, g, 1), k_pool, v_pool,
                       k_scale, v_scale, block_tables, meta, fmt=fmt,
                       out_dtype=q.dtype)
        return out.reshape(b, 1, h, hd)
    meta = torch.stack([lens, kvv, lens], dim=1)
    cordic_softmax = (policy is not None
                      and policy.attn_softmax == "cordic")
    af = policy.af if policy is not None else None
    hr, _ = default_stages(af)
    skv = block_tables.shape[1] * k_pool.shape[1]          # MB * bs
    out = impl(q[:, 0].reshape(b, kvh, g, hd), k_pool, v_pool,
               block_tables, meta,
               k_scale=k_scale if fmt is not None else None,
               v_scale=v_scale if fmt is not None else None,
               cordic_softmax=cordic_softmax, hr_stages=hr,
               lv_stages=softmax_lv_stages(skv, af), out_dtype=q.dtype)
    return out.reshape(b, 1, h, hd)
