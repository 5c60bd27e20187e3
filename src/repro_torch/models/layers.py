"""Shared model layers — policy-aware (Flex-PE precision + CORDIC AFs).

Parameters are nested dicts of tensors; layer stacks carry a leading
[L, ...] axis and `model.decode_step` slices one layer at a time.

KV caches support FxP8 quantized storage (policy.kv_cache): int8 codes +
per-(position, head) scales. The paged layout is a global block pool
[NB, bs, KV, hd] addressed through per-row block tables; table entries
equal to NB are the unallocated sentinel.

Unlike the functional reference, cache writes here update the pool (or
the contiguous buffer) in place: a full-width pool is gigabytes, and a
copy per layer per step would double its traffic. Callers that need the
old cache keep their own copy.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from ..core.activation import default_stages, softmax_lv_stages
from ..core.fxp import FORMATS, dequantize, quantize
from ..core.precision import PrecisionPolicy, qmatmul, quantize_activation
from ..kernels.paged_attention.paged_attention import (gather_pool_view,
                                                      int_attention,
                                                      masked_attention,
                                                      softmax_fns)


def _dispatch():
    from ..kernels import dispatch
    return dispatch


# ---------------------------------------------------------------------------
# norms and rotary embedding
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps=1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_freqs(head_dim, theta=10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions, head_dim, theta=10000.0):
    """cos, sin [B, S, 1, hd/2] of the rotary angles at `positions`."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions[..., None].float() * freqs                 # [B,S,hd/2]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x, positions, theta=10000.0, tables=None):
    """x: [B, S, H, hd]; positions: [B, S] int32. `tables` reuses the
    (cos, sin) of `rope_tables` for these positions."""
    cos, sin = tables if tables is not None else rope_tables(
        positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# masked attention over a contiguous view (chunked prefill path)
# ---------------------------------------------------------------------------

def _softmax_fns(policy: Optional[PrecisionPolicy], kv_len: int):
    """(exp, divide) of the attention softmax: exact, or the Flex-PE
    HR-CORDIC exp and LV divide (stages from the policy's AF format)."""
    cordic_sm = policy is not None and policy.attn_softmax == "cordic"
    af = policy.af if policy is not None else None
    return softmax_fns(cordic_sm, default_stages(af)[0],
                       softmax_lv_stages(kv_len, af))


def chunked_attention(q, k, v, *, causal: bool, q_offset=0,
                      policy: Optional[PrecisionPolicy] = None,
                      chunk: int = 512, kv_valid_len=None):
    """q: [B, Sq, H, hd]; k, v: [B, Skv, KV, hd] -> [B, Sq, H, hd].

    Query blocks of `chunk` rows, each with a full-row softmax over Skv.
    `q_offset` (scalar or [B]) is each row's absolute position of q[0];
    keys at positions >= `kv_valid_len` (scalar or [B]) are masked."""
    if not causal:
        raise NotImplementedError("non-causal attention is not ported yet")
    b, sq = q.shape[0], q.shape[1]
    skv = k.shape[1]
    dev = q.device
    qoff = torch.broadcast_to(torch.as_tensor(q_offset, dtype=torch.int32,
                                              device=dev), (b,))
    kvv = torch.broadcast_to(torch.as_tensor(
        skv if kv_valid_len is None else kv_valid_len, dtype=torch.int32,
        device=dev), (b,))
    fns = _softmax_fns(policy, skv)
    nq = max(1, sq // chunk)
    while sq % nq:
        nq -= 1
    qc = sq // nq
    outs = [masked_attention(q[:, i * qc:(i + 1) * qc], k, v,
                             qoff + i * qc, kvv, *fns).to(q.dtype)
            for i in range(nq)]
    return torch.cat(outs, dim=1)


def int8_decode_attention(q, k_codes, v_codes, k_scale, v_scale, fmt,
                          policy, positions, kv_valid_len):
    """Attention on integer KV codes (the Flex-PE FxP MAC applied to
    attention): q / sqrt(hd) quantized per head over hd, int8 q.k code
    dots dequantized by the folded (q, per-position k) scales, the mask,
    the policy's softmax, p x v_scale requantized per row, and the int8 AV
    dot times its scale.

    q: [B, Sq, H, hd] float; k/v codes [B, S, KV, hd] int8 with scales
    [B, S, KV, 1]; `positions` [B, Sq] are the queries' absolute cache
    positions and `kv_valid_len` [B] each row's valid cache length. Returns
    [B, Sq, H, hd] in q.dtype."""
    hd = q.shape[-1]
    qc, sq = quantize(q.float() / math.sqrt(hd), fmt, axis=3)
    softmax_fn = ((lambda s: policy.softmax(s, axis=-1)) if policy
                  else None)
    kvv = torch.broadcast_to(torch.as_tensor(
        kv_valid_len, dtype=torch.int32, device=q.device), (q.shape[0],))
    return int_attention(qc, sq, k_codes, v_codes, k_scale, v_scale,
                         positions, kvv, fmt, softmax_fn).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache writes and views
# ---------------------------------------------------------------------------

def _write_plan(block_tables, start, count, s, shape):
    """Where a [B, S] block of new tokens lands in a cache buffer viewed
    flat over its first two axes: -> (targets [B*S], valid [B*S], index
    of the first valid entry [1], any valid []), for `_apply_write`.

    Paged (`block_tables` given): `shape` is the pool's (NB, bs); logical
    position p of row b lands at table[b, p // bs] * bs + p % bs, tokens
    past count[b] or on a sentinel table entry are dropped. Contiguous:
    `shape` is the buffer's (B, Smax); row b, position p lands at
    b * Smax + p."""
    dev = start.device
    b = start.shape[0]
    pos = start[:, None] + torch.arange(s, dtype=torch.int32,
                                        device=dev)[None, :]       # [B, S]
    valid = torch.arange(s, device=dev)[None, :] < count[:, None]
    if block_tables is not None:
        nb, bs = shape
        tslot = torch.clamp(pos // bs, 0, block_tables.shape[1] - 1)
        blk = torch.gather(block_tables, 1, tslot.long())
        valid = valid & (blk < nb)
        idx = torch.clamp(blk, max=nb - 1).long() * bs + pos % bs
    else:
        smax = shape[1]
        rows = torch.arange(b, device=dev)[:, None]
        idx = rows * smax + torch.clamp(pos, max=smax - 1).long()
    valid = valid.reshape(-1)
    # entries that must not write repeat the first valid entry instead
    first = torch.argmax(valid.to(torch.int32)).reshape(1)
    idx = idx.reshape(-1)
    return (torch.where(valid, idx, idx.index_select(0, first)), valid,
            first, valid.any())


def _apply_write(buf, plan, new):
    """buf[plan] <- new in place, on the device and without a host sync
    (a boolean-mask select would wait for the device): invalid entries
    rewrite the first valid entry's value at its slot, or, when nothing
    is valid, the current content of one slot. Valid slots must be
    distinct."""
    tgt, valid, first, any_valid = plan
    flat = buf.view((buf.shape[0] * buf.shape[1],) + tuple(buf.shape[2:]))
    vals = new.reshape((tgt.shape[0],) + tuple(new.shape[2:])).to(buf.dtype)
    vshape = (-1,) + (1,) * (vals.dim() - 1)
    src = torch.where(valid.reshape(vshape), vals,
                      vals.index_select(0, first))
    src = torch.where(any_valid, src, flat[tgt])
    flat[tgt] = src
    return buf


def paged_cache_update(pool, new, block_tables, start, count):
    """In-place paged write: logical positions [start[b], start[b] +
    count[b]) of row b land at pool[table[b, p // bs], p % bs]; tokens past
    count[b] are dropped (idle rows are exact no-ops). Returns `pool`.

    pool: [NB, bs, ...] (contiguous); new: [B, S, ...]; block_tables:
    [B, MB]."""
    plan = _write_plan(block_tables, start, count, new.shape[1],
                       pool.shape[:2])
    return _apply_write(pool, plan, new)


def gather_block_kv(pool, block_tables):
    """[NB, bs, ...] pool + [B, MB] tables -> contiguous [B, MB*bs, ...]
    per-row view; sentinel entries (>= NB) read exact zeros."""
    return gather_pool_view(pool, block_tables)


def ragged_cache_update(buf, new, start, count):
    """In-place per-row write buf[b, start[b]:start[b]+count[b]] <-
    new[b, :count[b]]; rows with count 0 are untouched. Returns `buf`.
    Rows with count > 0 need start + S <= Smax (the engine over-allocates
    by one chunk).

    buf: [B, Smax, ...] (a contiguous row range); new: [B, S, ...]."""
    plan = _write_plan(None, start, count, new.shape[1], buf.shape[:2])
    return _apply_write(buf, plan, new)


def init_kv_cache(cfg, batch, max_len, policy=None, n_layers=None,
                  dtype=torch.bfloat16, block_size=None, num_blocks=None,
                  device=None):
    """Pre-allocated per-layer KV cache, stacked on a leading layer axis
    of `n_layers` (default: the model's layers; the hybrid family keeps
    one per shared-attention application).

    Contiguous (default): one [batch, max_len] window per row. Paged
    (`block_size` set): a global block pool [num_blocks, block_size];
    `num_blocks` defaults to byte parity with the contiguous layout."""
    n_layers = n_layers if n_layers is not None else cfg.n_layers
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    quant = policy is not None and policy.kv_cache is not None
    dt = torch.int8 if quant else dtype
    if block_size is not None:
        nb = (num_blocks if num_blocks is not None
              else batch * -(-max_len // block_size))
        lead = (n_layers, nb, block_size, kvh)
        sshape = lead + (1,) if quant else (n_layers, 1, 1, kvh, 1)
    else:
        lead = (n_layers, batch, max_len, kvh)
        sshape = ((n_layers, batch, max_len if quant else 1, kvh, 1))
    return {"k": torch.zeros(lead + (hd,), dtype=dt, device=device),
            "v": torch.zeros(lead + (hd,), dtype=dt, device=device),
            "k_scale": torch.full(sshape, 1e-6, dtype=torch.float32,
                                  device=device),
            "v_scale": torch.full(sshape, 1e-6, dtype=torch.float32,
                                  device=device)}


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

class StepPlan(NamedTuple):
    """What every layer of one step shares: RoPE's (cos, sin) at the
    step's positions and where the step's new K/V land in the cache."""
    rope: Optional[tuple]
    write: tuple


def step_plan(cfg, positions, lengths, n_valid, block_tables, cache_shape):
    """The `StepPlan` of a [B, S] block; `cache_shape` is the first two
    axes of one layer's K buffer ((NB, bs) paged, (B, Smax) contiguous)."""
    rope = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.rope else None)
    return StepPlan(rope, _write_plan(block_tables, lengths, n_valid,
                                      positions.shape[1], cache_shape))


def attention(p, x, cfg, *, positions, policy=None, cache=None,
              lengths=None, n_valid=None, block_tables=None, plan=None):
    """Returns (out, cache_entry).

    cache = (k, v, k_scale, v_scale) for ONE layer: contiguous
    [B, Smax, KV, hd] buffers, or with `block_tables` [B, MB] the paged
    pool [NB, bs, KV, hd]. `lengths` [B] is each row's cache length (the
    write offset of its new tokens) and `n_valid` [B] how many of this
    block's S tokens are real. New K/V are written in place; single-token
    paged decode then runs the paged attention op straight off the pool,
    and every other case attends over the (gathered) contiguous view.
    `plan` is the step's `StepPlan` when a caller runs many layers over
    the same block (computed here otherwise)."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xa = quantize_activation(x, p["wq"], policy)     # one grid for q, k, v
    q = qmatmul(xa, p["wq"], policy)
    k = qmatmul(xa, p["wk"], policy)
    v = qmatmul(xa, p["wv"], policy)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    if cache is None:
        raise NotImplementedError("cache-less attention (training forward) "
                                  "is ROADMAP.md queue 1, item 10")
    kc, vc, k_scale, v_scale = cache
    if n_valid is None:
        n_valid = torch.full((b,), s, dtype=torch.int32, device=x.device)
    if plan is None:
        plan = step_plan(cfg, positions, lengths, n_valid, block_tables,
                         kc.shape[:2])
    if cfg.rope:
        q = apply_rope(q, positions, tables=plan.rope)
        k = apply_rope(k, positions, tables=plan.rope)
    kv_valid = lengths + n_valid
    kq_fmt = (FORMATS[policy.kv_cache]
              if (policy and policy.kv_cache) else None)
    paged = block_tables is not None

    def view(buf):
        return gather_block_kv(buf, block_tables) if paged else buf
    if kq_fmt is not None:
        # per-(position, head) scales: old codes keep their own scale
        k_codes, ks_new = quantize(k, kq_fmt, axis=3)
        v_codes, vs_new = quantize(v, kq_fmt, axis=3)
        for buf, new in ((kc, k_codes), (vc, v_codes), (k_scale, ks_new),
                         (v_scale, vs_new)):
            _apply_write(buf, plan.write, new)
    else:
        _apply_write(kc, plan.write, k)
        _apply_write(vc, plan.write, v)
    int_attn = bool(kq_fmt is not None and policy.int_attention)
    if paged and s == 1:
        be = policy.resolved_backend() if policy else "reference"
        out = _dispatch().paged_attention(
            q, kc, vc, k_scale, v_scale, block_tables, policy, be,
            lengths=lengths, kv_valid=kv_valid, positions=positions,
            fmt=kq_fmt, int_attention=int_attn)
    elif int_attn:
        # integer attention over the (gathered) codes: chunked prefill, and
        # every step of a contiguous cache
        out = int8_decode_attention(
            q, view(kc), view(vc), view(k_scale), view(v_scale), kq_fmt,
            policy, positions=positions, kv_valid_len=kv_valid)
    else:
        if kq_fmt is not None:
            k_full = dequantize(view(kc), view(k_scale), torch.bfloat16)
            v_full = dequantize(view(vc), view(v_scale), torch.bfloat16)
        else:
            k_full, v_full = view(kc), view(vc)
        out = chunked_attention(q, k_full, v_full, causal=True,
                                q_offset=lengths, policy=policy,
                                kv_valid_len=kv_valid)
    out = out.reshape(b, s, h * hd)
    return qmatmul(out, p["wo"], policy), (kc, vc, k_scale, v_scale)


# ---------------------------------------------------------------------------
# MLP (dense FFN, GLU family)
# ---------------------------------------------------------------------------

def mlp(p, x, act, policy=None):
    """FFN with the Flex-PE MAC -> AF pipeline: under a policy the
    activation is the GEMM's fused epilogue."""
    if "w3" in p:  # SwiGLU
        xa = quantize_activation(x, p["w1"], policy)  # one grid for both
        if policy:
            gate = qmatmul(xa, p["w1"], policy, af="silu")
        else:
            gate = torch.nn.functional.silu(qmatmul(xa, p["w1"], policy))
        h = gate * qmatmul(xa, p["w3"], policy)
    else:
        if policy:
            h = qmatmul(x, p["w1"], policy,
                        af=act if act in ("gelu", "relu", "tanh",
                                          "sigmoid") else "gelu")
        else:
            # jax.nn.gelu's default is the tanh approximation
            h = {"gelu": functools.partial(torch.nn.functional.gelu,
                                           approximate="tanh"),
                 "relu": torch.relu, "tanh": torch.tanh,
                 "sigmoid": torch.sigmoid}[act](qmatmul(x, p["w1"], policy))
    return qmatmul(h, p["w2"], policy)
