"""Top-level model assembly — the dense and MoE decoders behind one
serving API.

  init_params(cfg, seed, device)  -> param dict (layer leaves stacked [L, ..])
  init_cache(cfg, batch, max_len, policy, ...) -> serving cache
  decode_step(cfg, params, cache, tokens, ...) -> logits, cache'

Layer stacks keep the reference's leading [L, ...] axis (so converted
weights line up leaf for leaf); `decode_step` walks it with a Python loop.
Serving accepts quantize-once params (`core.qtensor.quantize_params`).
The MoE family replaces each block's MLP by `moe.moe_ffn`. The SSM and
hybrid families and the training forward are later slices (ROADMAP.md
queue 1, items 7 and 10).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.backend import resolve_device
from ..core.precision import PrecisionPolicy, qmatmul
from ..core.qtensor import QuantizedTensor
from .layers import attention, init_kv_cache, mlp, rmsnorm, step_plan
from .moe import moe_ffn, moe_init

__all__ = ["init_params", "init_cache", "decode_step", "layer_params",
           "slice_cache_rows", "update_cache_rows", "copy_pool_blocks"]


def _require_ported(cfg):
    if cfg.family not in ("dense", "moe") or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md queue 1, "
            "item 7)")
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")


def _normal(gen, shape, std, dtype, device):
    """N(0, std^2) in `dtype`, drawn one leading slice at a time so a
    stacked full-width leaf never needs an f32 copy of itself."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = (torch.randn(shape[1:], generator=gen, device=device)
                  * std).to(dtype)
    return out


def init_params(cfg, seed: int = 0, device=None, dtype=torch.bfloat16):
    """Random decoder weights from `seed` (the reference's init
    distributions: N(0, 1/d_in) projections, N(0, 0.02^2) embedding and
    lm_head, unit norms, zero biases; `moe.moe_init`'s for the MoE
    blocks). Runs on CUDA unless `device` says otherwise."""
    _require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def dense(d_in, d_out, std=None):
        return _normal(gen, (L, d_in, d_out),
                       std if std is not None else 1.0 / math.sqrt(d_in),
                       dtype, dev)

    attn = {"wq": dense(d, h * hd), "wk": dense(d, kvh * hd),
            "wv": dense(d, kvh * hd), "wo": dense(h * hd, d)}
    if cfg.qkv_bias:
        attn.update({k: torch.zeros((L, n), dtype=dtype, device=dev)
                     for k, n in (("bq", h * hd), ("bk", kvh * hd),
                                  ("bv", kvh * hd))})

    def ones():
        return {"w": torch.ones((L, d), dtype=dtype, device=dev)}

    blocks = {"attn_norm": ones(), "attn": attn, "mlp_norm": ones()}
    if cfg.family == "moe":
        blocks["moe"] = moe_init(
            lambda shape, std, dt: _normal(gen, shape, std, dt, dev), L, cfg,
            dtype)
    else:
        blocks["mlp"] = {"w1": dense(d, ff), "w2": dense(ff, d)}
        if cfg.act in ("silu", "swiglu"):
            blocks["mlp"]["w3"] = dense(d, ff)
    params = {
        "embed": _normal(gen, (cfg.padded_vocab, d), 0.02, dtype, dev),
        "blocks": blocks,
        "final_norm": {"w": torch.ones((d,), dtype=dtype, device=dev)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (1, d, cfg.padded_vocab), 0.02,
                                    dtype, dev)[0]
    return params


def layer_params(blocks, i: int):
    """Layer i of a stacked block tree (tensors and QuantizedTensors)."""
    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    if isinstance(blocks, QuantizedTensor):
        return blocks.layer(i)
    return blocks[i]


def init_cache(cfg, batch, max_len, policy=None, dtype=torch.bfloat16,
               kv_block_size=None, kv_blocks=None, device=None):
    """Serving cache: per-row `lengths` [batch] int32 and the KV cache —
    contiguous [L, batch, max_len, KV, hd], or with `kv_block_size` a
    global block pool [L, kv_blocks, block_size, KV, hd] addressed through
    `block_tables` [batch, MB] whose unallocated entries hold the sentinel
    kv_blocks (read as zeros, never written)."""
    _require_ported(cfg)
    if kv_blocks is not None and kv_block_size is None:
        raise ValueError("kv_blocks requires kv_block_size (a pool size "
                         "only makes sense for the paged layout)")
    dev = resolve_device(device)
    cache = {"kv": init_kv_cache(cfg, batch, max_len, policy, dtype=dtype,
                                 block_size=kv_block_size,
                                 num_blocks=kv_blocks, device=dev)}
    if kv_block_size is not None:
        mb = -(-max_len // kv_block_size)
        nb = int(cache["kv"]["k"].shape[1])
        cache["block_tables"] = torch.full((batch, mb), nb,
                                           dtype=torch.int32, device=dev)
    cache["lengths"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return cache


def _cache_batch_axis(key: str) -> int:
    # KV leaves are layer-stacked [L, B, ...]; lengths and tables are [B, ..]
    return 0 if key in ("lengths", "block_tables") else 1


def slice_cache_rows(cache, start: int, size: int = 1):
    """Rows [start, start+size) of every leaf's batch axis, as views (so
    in-place KV writes land in `cache`). A paged pool has no batch axis
    and passes through whole."""
    paged = "block_tables" in cache
    out = {}
    for k, v in cache.items():
        if k == "kv":
            out[k] = v if paged else {
                n: a.narrow(1, start, size) for n, a in v.items()}
        else:
            out[k] = v.narrow(_cache_batch_axis(k), start, size)
    return out


def update_cache_rows(cache, sub, start: int):
    """Write a `slice_cache_rows` window's new leaves back at row `start`
    (KV leaves were written in place; lengths and tables are copied)."""
    for k, v in sub.items():
        if k != "kv":
            cache[k].narrow(_cache_batch_axis(k), start, v.shape[0]).copy_(v)
    return cache


def copy_pool_blocks(cache, src, dst):
    """Copy-on-write fork of physical KV pool blocks, in place:
    pool[:, dst[i]] <- pool[:, src[i]] for every paged KV leaf (codes and
    per-position scales), all layers at once."""
    kv = cache["kv"]
    nb = kv["k"].shape[1]
    dev = kv["k"].device
    src = torch.as_tensor(src, dtype=torch.long, device=dev)
    dst = torch.as_tensor(dst, dtype=torch.long, device=dev)
    for leaf in kv.values():
        if leaf.dim() == 5 and leaf.shape[1] == nb:
            leaf[:, dst] = leaf[:, src]
    return cache


def decode_step(cfg, params, cache, tokens,
                policy: Optional[PrecisionPolicy] = None, n_valid=None,
                last_only: bool = False):
    """Serving step: tokens [B, S] -> (logits, cache').

    S = 1 is decode; S > 1 a chunked-prefill block, causal within the
    block. Row b continues from `cache["lengths"][b]` and `n_valid[b]` of
    its S tokens are real (n_valid = 0 leaves the row untouched). KV is
    written in place; the returned cache carries the new lengths.
    `last_only` keeps each row's last valid position before the lm_head."""
    _require_ported(cfg)
    x = params["embed"][tokens]
    b, s = x.shape[0], x.shape[1]
    dev = x.device
    lengths = cache["lengths"]
    if n_valid is None:
        n_valid = torch.full((b,), s, dtype=torch.int32, device=dev)
    n_valid = n_valid.to(torch.int32)
    positions = lengths[:, None] + torch.arange(s, dtype=torch.int32,
                                                device=dev)[None, :]
    block_tables = cache.get("block_tables")
    kv = cache["kv"]
    plan = step_plan(cfg, positions, lengths, n_valid, block_tables,
                     kv["k"].shape[1:3])
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h, _ = attention(
            bp["attn"], rmsnorm(x, bp["attn_norm"]["w"]), cfg,
            positions=positions, policy=policy,
            cache=(kv["k"][i], kv["v"][i], kv["k_scale"][i],
                   kv["v_scale"][i]),
            lengths=lengths, n_valid=n_valid, block_tables=block_tables,
            plan=plan)
        x = x + h
        xin = rmsnorm(x, bp["mlp_norm"]["w"])
        if cfg.family == "moe":
            x = x + moe_ffn(bp["moe"], xin, cfg, policy, dropless=True)
        else:
            x = x + mlp(bp["mlp"], xin, cfg.act, policy)
    x = rmsnorm(x, params["final_norm"]["w"])
    if last_only:
        idx = torch.clamp(n_valid - 1, 0, s - 1).long()
        x = x[torch.arange(b, device=dev), idx][:, None]       # [B, 1, D]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = qmatmul(x, head, policy)
    new_cache = dict(cache)
    new_cache["lengths"] = lengths + n_valid
    return logits, new_cache
