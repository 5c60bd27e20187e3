"""Top-level model assembly — the dense, MoE, SSM (Mamba2) and hybrid
(Zamba2) decoders behind one serving API.

  init_params(cfg, seed, device)  -> param dict (layer leaves stacked [L, ..])
  init_cache(cfg, batch, max_len, policy, ...) -> serving cache
  decode_step(cfg, params, cache, tokens, ...) -> logits, cache'

Layer stacks keep the reference's leading [L, ...] axis (so converted
weights line up leaf for leaf); `decode_step` walks it with a Python loop.
Serving accepts quantize-once params (`core.qtensor.quantize_params`).
The MoE family replaces each block's MLP by `moe.moe_ffn`. The SSM
family stacks Mamba2 layers (`ssm.mamba2_layer`); the hybrid family runs
them in groups of `attn_every`, each group followed by one shared
attention + MLP block on [x, x0] (x0 the embedding), with a KV cache per
application. The training forward is a later slice (ROADMAP.md queue 1,
item 10).
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
from .ssm import init_ssm_state, mamba2_layer, ssm_init

__all__ = ["init_params", "init_cache", "decode_step", "layer_params",
           "slice_cache_rows", "update_cache_rows", "copy_pool_blocks"]


#: families whose blocks are Mamba2 layers and whose cache carries an
#: "ssm" (state, conv window) pair stacked [L, B, ...]
SSM_FAMILIES = ("ssm", "hybrid")


def _require_ported(cfg):
    if (cfg.family not in ("dense", "moe") + SSM_FAMILIES
            or cfg.input_mode != "tokens"):
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
    blocks, `ssm.ssm_init`'s for the Mamba2 blocks). The hybrid family
    adds one unstacked `shared_attn` block: `in_proj` 2d -> d, attention
    and the MLP. Runs on CUDA unless `device` says otherwise."""
    _require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, d = cfg.n_layers, cfg.d_model

    def normal(shape, std, dt):
        return _normal(gen, shape, std, dt, dev)

    def ones(*lead):
        return {"w": torch.ones(lead + (d,), dtype=dtype, device=dev)}

    if cfg.family in SSM_FAMILIES:
        blocks = {"ssm_norm": ones(L),
                  "ssm": ssm_init(normal, L, cfg, dtype, device=dev)}
    else:
        blocks = {"attn_norm": ones(L), "attn": _attn_init(normal, (L,), cfg,
                                                           dtype, dev),
                  "mlp_norm": ones(L)}
        if cfg.family == "moe":
            blocks["moe"] = moe_init(normal, L, cfg, dtype)
        else:
            blocks["mlp"] = _mlp_init(normal, (L,), cfg, dtype)
    params = {
        "embed": _normal(gen, (cfg.padded_vocab, d), 0.02, dtype, dev),
        "blocks": blocks,
        "final_norm": ones(),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (1, d, cfg.padded_vocab), 0.02,
                                    dtype, dev)[0]
    if cfg.family == "hybrid":
        params["shared_attn"] = {
            "in_proj": _dense(normal, (), 2 * d, d, dtype),
            "attn_norm": ones(),
            "attn": _attn_init(normal, (), cfg, dtype, dev),
            "mlp_norm": ones(),
            "mlp": _mlp_init(normal, (), cfg, dtype),
        }
    return params


def _attn_init(normal, lead, cfg, dtype, dev):
    """Attention weights [*lead, d_in, d_out] N(0, 1/d_in), zero biases."""
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def dense(d_in, d_out):
        return _dense(normal, lead, d_in, d_out, dtype)
    attn = {"wq": dense(d, h * hd), "wk": dense(d, kvh * hd),
            "wv": dense(d, kvh * hd), "wo": dense(h * hd, d)}
    if cfg.qkv_bias:
        attn.update({k: torch.zeros(lead + (n,), dtype=dtype, device=dev)
                     for k, n in (("bq", h * hd), ("bk", kvh * hd),
                                  ("bv", kvh * hd))})
    return attn


def _mlp_init(normal, lead, cfg, dtype):
    d, ff = cfg.d_model, cfg.d_ff
    p = {"w1": _dense(normal, lead, d, ff, dtype),
         "w2": _dense(normal, lead, ff, d, dtype)}
    if cfg.act in ("silu", "swiglu"):
        p["w3"] = _dense(normal, lead, d, ff, dtype)
    return p


def _dense(normal, lead, d_in, d_out, dtype):
    """N(0, 1/d_in) [*lead, d_in, d_out] (an unstacked leaf is drawn as
    one layer of a stack)."""
    w = normal((lead[0] if lead else 1, d_in, d_out), 1.0 / math.sqrt(d_in),
               dtype)
    return w if lead else w[0]


def layer_params(blocks, i: int):
    """Layer i of a stacked block tree (tensors and QuantizedTensors)."""
    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    if isinstance(blocks, QuantizedTensor):
        return blocks.layer(i)
    return blocks[i]


def init_cache(cfg, batch, max_len, policy=None, dtype=torch.bfloat16,
               kv_block_size=None, kv_blocks=None, device=None):
    """Serving cache: per-row `lengths` [batch] int32 and, per family:

    - attention families: the KV cache, contiguous [L, batch, max_len,
      KV, hd], or with `kv_block_size` a global block pool [L, kv_blocks,
      block_size, KV, hd] addressed through `block_tables` [batch, MB]
      whose unallocated entries hold the sentinel kv_blocks (read as
      zeros, never written);
    - `ssm`: "ssm" = (state [L, batch, H, P, N] f32, conv window [L,
      batch, cw-1, conv_ch] in `dtype`), never paged (a recurrent carry
      has no sequence axis to page). The reference starts its window in
      bf16 whatever the model's dtype, and a step returns it in the
      activations' dtype; written in place, the port's keeps the cache
      dtype, which is the activations' (bf16 when serving);
    - `hybrid`: the "ssm" pair and a KV cache (paged or contiguous) of
      one layer per shared-attention application, n_layers // attn_every.
    """
    _require_ported(cfg)
    if kv_blocks is not None and kv_block_size is None:
        raise ValueError("kv_blocks requires kv_block_size (a pool size "
                         "only makes sense for the paged layout)")
    dev = resolve_device(device)
    cache = {}
    if cfg.family in SSM_FAMILIES:
        st, cv = init_ssm_state(cfg, batch, device=dev)
        cache["ssm"] = tuple(
            torch.zeros((cfg.n_layers,) + tuple(a.shape), dtype=dt,
                        device=dev) for a, dt in ((st, st.dtype), (cv, dtype)))
    if cfg.family == "ssm":
        kv_block_size = None
    else:
        n_kv = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
                else None)
        cache["kv"] = init_kv_cache(cfg, batch, max_len, policy,
                                    n_layers=n_kv, dtype=dtype,
                                    block_size=kv_block_size,
                                    num_blocks=kv_blocks, device=dev)
    if kv_block_size is not None:
        mb = -(-max_len // kv_block_size)
        nb = int(cache["kv"]["k"].shape[1])
        cache["block_tables"] = torch.full((batch, mb), nb,
                                           dtype=torch.int32, device=dev)
    cache["lengths"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return cache


def _cache_batch_axis(key: str) -> int:
    # KV and SSM leaves are layer-stacked [L, B, ...]; lengths and tables
    # are [B, ..]
    return 0 if key in ("lengths", "block_tables") else 1


def slice_cache_rows(cache, start: int, size: int = 1):
    """Rows [start, start+size) of every leaf's batch axis, as views (so
    in-place KV and SSM writes land in `cache`). A paged pool has no
    batch axis and passes through whole."""
    paged = "block_tables" in cache
    out = {}
    for k, v in cache.items():
        if k == "kv":
            out[k] = v if paged else {
                n: a.narrow(1, start, size) for n, a in v.items()}
        elif k == "ssm":
            out[k] = tuple(a.narrow(1, start, size) for a in v)
        else:
            out[k] = v.narrow(_cache_batch_axis(k), start, size)
    return out


def update_cache_rows(cache, sub, start: int):
    """Write a `slice_cache_rows` window's new leaves back at row `start`
    (KV and SSM leaves were written in place through the views; lengths
    and tables are copied)."""
    for k, v in sub.items():
        if k not in ("kv", "ssm"):
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
                last_only: bool = False, ssm_stepwise: bool = False):
    """Serving step: tokens [B, S] -> (logits, cache').

    S = 1 is decode; S > 1 a chunked-prefill block, causal within the
    block. Row b continues from `cache["lengths"][b]` and `n_valid[b]` of
    its S tokens are real (n_valid = 0 leaves the row untouched). KV and
    SSM state are written in place; the returned cache carries the new
    lengths. `last_only` keeps each row's last valid position before the
    lm_head. `ssm_stepwise` runs the SSM layers of an S > 1 block as S
    one-token steps (`ssm.mamba2_layer`'s `stepwise`): the speculative
    verify step, whose every position must score as a one-token decode
    would."""
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
    kv = cache.get("kv")
    plan = (step_plan(cfg, positions, lengths, n_valid, block_tables,
                      kv["k"].shape[1:3]) if kv is not None else None)

    def attend(p, xin, li):
        h, _ = attention(
            p["attn"], rmsnorm(xin, p["attn_norm"]["w"]), cfg,
            positions=positions, policy=policy,
            cache=(kv["k"][li], kv["v"][li], kv["k_scale"][li],
                   kv["v_scale"][li]),
            lengths=lengths, n_valid=n_valid, block_tables=block_tables,
            plan=plan)
        return h

    if cfg.family in SSM_FAMILIES:
        st, cv = cache["ssm"]
        x0 = x
        for i in range(cfg.n_layers):
            bp = layer_params(params["blocks"], i)
            h, (st2, cv2) = mamba2_layer(
                bp["ssm"], rmsnorm(x, bp["ssm_norm"]["w"]), cfg, policy,
                state=st[i], conv_state=cv[i], n_valid=n_valid,
                stepwise=ssm_stepwise)
            st[i].copy_(st2)
            cv[i].copy_(cv2)
            x = x + h
            if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                # the shared block after each full group of attn_every
                # layers (trailing layers get none), on [x, x0]
                sp = params["shared_attn"]
                xin = qmatmul(torch.cat([x, x0], dim=-1), sp["in_proj"],
                              policy)
                x = x + attend(sp, xin, (i + 1) // cfg.attn_every - 1)
                x = x + mlp(sp["mlp"], rmsnorm(x, sp["mlp_norm"]["w"]),
                            cfg.act, policy)
    else:
        for i in range(cfg.n_layers):
            bp = layer_params(params["blocks"], i)
            x = x + attend(bp, x, i)
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
