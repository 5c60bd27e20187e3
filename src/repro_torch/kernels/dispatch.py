"""Backend dispatch — routes PrecisionPolicy ops to implementations.

A small registry maps (op, backend) -> implementation:

    op      : 'matmul' | 'expert_matmul' | 'act' | 'softmax' |
              'paged_attention'
    backend : 'reference' (plain PyTorch path)
              'kernels'   (the Hopper kernels; their plain versions when
                           handed CPU tensors)

This module owns the quantize plumbing of the kernel matmul: the
activation is quantized per tensor over the whole [rows, K] block (so a
row's result depends on what the other rows hold, idle rows included),
the activation scale folds into the weight's per-channel scale in f32,
the kernel runs the integer GEMM with the optional fused CORDIC AF, and
the AF result snaps to the policy's AF grid. The kernel masks ragged
edges, so there is no padding and no slice. `expert_matmul` runs a MoE
expert bank: the reference's loop of per-expert matmuls on the plain
backend, one batched launch of the same GEMM kernel on the kernels
backend (int8 or packed FxP4 banks), with the same per-expert activation
codes and scales.

Quantize-once weights of every width take the kernel op's contract on
both backends: activation codes, the exact integer sum rounded once to
f32 (held in 128 bits for FxP24/32 codes), the folded scale. Past 8 bits
the reference differs here: its plain backend dequantizes the weight and
runs an f32 dot of fake-quantized operands, its Pallas backend sums the
codes in f32 (ROADMAP.md queue 3).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from ..core.activation import default_stages, flex_af
from ..core.fxp import FORMATS, fake_quant, quantize
from ..core.precision import QuantizedActivation, quantize_activation
from ..core.qtensor import QuantizedTensor
from .cordic_af.cordic_af import KERNEL_AFS, cordic_af, cordic_af_reference
from .cordic_softmax.cordic_softmax import (cordic_softmax,
                                            cordic_softmax_reference)
from .fxp_gemm.fxp_gemm import (FUSED_AFS, fxp_gemm_fused,
                                fxp_gemm_fused_batched, fxp_gemm_fused_plain)
from .paged_attention.ops import paged_attention as _paged_attention
from .paged_attention.paged_attention import (paged_attention_float,
                                              paged_attention_float_plain,
                                              paged_attention_int,
                                              paged_attention_int_plain)

__all__ = ["register", "lookup", "matmul", "expert_matmul", "act",
           "softmax", "paged_attention", "FUSED_AFS"]

_REGISTRY: dict[tuple[str, str], Callable] = {}


def register(op: str, backend: str):
    """Decorator: register an implementation for (op, backend)."""
    def deco(fn):
        _REGISTRY[(op, backend)] = fn
        return fn
    return deco


def lookup(op: str, backend: str) -> Callable:
    try:
        return _REGISTRY[(op, backend)]
    except KeyError:
        raise NotImplementedError(
            f"no implementation registered for op={op!r} backend={backend!r}"
            f" (have {sorted(_REGISTRY)})") from None


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

def _af_on_accumulator(out, af, policy):
    """The fused MAC -> AF contract, shared by both backends: the AF reads
    the raw dequantized accumulator, and its result snaps to the policy's
    AF grid (the write-back register)."""
    if policy is None:
        return flex_af(out, af, impl="exact")
    stages = (default_stages(policy.af) if policy.af_impl == "cordic"
              else None)
    out = flex_af(out, af, precision=None, impl=policy.af_impl,
                  stages=stages)
    if policy.af is not None:
        out = fake_quant(out.float(), FORMATS[policy.af]).to(out.dtype)
    return out


@register("matmul", "reference")
def _matmul_reference(x, w, policy, af=None):
    """Plain path. Quantize-once weights: quantize the activation, exact
    integer product, dequant by the folded scale — bit-identical to the
    kernel path. Float weights: fake-quant operands and an f32 product.
    The optional `af` runs on the accumulator output before the cast back
    to x.dtype."""
    xa = (x if isinstance(x, QuantizedActivation)
          else quantize_activation(x, w, policy))
    if isinstance(xa, QuantizedActivation):
        scale = (xa.scale * w.scale).float().expand(1, w.n)
        out = fxp_gemm_fused_plain(xa.codes, w.codes(), scale)
        if af is not None:
            out = _af_on_accumulator(out, af, policy)
        return out.reshape(*xa.lead, w.n).to(xa.dtype)
    orig_dtype = x.dtype
    if policy is not None and policy.matmul is not None:
        x = fake_quant(x, FORMATS[policy.matmul])
        w = fake_quant(w, FORMATS[policy.matmul])
    out = torch.matmul(x.float(), w.float())
    if af is not None:
        out = _af_on_accumulator(out, af, policy)
    return out.to(orig_dtype)


@register("matmul", "kernels")
def _matmul_kernels(x, w, policy, af=None):
    """Integer-kernel path: the activation quantized per tensor by
    `quantize_activation`, as on the plain path, then the code GEMM with
    its fused dequant (+ CORDIC AF) epilogue. A float weight is first
    quantized per tensor to the policy's format."""
    if not isinstance(w, QuantizedTensor):
        if policy is None or policy.matmul is None:
            # native-precision policy: nothing to quantize
            return _matmul_reference(x, w, policy, af=af)
        wb, sw = quantize(w.float(), FORMATS[policy.matmul])
        w = QuantizedTensor(wb, sw.reshape(1, 1), policy.matmul,
                            w.shape[-1], False)
    xa = (x if isinstance(x, QuantizedActivation)
          else quantize_activation(x, w, policy))
    if w.ndim != 2:
        raise ValueError("kernel matmul wants a 2-D (per-layer) weight")
    scale = (xa.scale * w.scale).float().expand(1, w.n)
    # packed FxP4: the int32 words seen as nibble bytes [K, 4 * words];
    # byte j holds elements 2j (low nibble) and 2j+1 (high), the lane
    # order of core.simd.pack
    w_codes = w.data.view(torch.int8) if w.packed else w.data
    out = _fused_gemm(fxp_gemm_fused, xa.codes, w_codes, scale, af, policy,
                      packed=w.packed)
    return out.reshape(*xa.lead, w.n).to(xa.dtype)


def _fused_gemm(gemm, codes, w_codes, scale, af, policy, **kw):
    """`gemm` (the single or the batched kernel entry) with the AF fused
    into its epilogue on the CORDIC datapath; 'exact' AF policies apply
    the shared accumulator-AF contract as a post-op."""
    fuse_af = (af is not None and af in FUSED_AFS
               and (policy is None or policy.af_impl == "cordic"))
    hr, lv = default_stages(policy.af if policy is not None else None)
    out = gemm(codes, w_codes, scale, af=af if fuse_af else None,
               hr_stages=hr, lv_stages=lv, **kw)
    if fuse_af:
        if policy is not None and policy.af is not None:
            out = fake_quant(out, FORMATS[policy.af])
    elif af is not None:
        out = _af_on_accumulator(out, af, policy)
    return out


# ---------------------------------------------------------------------------
# MoE expert banks
# ---------------------------------------------------------------------------

def _experts(w):
    """[E, K, N] bank -> its E per-expert [K, N] weights."""
    if isinstance(w, QuantizedTensor):
        return [w.layer(i) for i in range(w.data.shape[0])]
    return list(w)


def _by_expert(x, e):
    """x [..., E, C, K] -> ([E, rows, K] queues, the inverse for an
    [E, rows, N] result)."""
    *lead, e_x, c, k = x.shape
    if e_x != e:
        raise ValueError(f"x {tuple(x.shape)} has {e_x} experts, the bank "
                         f"{e}")

    def back(out):
        return out.reshape(e, *lead, c, out.shape[-1]).movedim(0, -3)
    return x.movedim(-3, 0).reshape(e, -1, k), back


def _expert_loop(matmul_fn, x, w, policy, af):
    """The reference's expert_matmul: each expert's [G*C, K] queue through
    `matmul_fn` on its own (so its activation is quantized per tensor on
    its own)."""
    experts = _experts(w)
    xe, back = _by_expert(x, len(experts))
    return back(torch.stack([matmul_fn(xe[i], w_i, policy, af=af)
                             for i, w_i in enumerate(experts)]))


@register("expert_matmul", "reference")
def _expert_matmul_reference(x, w, policy, af=None):
    return _expert_loop(_matmul_reference, x, w, policy, af)


@register("expert_matmul", "kernels")
def _expert_matmul_kernels(x, w, policy, af=None):
    """One launch for the whole bank: every expert's activation codes and
    scale in one pass (a per-expert amax over [E, G*C, K], which is what
    each expert's own per-tensor amax gives: a max does not depend on
    order), the folded [E, 1, N] scales, then the batched GEMM kernel.
    Packed FxP4 banks launch the batched kernel's packed mode (the int32
    words seen as nibble bytes [E, K, 4 * words]). Float banks and >8-bit
    formats take the per-expert loop (the wide or x32 mode, one launch per
    expert), as the reference loops every bank."""
    fmt_x = (FORMATS[policy.matmul if policy is not None
                     and policy.matmul is not None else w.fmt_name]
             if isinstance(w, QuantizedTensor) else None)
    if fmt_x is None or w.fmt.bits > 8 or fmt_x.bits > 8 or w.ndim != 3:
        return _expert_loop(_matmul_kernels, x, w, policy, af)
    xe, back = _by_expert(x, w.data.shape[0])
    codes, xs = quantize(xe.float(), fmt_x, axis=(1, 2))
    scale = (xs * w.scale).float()                       # [E, 1, N]
    w_codes = w.data.view(torch.int8) if w.packed else w.data
    out = _fused_gemm(fxp_gemm_fused_batched, codes, w_codes, scale, af,
                      policy, packed=w.packed)
    return back(out.to(x.dtype))


# ---------------------------------------------------------------------------
# activation and softmax
# ---------------------------------------------------------------------------

# `PrecisionPolicy.act` and `.softmax` come here only on CORDIC policies,
# and `.softmax` only over the last axis.

@register("act", "reference")
def _act_reference(x, af, policy):
    """The CORDIC AF op with its plain version (`flex_af` for an AF the
    kernel does not compute: identity)."""
    if af in KERNEL_AFS:
        return cordic_af_reference(x, af, precision=policy.af)
    return flex_af(x, af, precision=policy.af, impl="cordic")


@register("act", "kernels")
def _act_kernels(x, af, policy):
    """The CORDIC AF kernel (its plain version on the CPU)."""
    if af in KERNEL_AFS:
        return cordic_af(x, af, precision=policy.af)
    return _act_reference(x, af, policy)


@register("softmax", "reference")
def _softmax_reference(x, policy):
    """The CORDIC softmax op with its plain version (the kernel's row-sum
    order)."""
    return cordic_softmax_reference(x, precision=policy.af)


@register("softmax", "kernels")
def _softmax_kernels(x, policy):
    """The CORDIC softmax kernel (its plain version on the CPU)."""
    return cordic_softmax(x, precision=policy.af)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

@register("paged_attention", "reference")
def _paged_attention_reference(q, k_pool, v_pool, k_scale, v_scale,
                               block_tables, policy, **kw):
    """Gathered-view plain versions, on any device; integer attention
    takes the policy's own softmax, as the reference's oracle does."""
    softmax_fn = ((lambda s: policy.softmax(s, axis=-1))
                  if policy is not None else None)
    return _paged_attention(
        q, k_pool, v_pool, k_scale, v_scale, block_tables, policy=policy,
        impl=paged_attention_float_plain,
        int_impl=functools.partial(paged_attention_int_plain,
                                   softmax_fn=softmax_fn), **kw)


@register("paged_attention", "kernels")
def _paged_attention_kernels(q, k_pool, v_pool, k_scale, v_scale,
                             block_tables, policy, **kw):
    """The block-table-walking kernels (their plain versions on the CPU).
    Integer attention with a CORDIC softmax takes the gathered plain
    composition, the route the reference's Pallas backend gives it
    (src/repro/kernels/dispatch.py, `_paged_attention_pallas`): its integer
    kernel computes the exact softmax only. On the card that composition's
    softmax is still the CORDIC softmax kernel. (Under a CORDIC policy the
    reference's integer attention is the mean of V over the valid
    positions: ROADMAP.md queue 3.)"""
    if (kw.get("int_attention") and kw.get("fmt") is not None
            and policy is not None and policy.attn_softmax == "cordic"):
        return _paged_attention_reference(q, k_pool, v_pool, k_scale,
                                          v_scale, block_tables, policy,
                                          **kw)
    return _paged_attention(q, k_pool, v_pool, k_scale, v_scale,
                            block_tables, policy=policy,
                            impl=paged_attention_float,
                            int_impl=paged_attention_int, **kw)


# ---------------------------------------------------------------------------
# public entry points (called from core.precision and models.layers)
# ---------------------------------------------------------------------------

def matmul(x, w, policy, backend: str, af: Optional[str] = None):
    return lookup("matmul", backend)(x, w, policy, af=af)


def expert_matmul(x, w, policy, backend: str, af: Optional[str] = None):
    """MoE expert-bank GEMM: x [..., E, C, K] @ w [E, K, N] ->
    [..., E, C, N] in x.dtype; `w` a float bank or a 3-D QuantizedTensor
    (one layer of the quantized [L, E, K, N] bank)."""
    return lookup("expert_matmul", backend)(x, w, policy, af=af)


def act(x, af: str, policy, backend: str):
    return lookup("act", backend)(x, af, policy)


def softmax(x, policy, backend: str):
    """CORDIC softmax over the last axis."""
    return lookup("softmax", backend)(x, policy)


def paged_attention(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                    policy, backend: str, *, lengths, kv_valid, positions,
                    fmt=None, int_attention: bool = False):
    """Fused paged decode attention straight off the block pool.

    q: [B, 1, H, hd]; pools: [NB, bs, KV, hd] (+ [NB, bs, KV, 1] scales
    when `fmt` is set); block_tables: [B, MB] int32 with sentinel NB for
    unallocated slots. Returns [B, 1, H, hd] in q.dtype."""
    return lookup("paged_attention", backend)(
        q, k_pool, v_pool, k_scale, v_scale, block_tables, policy,
        lengths=lengths, kv_valid=kv_valid, positions=positions, fmt=fmt,
        int_attention=int_attention)
