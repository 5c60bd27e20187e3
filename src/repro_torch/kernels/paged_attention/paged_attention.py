"""paged_attention_float and paged_attention_int: one-query GQA decode
attention straight off the paged KV pool `[NB, bs, KV, hd]` through
per-row block tables.

`paged_attention_float` is the wrapper: CUDA tensors launch the
hand-written Hopper kernel (`csrc/paged_attention.cu`) or raise; CPU
tensors run `paged_attention_float_plain`, the same computation in plain
PyTorch over the gathered per-row view. Both:
  * read sentinel table entries (id >= NB) as exact zeros;
  * dequantize int8 codes x per-position scale onto the bf16 grid (or
    read bf16 pool values);
  * mask positions above the query position or at/after the valid length
    to -1e30;
  * take the full-row max, exp (exact or CORDIC), sum, AV and divide
    (exact, or LV CORDIC on operands scaled into [-1, 1]).

`paged_attention_int` (fully integer attention on the int8 pool, q
quantized by the caller) has the same wrapper contract, its plain version
`paged_attention_int_plain` runs `int_attention` over the gathered view,
the function `models.layers.int8_decode_attention` runs too: int8 q.k
code dots, the scales folded in the reference's order, the mask, the
softmax, p x v_scale requantized per row, and the int8 AV dot.

On the card each call is one launch of a thread-block cluster of C CTAs
per (row, KV head), which split the row's valid window and merge their
partials in distributed shared memory; `cluster_size` picks C from the
shapes (and the CTAs the card holds at once), once per shape.

Replaces src/repro/kernels/paged_attention/paged_attention.py::
paged_attention_float_pallas (both its dequant and its float body) and
::paged_attention_int_pallas.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ...core import cordic
from ...core.fxp import FxPFormat, quantize
from ..build import cordic_params, library

__all__ = ["paged_attention_float", "paged_attention_float_plain",
           "paged_attention_int", "paged_attention_int_plain",
           "gather_pool_view", "masked_attention", "int_attention",
           "softmax_fns", "cluster_size", "cluster_plan"]

_SMEM_LIMIT = 227 * 1024        # dynamic shared memory a block may use
_MAX_G = 8                      # kMaxG in csrc/paged_attention.cu
_MAX_HD = 256                   # kMaxHd
CLUSTER_SIZES = (1, 2, 4, 8)    # portable thread-block cluster sizes
# the kernels' bodies (enum Body in csrc/paged_attention.cu)
_BODY_INT, _BODY_INT8_POOL, _BODY_BF16_POOL = 0, 1, 2

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "paged_attention_float": ([_P] * 9 + [_I] * 10 + [ctypes.c_float, _I,
                                                       _I, _P, _P],
                              ctypes.c_int),
    "paged_attention_int": ([_P] * 10 + [_I] * 10 + [_P], ctypes.c_int),
    "paged_attention_smem_bytes": ([_I] * 6, ctypes.c_longlong),
    "paged_attention_scratch_bytes": ([_I] * 4, ctypes.c_longlong),
    "paged_attention_max_clusters": ([_I] * 3, ctypes.c_int),
}


def cluster_size(b: int, kvh: int, mb: int, slots) -> int:
    """CTAs per (row, KV head) of the kernels' cluster launch, from shapes
    only (never from `meta`, which lives on the device): the largest C of
    2, 4 and 8 with 2 * C <= mb (every CTA can own two pool blocks of a
    full table of mb blocks: at fewer, the cluster's fixed costs outweigh
    the split) and b * kvh * C <= slots(C), the CTAs the card holds at
    once with C's shared memory a CTA (the wrapper asks the occupancy
    API), so that the grid starts as one wave; 1 when no C >= 2 meets
    both."""
    c = 1
    for cand in CLUSTER_SIZES[1:]:
        if 2 * cand <= mb and b * kvh * cand <= slots(cand):
            c = cand
    return c


def _body(elem_bytes: int, integer: bool) -> int:
    if integer:
        return _BODY_INT
    return _BODY_INT8_POOL if elem_bytes == 1 else _BODY_BF16_POOL


@functools.lru_cache(maxsize=256)
def _plan(body: int, b: int, kvh: int, g: int, hd: int, mb: int, bs: int,
          device: int):
    """(C, positions a CTA's slice holds, scratch bytes a CTA, 0 when its
    score region fits on chip) of one launch shape: shapes only, so it is
    worked out once per shape (the wrapper runs every decode step)."""
    lib = library("paged_attention", _SIGNATURES)

    def smem(c):
        cap_blocks = -(-mb // c)
        on_chip = lib.paged_attention_smem_bytes(body, g, hd, bs, cap_blocks,
                                                 1)
        if on_chip <= _SMEM_LIMIT:
            return on_chip
        return lib.paged_attention_smem_bytes(body, g, hd, bs, cap_blocks, 0)

    with torch.cuda.device(device):
        c = cluster_size(b, kvh, mb, lambda c: (
            lib.paged_attention_max_clusters(body, 1, smem(c))))
    cap_blocks = -(-mb // c)
    scratch = 0
    if lib.paged_attention_smem_bytes(body, g, hd, bs, cap_blocks,
                                      1) > _SMEM_LIMIT:
        scratch = lib.paged_attention_scratch_bytes(body, g, bs, cap_blocks)
    return c, cap_blocks * bs, scratch


def cluster_plan(b: int, kvh: int, g: int, hd: int, mb: int, bs: int, *,
                 elem_bytes: int = 1, integer: bool = False,
                 device: int = 0):
    """(C, scores in scratch) that the wrappers launch with for these
    shapes on card `device`: the cluster size, and True when a CTA's score
    region (the [g, ceil(mb / C) * bs] scores of its slice, and for the
    integer body its V scales and p.v codes) does not fit in shared memory
    beside the ring, so that the wrapper hands the kernel a global scratch
    region per CTA instead. `elem_bytes`: the float body's pool element (1
    for int8 codes, 2 for bf16); `integer` asks about the integer body.
    Builds the kernel library on first use."""
    c, _, scratch = _plan(_body(elem_bytes, integer), b, kvh, g, hd, mb, bs,
                          device)
    return c, scratch > 0


def _launch_plan(body, b, kvh, g, hd, mb, bs, dev):
    """(C, cap, scratch tensor or None) of a launch."""
    c, cap, scratch_bytes = _plan(body, b, kvh, g, hd, mb, bs, dev.index)
    scratch = None
    if scratch_bytes:
        scratch = torch.empty(b * kvh * c * scratch_bytes, dtype=torch.uint8,
                              device=dev)
    return c, cap, scratch


def gather_pool_view(pool: torch.Tensor, block_tables: torch.Tensor):
    """[NB, bs, ...] pool + [B, MB] tables -> [B, MB*bs, ...] view; table
    entries >= NB (the unallocated sentinel) read exact zeros."""
    nb = pool.shape[0]
    alloc = block_tables < nb
    g = pool[torch.where(alloc, block_tables, 0).long()]   # [B, MB, bs, ...]
    g = torch.where(alloc.reshape(alloc.shape + (1,) * (g.dim() - 2)), g,
                    torch.zeros((), dtype=g.dtype, device=g.device))
    b, mb, bs = g.shape[0], g.shape[1], g.shape[2]
    return g.reshape((b, mb * bs) + tuple(g.shape[3:]))


def masked_attention(q, k, v, q_offset, kv_valid, exp_fn, div_fn):
    """Full-row masked GQA attention in f32: q [B, Sq, H, hd] at absolute
    positions q_offset[b] + i; k, v [B, Skv, KV, hd]; keys above the query
    position or at/after kv_valid[b] are masked to -1e30. `exp_fn` and
    `div_fn(num, den)` are the softmax's exp and final divide. Both the
    paged plain version and `models.layers.chunked_attention` run this, so
    the two cache layouts round alike."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dev = q.device
    qh = q.reshape(b, sq, kvh, g, hd).float()
    s = torch.einsum("bqkgd,bskd->bqkgs", qh, k.float()) * (
        1.0 / math.sqrt(hd))
    s = s.reshape(b, sq, h, skv)
    kv_pos = torch.arange(skv, device=dev)
    qpos = q_offset[:, None] + torch.arange(sq, device=dev)[None, :]
    mask = kv_pos[None, None, :] <= qpos[:, :, None]            # [B,Sq,Skv]
    s = torch.where(mask[:, :, None, :], s, -1e30)
    vmask = kv_pos[None, :] < kv_valid[:, None]
    s = torch.where(vmask[:, None, None, :], s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = exp_fn(s - m)
    denom = p.sum(dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", p.reshape(b, sq, kvh, g, skv),
                     v.float()).reshape(b, sq, h, hd)
    return div_fn(o, denom[..., None])


def _int_dot(spec, a, b):
    """Exact int32 einsum of integer codes: f64 holds every partial sum of
    int8 codes exactly (and CUDA has no integer matmul)."""
    return torch.einsum(spec, a.double(), b.double()).to(torch.int32)


def int_attention(q_codes, q_scale, k_codes, v_codes, k_scale, v_scale,
                  positions, kv_valid, fmt: FxPFormat, softmax_fn=None):
    """Fully integer masked GQA attention (the reference's
    `int8_decode_attention` after its q quantize): q_codes [B, Sq, H, hd]
    int8 with q_scale [B, Sq, H, 1]; k/v codes [B, S, KV, hd] int8 with
    per-position scales [B, S, KV, 1]; keys above positions[b, i] or at/
    after kv_valid[b] masked to -1e30. `softmax_fn` is the softmax over the
    last axis (exact when None). Returns f32 [B, Sq, H, hd]."""
    b, sq_, h, hd = q_codes.shape
    skv, kvh = k_codes.shape[1], k_codes.shape[2]
    g = h // kvh
    dev = q_codes.device
    s_int = _int_dot("bqkgd,bskd->bqkgs",
                     q_codes.reshape(b, sq_, kvh, g, hd), k_codes)
    ks = k_scale.permute(0, 3, 2, 1).reshape(b, 1, kvh, 1, skv)
    s = s_int.float() * q_scale.reshape(b, sq_, kvh, g, 1) * ks
    kv_pos = torch.arange(skv, device=dev)
    mask = ((kv_pos[None, None, :] <= positions[:, :, None])
            & (kv_pos[None, None, :] < kv_valid[:, None, None]))
    s = torch.where(mask[:, :, None, None, :], s, -1e30)
    p = (torch.softmax(s, dim=-1) if softmax_fn is None
         else softmax_fn(s))
    vs = v_scale.permute(0, 3, 2, 1).reshape(b, 1, kvh, 1, skv)
    pvc, spv = quantize(p.float() * vs, fmt, axis=4)
    o = _int_dot("bqkgs,bskd->bqkgd", pvc, v_codes)
    out = o.float() * spv.reshape(b, sq_, kvh, g, 1)
    return out.reshape(b, sq_, h, hd)


def softmax_fns(cordic_softmax: bool, hr_stages: int, lv_stages: int):
    """(exp, divide) of the attention softmax: exact, or HR-CORDIC exp and
    the LV divide on operands scaled into [-1, 1]."""
    if not cordic_softmax:
        return torch.exp, lambda num, den: num / den

    def div(num, den):
        scale = torch.maximum(num.abs().amax(dim=-1, keepdim=True),
                              den) + 1e-9
        return cordic.lv_divide_float(num / scale,
                                      (den / scale).expand_as(num),
                                      lv_stages)
    return (lambda z: cordic.extended_exp_float(z, hr_stages)), div


def paged_attention_float_plain(q, k_pool, v_pool, block_tables, meta, *,
                                k_scale=None, v_scale=None,
                                cordic_softmax: bool, hr_stages: int,
                                lv_stages: int, out_dtype):
    """q: [B, KV, g, hd]; pools [NB, bs, KV, hd] (int8 codes with
    [NB, bs, KV, 1] f32 scales, or float values); block_tables [B, MB]
    int32 (sentinel NB = unallocated); meta [B, 3] int32 (lengths,
    kv_valid, query position). Returns [B, KV*g, hd] in out_dtype."""
    b, kvh, g, hd = q.shape
    k = gather_pool_view(k_pool, block_tables)             # [B, S, KV, hd]
    v = gather_pool_view(v_pool, block_tables)
    if k_scale is not None:
        k = (k.float() * gather_pool_view(k_scale, block_tables)
             ).to(torch.bfloat16)
        v = (v.float() * gather_pool_view(v_scale, block_tables)
             ).to(torch.bfloat16)
    out = masked_attention(q.reshape(b, 1, kvh * g, hd), k, v, meta[:, 2],
                           meta[:, 1], *softmax_fns(cordic_softmax,
                                                    hr_stages, lv_stages))
    return out.reshape(b, kvh * g, hd).to(out_dtype)


def paged_attention_float(q, k_pool, v_pool, block_tables, meta, *,
                          k_scale=None, v_scale=None, cordic_softmax: bool,
                          hr_stages: int, lv_stages: int, out_dtype):
    """Same contract as `paged_attention_float_plain`. CUDA tensors launch
    the kernel (bf16 q and output; int8 pools with scales, or bf16 pools);
    CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return paged_attention_float_plain(
            q, k_pool, v_pool, block_tables, meta, k_scale=k_scale,
            v_scale=v_scale, cordic_softmax=cordic_softmax,
            hr_stages=hr_stages, lv_stages=lv_stages, out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    b, kvh, g, hd = q.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    mb = block_tables.shape[1]
    quant = k_scale is not None
    if q.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
        raise NotImplementedError("paged_attention_float kernel takes and "
                                  "returns bf16")
    if quant and k_pool.dtype != torch.int8:
        raise NotImplementedError("quantized pools must hold int8 codes")
    if not quant and k_pool.dtype != torch.bfloat16:
        raise NotImplementedError("float pools must be bf16")
    if g > _MAX_G:
        raise NotImplementedError(f"at most {_MAX_G} query heads per KV head")
    if hd % 16 or hd > _MAX_HD:
        raise NotImplementedError(
            f"head_dim must be a multiple of 16, at most {_MAX_HD}")
    if tuple(k_pool.shape[2:]) != (kvh, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shape {tuple(k_pool.shape)} does not match "
                         f"q {tuple(q.shape)}")
    dev = q.device
    tensors = [q, k_pool, v_pool, block_tables, meta]
    if quant:
        tensors += [k_scale, v_scale]
    if any(t.device != dev for t in tensors):
        raise ValueError("operands on different devices")
    q = q.contiguous()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    meta = meta.to(torch.int32).contiguous()
    if quant:
        k_scale = k_scale.to(torch.float32).contiguous()
        v_scale = v_scale.to(torch.float32).contiguous()
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned")
    lib = library("paged_attention", _SIGNATURES)
    c, cap, scratch = _launch_plan(_body(k_pool.element_size(), False), b,
                                   kvh, g, hd, mb, bs, dev)
    out = torch.empty((b, kvh * g, hd), dtype=torch.bfloat16, device=dev)
    params = cordic_params(hr_stages)
    err = lib.paged_attention_float(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        tables.data_ptr(), meta.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        int(quant), b, nb, bs, kvh, g, hd, mb, c, cap, 1.0 / math.sqrt(hd),
        int(cordic_softmax), lv_stages, ctypes.byref(params),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention_float launch failed: CUDA error {err}")
    paged_attention_float.launches += 1
    return out


paged_attention_float.launches = 0


def paged_attention_int_plain(q_codes, q_scale, k_pool, v_pool, k_scale,
                              v_scale, block_tables, meta, *, fmt: FxPFormat,
                              out_dtype, softmax_fn=None):
    """q_codes [B, KV, g, hd] int8 with q_scale [B, KV, g, 1] f32 (q /
    sqrt(hd) quantized per head by the caller); int8 pools [NB, bs, KV, hd]
    with [NB, bs, KV, 1] f32 scales; block_tables [B, MB] int32 (sentinel
    NB = unallocated: zero codes and zero scales); meta [B, 3] int32
    (lengths, kv_valid, query position). `softmax_fn` over the last axis,
    exact when None. Returns [B, KV*g, hd] in out_dtype."""
    b, kvh, g, hd = q_codes.shape
    view = functools.partial(gather_pool_view, block_tables=block_tables)
    out = int_attention(q_codes.reshape(b, 1, kvh * g, hd),
                        q_scale.reshape(b, 1, kvh * g, 1), view(k_pool),
                        view(v_pool), view(k_scale), view(v_scale),
                        meta[:, 2:3], meta[:, 1], fmt, softmax_fn)
    return out.reshape(b, kvh * g, hd).to(out_dtype)


def paged_attention_int(q_codes, q_scale, k_pool, v_pool, k_scale, v_scale,
                        block_tables, meta, *, fmt: FxPFormat, out_dtype):
    """Same contract as `paged_attention_int_plain` with the exact
    softmax. CUDA tensors launch the kernel (bf16 output, int8 codes of at
    most 8 bits); CPU tensors run the plain version."""
    if q_codes.device.type == "cpu":
        return paged_attention_int_plain(
            q_codes, q_scale, k_pool, v_pool, k_scale, v_scale,
            block_tables, meta, fmt=fmt, out_dtype=out_dtype)
    if q_codes.device.type != "cuda":
        raise ValueError(f"no kernel for device {q_codes.device}")
    b, kvh, g, hd = q_codes.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    mb = block_tables.shape[1]
    if out_dtype != torch.bfloat16:
        raise NotImplementedError("paged_attention_int kernel returns bf16")
    if fmt.bits > 8 or not (q_codes.dtype == k_pool.dtype == v_pool.dtype
                            == torch.int8):
        raise NotImplementedError("paged_attention_int kernel takes int8 "
                                  "codes of at most 8 bits")
    if g > _MAX_G:
        raise NotImplementedError(f"at most {_MAX_G} query heads per KV head")
    if hd % 16 or hd > _MAX_HD:
        raise NotImplementedError(
            f"head_dim must be a multiple of 16, at most {_MAX_HD}")
    if tuple(k_pool.shape[2:]) != (kvh, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shape {tuple(k_pool.shape)} does not match "
                         f"q {tuple(q_codes.shape)}")
    dev = q_codes.device
    tensors = [q_scale, k_pool, v_pool, k_scale, v_scale, block_tables, meta]
    if any(t.device != dev for t in tensors):
        raise ValueError("operands on different devices")
    q_codes = q_codes.contiguous()
    q_scale = q_scale.to(torch.float32).contiguous()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    k_scale = k_scale.to(torch.float32).contiguous()
    v_scale = v_scale.to(torch.float32).contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    meta = meta.to(torch.int32).contiguous()
    if any(t.data_ptr() % 16 for t in (q_codes, k_pool, v_pool)):
        raise ValueError("q codes and pools must be 16-byte aligned")
    lib = library("paged_attention", _SIGNATURES)
    c, cap, scratch = _launch_plan(_BODY_INT, b, kvh, g, hd, mb, bs, dev)
    out = torch.empty((b, kvh * g, hd), dtype=torch.bfloat16, device=dev)
    err = lib.paged_attention_int(
        q_codes.data_ptr(), q_scale.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        tables.data_ptr(), meta.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        b, nb, bs, kvh, g, hd, mb, c, cap, fmt.qmax,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention_int launch failed: CUDA error {err}")
    paged_attention_int.launches += 1
    return out


paged_attention_int.launches = 0
