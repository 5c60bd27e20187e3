"""Mamba2 (SSD, state-space duality) layer [arXiv:2405.21060].

Prefill uses the chunked SSD algorithm: an intra-chunk quadratic term
(attention-like, masked by the decay kernel L) plus an inter-chunk
recurrence on the [H, P, N] states. Decode is the one-token recurrence
on the carried state.

Flex-PE integration, as in the reference: the in/out projections run
through the policy's quantized matmul and the SiLU gate through the
CORDIC AF (`policy.act`, so the CORDIC AF kernel on the card); the state
recurrence stays in f32 plain PyTorch.

The arithmetic follows the reference op for op, dtypes included: the
causal conv sums bf16 products in bf16, `CB` is a bf16 einsum, the
carried states enter the output term in the input's dtype, and each
einsum keeps the reference's operand order.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.precision import PrecisionPolicy, qmatmul

__all__ = ["ssm_init", "mamba2_layer", "ssd_chunked", "init_ssm_state",
           "conv_channels"]


def conv_channels(cfg) -> int:
    """Channels of the causal conv: x, B and C of the in-projection."""
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def ssm_init(normal, n_layers: int, cfg, dtype=torch.bfloat16,
             device=None):
    """Layer-stacked Mamba2 weights with the reference's distributions:
    N(0, 1/d_in) projections, conv taps N(0, 1/cw), zero conv bias,
    A_log = log(linspace(1, 16, H)), D = 1 and dt_bias = log(e - 1) in
    f32, unit norm. `normal(shape, std, dtype)` draws one leaf."""
    L, d, di = n_layers, cfg.d_model, cfg.d_inner
    h, n, g = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_ngroups
    cw, ch = cfg.conv_width, conv_channels(cfg)
    d_in_proj = 2 * di + 2 * g * n + h      # [z, x, B, C, dt]

    def per_layer(row):
        return row.to(device).expand(L, -1).clone()
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32))
    return {
        "in_proj": normal((L, d, d_in_proj), 1.0 / math.sqrt(d), dtype),
        "conv_w": normal((L, cw, ch), 1.0 / math.sqrt(cw), dtype),
        "conv_b": torch.zeros((L, ch), dtype=dtype, device=device),
        "A_log": per_layer(a_log),
        "D": torch.ones((L, h), dtype=torch.float32, device=device),
        "dt_bias": torch.full((L, h), math.log(math.e - 1),
                              dtype=torch.float32, device=device),
        "norm_w": torch.ones((L, di), dtype=dtype, device=device),
        "out_proj": normal((L, di, d), 1.0 / math.sqrt(di), dtype),
    }


def _split_proj(zxbcdt, cfg):
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
    z, xbc, dt = torch.split(
        zxbcdt, [di, di + 2 * g * n, zxbcdt.shape[-1] - 2 * di - 2 * g * n],
        dim=-1)
    return z, xbc, dt


def _silu(x):
    # jax.nn.silu as XLA computes it: x * 1 / (1 + exp(-x)), every op
    # rounded to x's dtype (torch.sigmoid rounds a bf16 sigmoid once,
    # which differs in about a third of bf16 elements)
    return x * (1 / (1 + torch.exp(-x)))


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _gated_norm(y, z, w, policy, eps=1e-5):
    """RMS norm of y * SiLU(z). Under a policy with an AF format the gate
    is `policy.act` (the CORDIC AF op, one kernel launch on the card)."""
    if policy is not None and policy.af is not None:
        gate = policy.act(z, "silu")
    else:
        gate = _silu(z)
    y = y * gate
    yf = y.float()
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps)).to(y.dtype) * w


def _segsum(x):
    """Log-space cumulative decays within a chunk: out[..., i, j] =
    sum_{j < k <= i} x[..., k], -inf above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(q, device=x.device)
    mask = idx[:, None] >= idx[None, :]
    return torch.where(mask, seg, float("-inf"))


def ssd_chunked(xh, dt, A, B, C, cfg, init_state=None, chunk=128):
    """SSD forward. xh [b, s, h, p], dt [b, s, h] (f32), A [h], B, C
    [b, s, g, n] -> (y [b, s, h, p] f32, final state [b, h, p, n] f32).
    The chunk is the largest divisor of s not above `chunk`."""
    b, s, h, p = xh.shape
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    q = min(chunk, s)
    while s % q:
        q -= 1
    nc = s // q
    rep = h // g

    xc = xh.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    Bc = B.reshape(b, nc, q, g, n)
    Cc = C.reshape(b, nc, q, g, n)
    dA = -dtc * A                                       # log-decay
    dA_cs = torch.cumsum(dA, dim=2)                     # [b, nc, q, h]

    # 1) intra-chunk (quadratic within the chunk)
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))      # [b, nc, h, q, q]
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)     # [b, nc, g, q, q]
    CB = torch.repeat_interleave(CB, rep, dim=2)        # [b, nc, h, q, q]
    M = CB * L
    y_diag = torch.einsum("bchqk,bckh,bckhp->bcqhp", M, dtc, xc.float())

    # 2) chunk states: decay-weighted outer products
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)
    BX = torch.einsum("bcqgn,bcqh,bcqhp->bchpn", Bc.float(),
                      dtc * decay_states, xc.float())  # [b, nc, h, p, n]

    # 3) inter-chunk recurrence; each chunk reads the state before it
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])         # [b, nc, h]
    carry = (init_state.float() if init_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32,
                              device=xh.device))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + BX[:, c].float()
    prev_states = torch.stack(prev, dim=1)              # [b, nc, h, p, n]

    # 4) state -> output contribution
    state_decay = torch.exp(dA_cs)                      # [b, nc, q, h]
    Cr = torch.repeat_interleave(Cc, rep, dim=3) if h != g else Cc
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Cr.float(),
                         prev_states.to(xh.dtype).float(), state_decay)
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, carry


def _conv(cat, w, s, cw, cur=None):
    # the reference's Python sum: 0 + tap 0 + tap 1 + ..., in cat's dtype;
    # `cur` (default `cat`) supplies the last tap, the current token's
    taps = [cat] * (cw - 1) + [cat if cur is None else cur]
    out = taps[0][:, 0:s] * w[0]
    for i in range(1, cw):
        out = out + taps[i][:, i:i + s] * w[i]
    return out


def mamba2_layer(p, x, cfg, policy: Optional[PrecisionPolicy] = None,
                 state=None, conv_state=None, chunk=128, n_valid=None,
                 stepwise: bool = False):
    """x [B, S, D] -> (out [B, S, D], (state [B, H, P, N] f32, conv
    window [B, cw-1, conv_ch])).

    Cache-less prefill when `state` is None; with `state` and
    `conv_state` a stateful step of any S >= 1: an SSD continuation from
    the carried state for S > 1, the recurrence for S = 1. `n_valid` [B]
    (stateful only) says how many of the S tokens are real per row:
    dt is forced to 0 past them, so their steps are the identity, and
    each row's new conv window ends at its own last valid token (a row
    with n_valid 0 gets its old window back exactly). `stepwise` runs a
    stateful S > 1 step as S one-token steps: the recurrence token by
    token, each conv tap of an earlier token read as the conv window
    stores it, so every position's output is a one-token step's, bit for
    bit (the SSD continuation sums in another order and rounds the
    carried state to x's dtype). Returns new tensors; the caller writes
    them into its cache."""
    b, s, _ = x.shape
    di, n, g, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_nheads
    pdim, cw = cfg.ssm_headdim, cfg.conv_width

    zxbcdt = qmatmul(x, p["in_proj"], policy)
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    dt = _softplus(dt.float() + p["dt_bias"])
    A = torch.exp(p["A_log"])

    decode = state is not None
    if not decode:
        pad = torch.nn.functional.pad(xbc, (0, 0, cw - 1, 0))
        xbc_c = _silu(_conv(pad, p["conv_w"], s, cw) + p["conv_b"])
        new_conv_state = pad[:, s:] if cw > 1 else None
    else:
        if n_valid is None:
            n_valid = torch.full((b,), s, dtype=torch.int32, device=x.device)
        # dt = 0 past a row's valid tokens: decay exp(0) = 1, contribution
        # 0, so the carried state does not see the padding
        live = (torch.arange(s, device=x.device)[None, :, None]
                < n_valid[:, None, None])
        dt = torch.where(live, dt, 0.0)
        cat = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
        stored = (cat.to(conv_state.dtype).to(xbc.dtype) if stepwise
                  else cat)
        xbc_c = _silu(_conv(stored, p["conv_w"], s, cw, cur=cat)
                      + p["conv_b"])
        if cw > 1:
            # each row's window ends at its own last valid token
            idx = (n_valid.long()[:, None]
                   + torch.arange(cw - 1, device=x.device)[None, :])
            new_conv_state = torch.gather(
                cat, 1, idx[:, :, None].expand(-1, -1, cat.shape[-1]))
        else:
            new_conv_state = None

    xh, Bm, Cm = torch.split(xbc_c, [di, g * n, g * n], dim=-1)
    xh = xh.reshape(b, s, h, pdim)
    Bm = Bm.reshape(b, s, g, n)
    Cm = Cm.reshape(b, s, g, n)

    if not decode:
        y, final = ssd_chunked(xh, dt, A, Bm, Cm, cfg, chunk=chunk)
    elif s > 1 and not stepwise:
        y, final = ssd_chunked(xh, dt, A, Bm, Cm, cfg,
                               init_state=state.float(), chunk=chunk)
    else:
        # h' = h * exp(-dt A) + dt * x (outer) B ; y = C . h', per token
        final, ys = state, []
        for t in range(s):
            dt1 = dt[:, t]                              # [B, H]
            dec = torch.exp(-dt1 * A)
            Bx = torch.einsum("bhp,bgn->bhpn",
                              dt1[..., None] * xh[:, t].float(),
                              Bm[:, t].float())
            final = final * dec[..., None, None] + Bx
            ys.append(torch.einsum("bgn,bhpn->bhp", Cm[:, t].float(), final))
        y = torch.stack(ys, dim=1).reshape(b, s, h, pdim)

    y = y + p["D"][:, None] * xh.float()
    y = y.reshape(b, s, di).to(x.dtype)
    y = _gated_norm(y, z, p["norm_w"], policy)
    out = qmatmul(y, p["out_proj"], policy)
    return out, (final, new_conv_state)


def init_ssm_state(cfg, batch, device=None):
    """(state [batch, H, P, N] f32, conv window [batch, cw-1, conv_ch]
    bf16), zeroed."""
    h, pdim, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    return (torch.zeros((batch, h, pdim, n), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, cfg.conv_width - 1, conv_channels(cfg)),
                        dtype=torch.bfloat16, device=device))
