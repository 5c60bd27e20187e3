"""ModelExecutor: the device-owning half of the serving engine.

Owns the params and the slot-pool cache on the device, the coalesced host
mirrors of the device control arrays (`lengths`, `block_tables`, SSM
reset rows), and a
**device-resident sampled-token feedback buffer**: decode and sampling
run as one step that writes each slot's sampled token straight back into
the `[max_slots]` buffer the next decode tick reads its inputs from. The
host never syncs a sampled token to build the next dispatch; it drains
token values one tick behind, to emit events and detect EOS.

Invalid rows (`n_valid == 0`) are fed token 0, exactly as the reference
engine feeds them: the activation quantization scale is per tensor over
the whole [max_slots, K] block, so what idle rows hold moves every live
row's grid.

The steps run eagerly on the device's current stream; PyTorch returns
before the device finishes, which is what lets the overlap loop enqueue
tick N+1 before it reads tick N's tokens.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models import model as M

__all__ = ["ModelExecutor", "sample_tokens", "to_device"]


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """Host array -> device tensor without waiting for the device: a CUDA
    upload goes through pinned memory as an asynchronous copy on the
    current stream (a pageable copy would first drain the stream and
    serialise the overlap loop)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def sample_tokens(vocab: int, logits: torch.Tensor, gens: list,
                  temps: np.ndarray, topks: np.ndarray) -> torch.Tensor:
    """logits [R, V*] -> tokens [R] int32: greedy rows (temperature <= 0)
    take the first maximal logit; sampled rows apply top-k and temperature
    and draw with their own `torch.Generator` (Gumbel-max). Row-wise, so a
    row's token does not depend on which rows share the call."""
    lg = logits[:, :vocab].float()
    toks = torch.argmax(lg, dim=-1).to(torch.int32)
    for r in np.flatnonzero(temps > 0.0):
        row = lg[r]
        if topks[r] > 0:
            k = int(min(topks[r], vocab))
            thresh = torch.topk(row, k).values[-1]
            row = torch.where(row < thresh, float("-inf"), row)
        row = row / max(float(temps[r]), 1e-6)
        u = torch.rand(row.shape, generator=gens[r], device=row.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        toks[r] = torch.argmax(row + gumbel).to(torch.int32)
    return toks


class ModelExecutor:
    """Device-side execution behind the scheduler/executor split."""

    def __init__(self, cfg, params, policy=None, device=None, max_slots=4,
                 max_len=256, prefill_chunk=32,
                 kv_block_size: Optional[int] = None,
                 kv_blocks: Optional[int] = None):
        self.cfg = cfg
        self.params = params
        self.policy = policy
        self.device = device
        self.max_slots = max_slots
        # over-allocate by one chunk: a ragged write window [len, len+chunk)
        # must stay in bounds for every row with len < max_len
        self.alloc = max_len + prefill_chunk
        self.prefill_chunk = prefill_chunk
        self.verify_chunk = 0            # set by ensure_verify_step
        self.cache = M.init_cache(cfg, max_slots, self.alloc, policy,
                                  kv_block_size=kv_block_size,
                                  kv_blocks=kv_blocks, device=device)
        self.paged = "block_tables" in self.cache
        self.has_ssm = "ssm" in self.cache
        self.num_blocks = (int(self.cache["kv"]["k"].shape[1])
                           if self.paged else 0)
        self._token_buf = torch.zeros((max_slots,), dtype=torch.int32,
                                      device=device)
        # host mirrors of the device control arrays: admission and block
        # allocation write here; `flush` uploads each dirty array once
        self._lengths_host = np.zeros((max_slots,), np.int32)
        self._lengths_dirty = False
        if self.paged:
            mb = self.cache["block_tables"].shape[1]
            self._tables_host = np.full((max_slots, mb), self.num_blocks,
                                        np.int32)
            self._tables_dirty = False
        self._ssm_reset_rows: List[int] = []
        self.h2d_updates = 0
        self.cow_copies = 0

    # -- mirror-write protocol (the scheduler's view of the device) ---------

    def set_length(self, row: int, value: int):
        self._lengths_host[row] = value
        self._lengths_dirty = True

    def write_table(self, row: int, idx: int, blk: int):
        self._tables_host[row, idx] = blk
        self._tables_dirty = True

    def reset_table_row(self, row: int):
        self._tables_host[row, :] = self.num_blocks
        self._tables_dirty = True

    def reset_ssm_row(self, row: int):
        """Queue `row`'s recurrent state (and conv window) for zeroing at
        the next `flush`: a newly admitted request starts from zeros."""
        self._ssm_reset_rows.append(row)

    def clear_table_entry(self, row: int, idx: int):
        self._tables_host[row, idx] = self.num_blocks
        self._tables_dirty = True

    def fork_block(self, src: int, dst: int):
        """Copy-on-write fork of one pool block (codes and scales)."""
        M.copy_pool_blocks(self.cache, [src], [dst])
        self.cow_copies += 1

    def flush(self):
        """Upload this tick's admission / allocation mutations: at most
        one host-to-device copy per control array per tick (and one
        zeroing of the SSM rows admitted since the last flush)."""
        if self._ssm_reset_rows:
            rows = to_device(np.asarray(sorted(set(self._ssm_reset_rows)),
                                        np.int64), self.device)
            for a in self.cache["ssm"]:
                a.index_fill_(1, rows, 0)
            self._ssm_reset_rows.clear()
            self.h2d_updates += 1
        if self._lengths_dirty:
            self.cache["lengths"] = to_device(self._lengths_host.copy(),
                                              self.device)
            self._lengths_dirty = False
            self.h2d_updates += 1
        if self.paged and self._tables_dirty:
            self.cache["block_tables"] = to_device(self._tables_host.copy(),
                                                   self.device)
            self._tables_dirty = False
            self.h2d_updates += 1

    # -- device dispatches (all return un-synced device tensors) ------------

    def prefill(self, row: int, tokens: torch.Tensor, take: int):
        """One [1, chunk] chunked-prefill step against slot `row`; returns
        that row's last-valid logits [V*] (device)."""
        sub = M.slice_cache_rows(self.cache, row, 1)
        n_valid = torch.full((1,), take, dtype=torch.int32,
                             device=self.device)
        logits, new_sub = M.decode_step(self.cfg, self.params, sub, tokens,
                                        policy=self.policy, n_valid=n_valid,
                                        last_only=True)
        M.update_cache_rows(self.cache, new_sub, row)
        self._lengths_host[row] += take      # mirror the step's +take
        return logits[0, -1]

    def decode_and_sample(self, n_valid: np.ndarray, gens: list,
                          temps: np.ndarray, topks: np.ndarray):
        """One pool-decode + sample step. `n_valid` [B] (host) marks the
        frontier rows; returns the sampled tokens [B] (device, unsynced) —
        entries of other rows are garbage the caller ignores."""
        nv = to_device(n_valid, self.device)
        live = nv > 0
        tokens = torch.where(live, self._token_buf, 0)[:, None]
        logits, self.cache = M.decode_step(self.cfg, self.params, self.cache,
                                           tokens, policy=self.policy,
                                           n_valid=nv, last_only=True)
        toks = sample_tokens(self.cfg.vocab, logits[:, -1], gens, temps,
                             topks)
        self._token_buf = torch.where(live, toks, self._token_buf)
        self._lengths_host[n_valid > 0] += 1  # mirror the step's +1
        return toks

    def seed_tokens(self, rows: List[int], logits_rows, gens: list,
                    temps: np.ndarray, topks: np.ndarray):
        """Sample first tokens for rows that finished prefill this tick and
        scatter them into the feedback buffer; returns tokens [R]."""
        toks = sample_tokens(self.cfg.vocab, torch.stack(logits_rows), gens,
                             temps, topks)
        idx = to_device(np.asarray(rows, np.int64), self.device)
        buf = self._token_buf.clone()
        buf[idx] = toks
        self._token_buf = buf
        return toks

    # -- speculative decoding (chunked verify + rollback support) -----------

    def ensure_verify_step(self, chunk: int):
        """Set the verify step's width `chunk` = k + 1. The steps run
        eagerly, so nothing is compiled here; the width must fit the
        cache: a verify window [len, len + chunk) dispatched at
        len <= max_len - 2 stays inside the alloc = max_len +
        prefill_chunk rows iff chunk <= prefill_chunk + 1."""
        if not 1 <= chunk <= self.prefill_chunk + 1:
            raise ValueError(
                f"verify width {chunk} does not fit the cache allocation "
                f"(1 <= chunk <= prefill_chunk + 1 = "
                f"{self.prefill_chunk + 1})")
        self.verify_chunk = chunk

    def verify(self, tokens: np.ndarray, n_valid: np.ndarray,
               ssm_stepwise: bool = True):
        """One chunked verify step: the token grid [B, chunk] (draft
        proposals, a draft ingest, or a post-rollback SSM replay) with
        per-row valid counts, every position scored by
        `decode_step(..., last_only=False)` and reduced to its greedy
        token: argmax over the true vocab in f32, `sample_tokens`' greedy
        branch. So position j's token is what a one-token decode at that
        position samples under greedy, whenever the policy's numerics do
        not depend on how the chunk is composed. To that end the SSM
        layers run their positions as one-token steps (`ssm_stepwise`;
        the reference's SSD continuation breaks it under bf16, ROADMAP.md
        queue 3); a draft ingest, which needs no such guarantee, keeps the
        reference's SSD with `ssm_stepwise=False`. Past each row's
        frontier the step is fed token 0 (rows with n_valid 0 stay
        untouched); each live row's feedback-buffer entry takes its last
        valid position's token. Returns the tokens [B, chunk] (device,
        unsynced) and mirrors the step's per-row `+= n_valid`."""
        chunk = self.verify_chunk
        if chunk == 0 or np.shape(tokens) != (self.max_slots, chunk):
            raise ValueError(
                f"verify wants a [{self.max_slots}, {chunk}] token grid "
                f"(ensure_verify_step sets the width), got "
                f"{np.shape(tokens)}")
        nv_host = np.asarray(n_valid, np.int32)
        nv = to_device(nv_host, self.device)
        grid = to_device(np.asarray(tokens, np.int64), self.device)
        live = (torch.arange(chunk, device=self.device)[None, :]
                < nv[:, None])
        feed = torch.where(live, grid, 0)
        logits, self.cache = M.decode_step(self.cfg, self.params, self.cache,
                                           feed, policy=self.policy,
                                           n_valid=nv, last_only=False,
                                           ssm_stepwise=ssm_stepwise)
        toks = torch.argmax(logits[..., :self.cfg.vocab].float(),
                            dim=-1).to(torch.int32)
        idx = torch.clamp(nv - 1, 0, chunk - 1).long()
        last = toks.gather(1, idx[:, None])[:, 0]
        self._token_buf = torch.where(nv > 0, last, self._token_buf)
        self._lengths_host += nv_host        # mirror the step's +n_valid
        return toks

    # -- recurrent-state rollback (speculative decoding) --------------------

    def checkpoint_ssm(self):
        """A copy of the recurrent SSM state and conv windows, taken ahead
        of a speculative dispatch (the steps write the cache in place)."""
        return tuple(a.clone() for a in self.cache["ssm"])

    def restore_ssm_rows(self, rows: List[int], saved):
        """Rewind `rows`' recurrent state to a `checkpoint_ssm` copy. A KV
        window truncates by clamping its length, but a recurrent carry
        has already folded the rejected positions in: the only rollback
        is restore, then replay."""
        r = to_device(np.asarray(sorted(rows), np.int64), self.device)
        for a, s in zip(self.cache["ssm"], saved):
            a.index_copy_(1, r, s.index_select(1, r))
