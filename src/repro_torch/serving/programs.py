"""Program layer of the port's serving engine.

Counterpart of ``repro.serving.programs``: every device computation the
scheduler (serving/scheduler.py) dispatches lives here — bucketed
**prefill** into a slot's cache row, **extend** continuations (dense
chunked prefill and paged suffix prefill through block tables), the
chunked **decode** loop with on-device per-slot sampling and the batched
speculative **verify** step (one verify forward, acceptance, commit).
PyTorch runs eagerly, so there is no compile step: the "programs" are
plain methods and the cache is updated in place (the JAX package donated
it to its jits).

The decode chunk runs exactly ``decode_chunk`` steps with no host sync
inside (JAX exits its ``while_loop`` early once every row is done): a done
row of a full-attention cache rewrites the same K/V at the same position
and an empty paged row writes to trash page 0, so the extra steps change
no result. Archs with per-slot state (recurrent, conv, xLSTM, ring KV) pass
``keep = ~done`` to every decode step instead, so a done row's state stays
bit for bit (the JAX package's ``select_rows``), one masked copy per state
leaf. The scheduler then pulls everything in one transfer. Snapshot mode
copies whole state rows between the slot cache and the snapshot arena.
"""
from __future__ import annotations

import random
import time
from typing import Tuple

import torch

from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.serving.faults import DeadLetterError, RetryPolicy, TransientFault
from repro_torch.serving.sampler import accept_batched, sample_batched


def slot_extract(cache, slot: int):
    """Single-row view of slot ``slot`` of every leaf (dicts and state
    tuples alike): scan leaves are [L, B, ...], tail leaves [B, ...]. Views
    share storage: writes through them update the shared cache, so prefill
    and extend fill a slot's row in place and the JAX package's
    ``slot_splice`` is a copy between two such views (``slot_copy``)."""
    return {k: tree_map(lambda t, a=1 if k == "scan" else 0: t.narrow(a, slot, 1), v)
            for k, v in cache.items()}


def slot_copy(dst, dst_row: int, src, src_row: int):
    """Copy row ``src_row`` of every leaf of ``src`` into row ``dst_row``
    of ``dst`` (two caches of one pytree, e.g. the slot cache and the
    snapshot arena). Returns ``dst``."""
    for d, s in zip(tree_leaves(slot_extract(dst, dst_row)),
                    tree_leaves(slot_extract(src, src_row))):
        d.copy_(s)                                                    # mutation
    return dst


def auto_buckets(capacity: int, lo: int = 32) -> Tuple[int, ...]:
    """Power-of-two prompt-length buckets up to (and including) capacity."""
    buckets = []
    b = min(lo, capacity)
    while b < capacity:
        buckets.append(b)
        b *= 2
    buckets.append(capacity)
    return tuple(buckets)


class EnginePrograms:
    """The program set for one (model config, engine config) pair.

    Stateless apart from fault-layer counters: the scheduler threads the
    cache and params through every call. Per-request RNG chains: row ``b``
    samples its ``t``-th token with the key pair ``(keys[b], t)``
    (sampler.gumbel), so a request's stochastic output is a function of its
    own seed and position only, never of batch composition.
    """

    def __init__(self, model, cfg, engine_cfg, *, capacity: int,
                 num_slots: int, eos_id: int, freeze_done_rows: bool = False,
                 injector=None, retry: RetryPolicy = None,
                 watchdog_s: float = None):
        self.model = model
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.capacity = capacity
        self.num_slots = num_slots
        self.eos_id = eos_id
        self.freeze_done_rows = freeze_done_rows
        self.device = model.device
        # fault layer: every public dispatch goes through _run (injector
        # hook + bounded retry of TransientFaults + watchdog accounting)
        self.injector = injector
        self.retry = retry or RetryPolicy()
        self.watchdog_s = watchdog_s
        self.dispatch_retries = 0       # TransientFaults retried
        self.watchdog_stalls = 0        # dispatches slower than watchdog_s
        self.decode_steps = 0           # decode steps run in decode chunks
        self._retry_rng = random.Random(0)   # backoff jitter (deterministic)

    # ---- guarded dispatch --------------------------------------------------
    def _run(self, site: str, fn, *args, **kwargs):
        """One guarded device dispatch: the fault-injector hook fires first
        (it may stall — counted against the watchdog — or raise), then the
        call. ``TransientFault``s retry with exponential backoff + jitter up
        to ``retry.max_attempts``, then dead-letter; anything else
        propagates untouched for the scheduler's isolation paths (a real
        exception is never retried — the cache may be half updated)."""
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                if self.injector is not None:
                    self.injector.check(site)
                out = fn(*args, **kwargs)
            except TransientFault as e:
                attempt += 1
                self.dispatch_retries += 1
                if attempt >= self.retry.max_attempts:
                    raise DeadLetterError(
                        f"{site}: {self.retry.max_attempts} attempts "
                        "exhausted") from e
                time.sleep(self.retry.delay(attempt, self._retry_rng))
                continue
            if (self.watchdog_s is not None
                    and time.perf_counter() - t0 > self.watchdog_s):
                self.watchdog_stalls += 1
            return out

    def prefill(self, *args):
        return self._run("prefill", self._prefill_fn, *args)

    def extend(self, *args, sample: bool):
        return self._run("extend", self._extend_fn, *args, sample=sample)

    def extend_paged(self, *args, sample: bool):
        return self._run("extend_paged", self._extend_paged_fn, *args,
                         sample=sample)

    def decode_chunk(self, *args):
        return self._run("decode", self._decode_chunk_fn, *args)

    def verify(self, *args):
        return self._run("verify", self._verify_fn, *args)

    def snap_capture(self, *args):
        return self._run("snap_capture", self._snap_capture_fn, *args)

    def snap_restore(self, *args):
        return self._run("snap_restore", self._snap_restore_fn, *args)

    # ---- prefill / extend --------------------------------------------------
    def _prefill_fn(self, params, cache, tokens, positions, slot, length,
                    key, temperature, top_k):
        """Prefill one (padded) prompt straight into slot ``slot``'s cache
        row and sample its first token. (JAX prefilled a fresh one-row
        cache and spliced it in. Here prefill starts every recurrent, conv
        and xLSTM state from zero and rewrites a ring whole, and K/V rows
        past the prompt are masked by every later read, so writing the row
        directly gives the same results without a capacity-sized
        allocation per call.)"""
        logits, _ = self.model.prefill(
            params, {"tokens": tokens, "positions": positions},
            slot_extract(cache, slot), length=length, with_logits="last")
        return cache, self._sample_last(logits, key, temperature, top_k)

    def _sample_last(self, logits, key, temperature, top_k):
        """Sample one token from ``with_logits="last"`` logits [1, 1, V];
        ``key`` is the (request key, token index) pair. Returns a 0-d
        device tensor (the scheduler's admission sync pulls it)."""
        temps = keys = top_ks = None
        if temperature > 0.0:
            temps = torch.tensor([temperature], device=self.device)
            keys = torch.tensor([list(key)], dtype=torch.int64,
                                device=self.device)
            top_ks = torch.tensor([top_k], device=self.device)
        tok = sample_batched(logits[:, 0], keys, temperature=temps,
                             top_k=top_ks, vocab_limit=self.cfg.vocab_size)
        return tok[0]

    def _extend_fn(self, params, cache, tokens, positions, slot, start,
                   length, key, temperature, top_k, *, sample: bool):
        """Dense chunked-prefill continuation for one slot: the chunk
        attends to the already-prefilled prefix of the slot's row plus
        itself. ``sample=True`` (the prompt's final chunk) also unembeds
        and samples at the last valid position; other chunks skip it."""
        logits, _ = self.model.extend(
            params, {"tokens": tokens, "positions": positions},
            slot_extract(cache, slot), start, length=length,
            with_logits="last" if sample else False)
        tok = (self._sample_last(logits, key, temperature, top_k)
               if sample else None)
        return cache, tok

    def _extend_paged_fn(self, params, pool, tokens, positions, bt, start,
                         length, key, temperature, top_k, *, sample: bool):
        """Paged prefill: write the chunk's K/V into this request's pages and
        attend to its block-table view (shared prefix pages included — the
        radix-matched prefix is never recomputed)."""
        logits, pool = self.model.extend(
            params, {"tokens": tokens, "positions": positions}, pool, start,
            length=length, block_tables=bt,
            with_logits="last" if sample else False)
        tok = (self._sample_last(logits, key, temperature, top_k)
               if sample else None)
        return pool, tok

    # ---- chunked decode ----------------------------------------------------
    def _decode_chunk_fn(self, params, cache, last_tok, cache_lens, remaining,
                         done, temps, top_ks, keys, prompt_lens,
                         block_tables=None, steps=None):
        """Decode up to ``decode_chunk`` tokens for every slot on the device.

        ``steps`` (default ``decode_chunk``) is the number of decode steps
        run: the scheduler passes the most tokens any live row can still
        emit under its budget and the capacity, which it knows on the host,
        so a chunk stops where the reference's loop stops once every row
        has hit its budget. ``tok_buf`` / ``emit_buf`` keep their
        ``decode_chunk`` rows; rows past ``steps`` emit nothing.

        Per-slot done mask (EOS / budget / capacity); finished or empty
        slots keep running in the fixed batch but stop emitting and stop
        advancing (with ``freeze_done_rows``, their state rows are left
        bit for bit: a spec-handled slot sitting the chunk out decodes on
        from it next step). ``keys`` [B] are per-request keys and
        ``prompt_lens`` [B] each row's prompt length, so the row's next
        token index is
        ``cache_lens[b] - prompt_lens[b] + 1``. ``temps is None`` (an
        all-greedy batch) draws no noise at all. Nothing here reads a value
        back to the host; the scheduler pulls the returned tensors once.
        """
        chunk = self.engine_cfg.decode_chunk
        B = self.num_slots
        eos = self.eos_id
        tok_buf = torch.zeros((chunk, B), dtype=torch.int32, device=self.device)
        emit_buf = torch.zeros((chunk, B), dtype=torch.bool, device=self.device)
        last, clens, rem = last_tok, cache_lens, remaining
        steps = chunk if steps is None else min(steps, chunk)
        self.decode_steps += steps
        for i in range(steps):
            batch = {"tokens": last[:, None].long(),
                     "positions": clens[:, None].long()}
            logits, cache = self.model.decode_step(
                params, batch, cache, clens, block_tables=block_tables,
                keep=~done if self.freeze_done_rows else None)
            row_keys = None
            if temps is not None:
                cnts = (clens - prompt_lens + 1).long()  # tokens sampled so far
                row_keys = torch.stack([keys, cnts], dim=-1)
            nxt = sample_batched(logits[:, 0], row_keys, temperature=temps,
                                 top_k=top_ks, vocab_limit=self.cfg.vocab_size)
            emit = ~done
            step = emit.to(torch.int32)
            last = torch.where(emit, nxt, last)
            clens = clens + step
            rem = rem - step
            done = done | (emit & ((rem <= 0) | (nxt == eos)
                                   | (clens >= self.capacity - 1)))
            tok_buf[i] = torch.where(emit, nxt, torch.zeros_like(nxt))
            emit_buf[i] = emit
        return cache, tok_buf, emit_buf, clens, rem, done

    # ---- speculative decode: verify + accept + commit ----------------------
    def _verify_fn(self, params, cache, tokens, clens, lens, temps, top_ks,
                   keys, block_tables=None):
        """One batched speculative verify step for every slot.

        tokens [B, S]: ``[last, d_1 .. d_k, pad]`` per row (S = spec_len+1),
        lens [B] = k+1 valid inputs (0 for rows sitting this verify out:
        empty, done or undrafted slots write only dropped / trash-page rows
        and commit nothing). One forward scores every draft position;
        ``accept_batched`` picks the matched prefix + a correction/bonus
        token per drafted row; ``model.verify_commit`` resolves the cache
        (linear full attention: the written-ahead cache itself; recurrent,
        xLSTM and ring layers: gathers and ring splices at each row's
        accepted length).
        ``keys`` [B, 2] are the rows' (request key, token index of column
        0) pairs, or None for an all-greedy batch. Nothing here reads back
        to the host; the scheduler pulls (out_tok, out_len) once.
        """
        S = tokens.shape[1]
        positions = clens[:, None].long() + torch.arange(
            S, device=self.device)[None, :]
        batch = {"tokens": tokens.long(), "positions": positions}
        logits, staged = self.model.verify(params, batch, cache, clens,
                                           lens=lens, block_tables=block_tables)
        out_tok, out_len = accept_batched(
            logits, tokens, torch.clamp(lens - 1, min=0), keys,
            temperature=temps, top_k=top_ks, vocab_limit=self.cfg.vocab_size)
        cache = self.model.verify_commit(staged, clens, out_len, lens)
        return cache, out_tok, out_len

    # ---- per-prefix snapshot copies (snapshot mode) ------------------------
    def _snap_capture_fn(self, arena, cache, sid, slot):
        """Copy slot ``slot``'s complete state row into arena row ``sid``."""
        return slot_copy(arena, sid, cache, slot)

    def _snap_restore_fn(self, cache, arena, sid, slot):
        """Restore arena row ``sid`` into slot ``slot``: equivalent to
        having prefilled the snapshot's prefix into that slot."""
        return slot_copy(cache, slot, arena, sid)
