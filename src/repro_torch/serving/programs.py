"""Program layer of the port's serving engine.

Counterpart of ``repro.serving.programs``: every device computation the
scheduler (serving/scheduler.py) dispatches lives here — bucketed
**prefill** into a slot's cache row, **extend** continuations (dense
chunked prefill and paged suffix prefill through block tables), the
chunked **decode** loop with on-device per-slot sampling and the batched
speculative **verify** step (one verify forward, acceptance, commit).
Prefill and extend run eagerly and update the cache in place (the JAX
package donated it to its jits).

The decode step and the verify step are the port's counterpart of the
reference's compiled decode loop and verify program: each reads and writes
static buffers in place (its carries, its constants, its outputs at a
device-side step index), so on the card each is one captured CUDA graph,
replayed ``steps`` times per decode chunk and once per verify step, one
graph per variant the reference also specializes on (greedy, sampled,
top-k). The scheduler's inputs are staged into those buffers by one
packed host-to-device copy. The CPU runs the same step functions eagerly.

A decode chunk runs at most ``decode_chunk`` steps with no host sync
inside, and stops once every row is done, as JAX exits its ``while_loop``:
on the card the chunk is one CUDA graph whose conditional while node
replays the captured step (``kernels/decode_loop.py``), on the CPU the
loop checks ``done`` after every step. Inside a chunk a done row of a
full-attention cache rewrites the same K/V at the same position and an
empty paged row writes to trash page 0, so the steps of other rows change
no result of it. Archs with per-slot state (recurrent, conv, xLSTM, ring KV) pass
``keep = ~done`` to every decode step instead, so a done row's state stays
bit for bit (the JAX package's ``select_rows``), one masked copy per state
leaf. The scheduler then pulls everything in one transfer. Snapshot mode
copies whole state rows between the slot cache and the snapshot arena.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import random
import threading
import time
from typing import Tuple

import torch

from repro_torch.distributed import sharding
from repro_torch.kernels import launch_counts
from repro_torch.kernels.decode_loop import WhileGraph
from repro_torch.models.transformer import DTYPES, tree_leaves, tree_map
from repro_torch.serving.faults import DeadLetterError, RetryPolicy, TransientFault
from repro_torch.serving.sampler import accept_batched, sample_batched

# One capture at a time in the process. ``torch.cuda.graph`` synchronizes the
# device and empties the caching allocator's cache as it begins, which must
# not happen while another thread's capture is open; so the programs of
# several servers (the replicas of a fleet, each captured on its own pump
# thread) take turns to capture. Eager work and replays of other threads go
# on during a capture: each capture is thread-local, on its own stream and
# memory pool.
_CAPTURE_LOCK = threading.Lock()


@contextlib.contextmanager
def _no_gc():
    """No automatic garbage collection during a capture. A graph collected
    there (a dropped ``torch.cuda.CUDAGraph`` of another server, or a
    ``WhileGraph``) destroys its executable graph, and on the capturing
    thread that call fails with cudaErrorStreamCaptureUnsupported and
    invalidates the capture (``tests/test_torch_gpu.py``:
    ``test_gpu_capture_with_garbage_graphs``)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


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


def model_inputs(cfg, tokens, positions):
    """The model's inputs for token ids [B, S]. An ``audio_frames`` config
    gets the reference's frame-embedding stub instead, ``one_hot(ids %
    d_model, d_model)`` in ``cfg.dtype``, made on the ids' device (inside
    the decode step's graph too), so the scheduler, its staged inputs and
    the radix tree keep working on token ids."""
    if cfg.modality != "audio_frames":
        return {"tokens": tokens, "positions": positions}
    D = cfg.d_model
    cls = torch.arange(D, device=tokens.device)
    frames = ((tokens % D)[..., None] == cls).to(DTYPES[cfg.dtype])
    return {"frames": frames, "positions": positions}


def _variant(temps, top_ks) -> str:
    """The step program's variant, one graph each, as the JAX package
    specializes its jits: "greedy" (``temps is None``: no noise, no sort),
    "sampled", or "top_k"."""
    if temps is None:
        return "greedy"
    return "sampled" if top_ks is None else "top_k"


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
                 watchdog_s: float = None, mesh=None, rules=None):
        self.model = model
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.capacity = capacity
        self.num_slots = num_slots
        self.eos_id = eos_id
        self.freeze_done_rows = freeze_done_rows
        self.device = model.device
        # mesh: the steps run under the serve rules, whose "data" shards
        # (``rows``) and "model" shards the model's cache kernels launch
        # over; on a mesh over several devices the steps run eagerly
        self.rules = rules
        self.rows = sharding.data_rows(num_slots, mesh, rules) if mesh else [
            slice(0, num_slots)]
        self.graphs = (self.device.type == "cuda"
                       and (mesh is None or len(mesh.distinct_devices()) == 1))
        # fault layer: every public dispatch goes through _run (injector
        # hook + bounded retry of TransientFaults + watchdog accounting)
        self.injector = injector
        self.retry = retry or RetryPolicy()
        self.watchdog_s = watchdog_s
        self.dispatch_retries = 0       # TransientFaults retried
        self.watchdog_stalls = 0        # dispatches slower than watchdog_s
        self._decode_steps = 0          # decode steps run in decode chunks
        self.verify_steps = 0           # verify steps run
        # the last chunk's while-graph launch, until its step count is known
        # (``settle``): (program, launches a step, step buffer, counted)
        self._pending = None
        self._retry_rng = random.Random(0)   # backoff jitter (deterministic)
        # step programs (card): static buffers by program, graphs by
        # (program, variant), bound to one (params, cache) pair
        self.graph_captures = collections.Counter()     # by program
        self._graph_replays = collections.Counter()     # by program
        self._bufs = {}
        self._graphs = {}
        self._bound = None
        self._staging = None            # device side of the packed inputs
        self._stream = None             # warm-up and capture stream
        self._pool = None               # the graphs' shared memory pool
        self._eager = False             # eager() on the card

    @property
    def decode_steps(self) -> int:
        """Decode steps run in decode chunks (the last chunk settled)."""
        self.settle()
        return self._decode_steps

    @property
    def graph_replays(self) -> collections.Counter:
        """Replayed steps by program (the last chunk settled)."""
        self.settle()
        return self._graph_replays

    def chunk_steps(self):
        """The last decode chunk's step count, a device int64 [1] (the
        scheduler pulls it with the chunk's outputs; zeros before any)."""
        bufs = self._bufs.get("decode")
        if bufs is None:
            return torch.zeros(1, dtype=torch.int64, device=self.device)
        return bufs["step"]

    def settle(self, ran=None):
        """Count the steps of the last chunk launched as one while graph:
        ``ran`` steps (the pulled ``chunk_steps()``), or read the step
        buffer here (one sync) when no value is given. The launches of the
        captured step count once per replayed step."""
        if self._pending is None:
            return
        program, launches, buf, counted = self._pending
        self._pending = None
        ran = int(buf.item() if ran is None else ran)
        self._decode_steps += ran
        self._graph_replays[program] += ran - counted
        launch_counts.add({k: v * (ran - counted) for k, v in launches.items()})

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
            params, model_inputs(self.cfg, tokens, positions),
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
            params, model_inputs(self.cfg, tokens, positions),
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
            params, model_inputs(self.cfg, tokens, positions), pool, start,
            length=length, block_tables=bt,
            with_logits="last" if sample else False)
        tok = (self._sample_last(logits, key, temperature, top_k)
               if sample else None)
        return pool, tok

    # ---- step programs: static buffers, replayed CUDA graphs ---------------
    @contextlib.contextmanager
    def eager(self):
        """Run the decode and verify steps eagerly on the card, without a
        graph, for the calls inside: the comparison path of the card's
        tests and chip_smoke.py. (The CPU always runs them eagerly.)"""
        prev, self._eager = self._eager, True
        try:
            yield self
        finally:
            self._eager = prev

    def _buffers(self, program: str, shapes):
        """The static buffers of ``program`` ({name: (shape, dtype)}), made
        anew (dropping the program's graphs, which hold their addresses)
        when a shape changes."""
        bufs = self._bufs.get(program)
        if bufs is None or {k: tuple(t.shape) for k, t in bufs.items()} != \
                {k: s[0] for k, s in shapes.items()}:
            bufs = {k: torch.zeros(s[0], dtype=s[1], device=self.device)
                    for k, s in shapes.items()}
            self._bufs[program] = bufs
            for key in [k for k in self._graphs if k[0] == program]:
                del self._graphs[key]
        return bufs

    def _stage(self, bufs, values):
        """Copy a step's host inputs (lists, numpy arrays, CPU tensors) into
        its static buffers: packed into one int64 tensor (float32 by its
        bits; pinned on the card), moved with one asynchronous copy and
        unpacked on the device. ``None`` leaves a buffer as it is."""
        host = [(bufs[name], torch.as_tensor(v, device="cpu").reshape(-1))
                for name, v in values.items() if v is not None]
        packed = torch.cat([
            (t.float().view(torch.int32) if b.dtype == torch.float32 else t).long()
            for b, t in host])
        if self.device.type == "cuda":
            packed = packed.pin_memory()
        if self._staging is None or self._staging.numel() < packed.numel():
            self._staging = torch.empty(packed.numel(), dtype=torch.int64,
                                        device=self.device)
        dev = self._staging[:packed.numel()]
        dev.copy_(packed, non_blocking=True)
        o = 0
        for buf, t in host:
            seg = dev[o:o + t.numel()].view(buf.shape)
            o += t.numel()
            if buf.dtype == torch.float32:
                seg = seg.to(torch.int32).view(torch.float32)
            buf.copy_(seg)

    def _run_steps(self, program: str, variant: str, step, n: int, params,
                   cache, loop=None):
        """Run ``step`` (one step over static buffers) ``n`` times, or, with
        ``loop`` (buffers ``step``, ``nsteps`` = n and ``done``), while
        ``step < nsteps`` and some row is not done. On the CPU, or inside
        ``eager()``, it runs as Python (checking ``done`` on the host). On
        the card the first call of each (program, variant) runs one real
        step eagerly on a side stream as the warm-up, then captures the step
        into a CUDA graph (all of this programs object's graphs share one
        memory pool); later steps replay it, or, with ``loop``, run inside
        one graph launch whose while node loops on the device
        (``settle`` counts them once the step count is pulled). A capture
        that fails, or reaches a host sync, raises: there is no eager
        fallback on the card."""
        if n <= 0:
            return
        if not self.graphs or self._eager:
            ran = 0
            while ran < n and (loop is None or not bool(loop["done"].all())):
                step()
                ran += 1
            if loop is not None:
                self._decode_steps += ran
            return
        if self._bound is None or self._bound[0] is not params \
                or self._bound[1] is not cache:
            self._graphs.clear()            # graphs hold the old addresses
            self._bound = (params, cache)
        graph = self._graphs.get((program, variant))
        counted = 0
        if graph is None:
            if loop is not None and bool(loop["done"].all()):
                return                      # (a sync; a capture syncs anyway)
            graph = self._capture(step, loop)
            self._graphs[program, variant] = graph
            self.graph_captures[program] += 1
            n -= 1                          # the warm-up was a real step
            counted = 1
        if loop is None:
            for _ in range(n):
                graph.replay()
            self._graph_replays[program] += n
            return
        graph.graph.launch()
        self._pending = (program, graph.launches, loop["step"], counted)

    def _capture(self, step, loop=None):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        s, cur = self._stream, torch.cuda.current_stream(self.device)
        s.wait_stream(cur)
        with torch.cuda.stream(s):          # warm-up: builds and loads the
            step()                          # kernels, lazy library state
        cur.wait_stream(s)
        graph = torch.cuda.CUDAGraph(keep_graph=loop is not None)
        launches = {}
        try:
            with _CAPTURE_LOCK, _no_gc(), launch_counts.captured(launches):
                with torch.cuda.graph(graph, pool=self._pool, stream=s,
                                      capture_error_mode="thread_local"):
                    step()
        except BaseException:
            self._pool = None               # it may still be marked as capturing
            raise
        finally:
            torch.cuda.set_stream(cur)      # also when the capture failed
        if loop is not None:
            graph = WhileGraph(graph, loop["step"], loop["nsteps"], loop["done"])
        return launch_counts.Replayed(graph, launches)

    # ---- chunked decode ----------------------------------------------------
    def _decode_chunk_fn(self, params, cache, last_tok, cache_lens, remaining,
                         done, temps, top_ks, keys, prompt_lens,
                         block_tables=None, steps=None):
        """Decode up to ``decode_chunk`` tokens for every slot on the device.

        ``steps`` (default ``decode_chunk``) is the most decode steps run:
        the scheduler passes the most tokens any live row can still emit
        under its budget and the capacity, which it knows on the host. The
        chunk also stops once every row is done (an EOS), where the
        reference's loop stops. ``tok_buf`` / ``emit_buf`` keep their
        ``decode_chunk`` rows; rows past the steps run emit nothing.

        The inputs (host values or tensors) are staged into static buffers
        and ``_decode_step`` runs over them: on the card inside one CUDA
        graph launch whose while node loops on the device (``_run_steps``;
        ``chunk_steps()`` holds the count), eagerly on the CPU.

        Per-slot done mask (EOS / budget / capacity); finished or empty
        slots keep running in the fixed batch but stop emitting and stop
        advancing (with ``freeze_done_rows``, their state rows are left bit
        for bit: a spec-handled slot sitting the chunk out decodes on from
        it next step). ``keys`` [B] are per-request keys and
        ``prompt_lens`` [B] each row's prompt length, so the row's next
        token index is ``cache_lens[b] - prompt_lens[b] + 1``. ``temps is
        None`` (an all-greedy batch) draws no noise at all. Nothing here
        reads a value back to the host; the scheduler pulls the returned
        static buffers (valid until the next call) once.
        """
        chunk, B = self.engine_cfg.decode_chunk, self.num_slots
        i32 = torch.int32
        shapes = {"last": ((B,), i32), "clens": ((B,), i32), "rem": ((B,), i32),
                  "done": ((B,), torch.bool), "temps": ((B,), torch.float32),
                  "top_ks": ((B,), i32), "keys": ((B,), torch.int64),
                  "plens": ((B,), i32), "tok": ((chunk, B), i32),
                  "emit": ((chunk, B), torch.bool), "step": ((1,), torch.int64),
                  "nsteps": ((1,), i32)}
        if block_tables is not None:
            shapes["bt"] = (tuple(block_tables.shape), i32)
        self.settle()                       # before the step buffer is reused
        bufs = self._buffers("decode", shapes)
        steps = chunk if steps is None else min(steps, chunk)
        self._stage(bufs, {"last": last_tok, "clens": cache_lens,
                           "rem": remaining, "done": done, "temps": temps,
                           "top_ks": top_ks, "keys": keys, "plens": prompt_lens,
                           "bt": block_tables, "nsteps": [steps]})
        for k in ("tok", "emit", "step"):
            bufs[k].zero_()
        variant = _variant(temps, top_ks)
        self._run_steps("decode", variant,
                        lambda: self._decode_step(params, cache, bufs, variant),
                        steps, params, cache, bufs)
        return (cache, bufs["tok"], bufs["emit"], bufs["clens"], bufs["rem"],
                bufs["done"])

    def _decode_step(self, params, cache, b, variant):
        """One decode step over the static buffers ``b``, in place: the
        carries ``last``, ``clens``, ``rem``, ``done`` advance, and row
        ``b["step"]`` (a device-side index the step advances) of ``tok`` /
        ``emit`` takes the step's tokens."""
        last, clens, rem, done = b["last"], b["clens"], b["rem"], b["done"]
        batch = model_inputs(self.cfg, last[:, None].long(), clens[:, None].long())
        with sharding.use_rules(self.rules):
            logits, _ = self.model.decode_step(
                params, batch, cache, clens, block_tables=b.get("bt"),
                keep=~done if self.freeze_done_rows else None)
        row_keys = temps = top_ks = None
        if variant != "greedy":
            cnts = (clens - b["plens"] + 1).long()       # tokens sampled so far
            row_keys = torch.stack([b["keys"], cnts], dim=-1)
            temps = b["temps"]
            top_ks = b["top_ks"] if variant == "top_k" else None
        nxt = sample_batched(logits[:, 0], row_keys, temperature=temps,
                             top_k=top_ks, vocab_limit=self.cfg.vocab_size)
        emit = ~done
        step = emit.to(torch.int32)
        b["tok"].index_copy_(0, b["step"],
                             torch.where(emit, nxt, torch.zeros_like(nxt))[None])
        b["emit"].index_copy_(0, b["step"], emit[None])
        new_clens, new_rem = clens + step, rem - step
        new_done = done | (emit & ((new_rem <= 0) | (nxt == self.eos_id)
                                   | (new_clens >= self.capacity - 1)))
        last.copy_(torch.where(emit, nxt, last))
        clens.copy_(new_clens)
        rem.copy_(new_rem)
        done.copy_(new_done)
        b["step"].add_(1)

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
        0) pairs, or None for an all-greedy batch. The inputs are staged
        into static buffers and ``_verify_step`` runs over them, as a
        replayed CUDA graph on the card (``_run_steps``). Nothing here reads
        back to the host; the scheduler pulls the returned static buffers
        (out_tok, out_len) once.
        """
        B, S = self.num_slots, tokens.shape[1]
        i32 = torch.int32
        shapes = {"tokens": ((B, S), i32), "clens": ((B,), i32),
                  "lens": ((B,), i32), "temps": ((B,), torch.float32),
                  "top_ks": ((B,), i32), "keys": ((B, 2), torch.int64),
                  "out_tok": ((B, S), i32), "out_len": ((B,), i32)}
        if block_tables is not None:
            shapes["bt"] = (tuple(block_tables.shape), i32)
        bufs = self._buffers("verify", shapes)
        self._stage(bufs, {"tokens": tokens, "clens": clens, "lens": lens,
                           "temps": temps, "top_ks": top_ks, "keys": keys,
                           "bt": block_tables})
        variant = _variant(temps, top_ks)
        self.verify_steps += 1
        self._run_steps("verify", variant,
                        lambda: self._verify_step(params, cache, bufs, variant),
                        1, params, cache)
        return cache, bufs["out_tok"], bufs["out_len"]

    def _verify_step(self, params, cache, b, variant):
        """One verify step over the static buffers ``b``: forward, accept,
        commit; ``out_tok`` / ``out_len`` take the result."""
        tokens, clens, lens = b["tokens"], b["clens"], b["lens"]
        S = tokens.shape[1]
        positions = clens[:, None].long() + torch.arange(
            S, device=self.device)[None, :]
        batch = {"tokens": tokens.long(), "positions": positions}
        with sharding.use_rules(self.rules):
            logits, staged = self.model.verify(params, batch, cache, clens, lens=lens,
                                               block_tables=b.get("bt"))
        greedy = variant == "greedy"
        out_tok, out_len = accept_batched(
            logits, tokens, torch.clamp(lens - 1, min=0),
            None if greedy else b["keys"],
            temperature=None if greedy else b["temps"],
            top_k=b["top_ks"] if variant == "top_k" else None,
            vocab_limit=self.cfg.vocab_size)
        self.model.verify_commit(staged, clens, out_len, lens)
        b["out_tok"].copy_(out_tok)
        b["out_len"].copy_(out_len)

    def launch_shards(self, params, layer: int) -> int:
        """The shards that launch layer ``layer``'s kernel in one decode or
        verify step: one on one device; on a mesh, the "data" shards times
        the "model" shards its mixer is cut over (1 where it stays whole,
        as attention does when the KV heads do not divide "model")."""
        blk = params.blocks[layer]
        mixer = next(getattr(blk, n) for n in ("attn", "rec", "mlstm", "slstm")
                     if hasattr(blk, n))
        parts = mixer.devices() if isinstance(mixer, sharding.Placed) else None
        return len(self.rows) * (len(parts) if parts else 1)

    # ---- per-prefix snapshot copies (snapshot mode) ------------------------
    def _snap_capture_fn(self, arena, cache, sid, slot):
        """Copy slot ``slot``'s complete state row into arena row ``sid``."""
        return slot_copy(arena, sid, cache, slot)

    def _snap_restore_fn(self, cache, arena, sid, slot):
        """Restore arena row ``sid`` into slot ``slot``: equivalent to
        having prefilled the snapshot's prefix into that slot."""
        return slot_copy(cache, slot, arena, sid)
