"""The decode chunk's step count on the port (CPU).

A decode chunk runs ``min(decode_chunk, most tokens a live row can still
emit)`` steps: the budget and the capacity bound every row, and the host
knows both, so the chunk stops where the JAX package's loop stops once every
row has hit its budget (``repro/serving/programs.py``: the loop's
``any(~done)`` condition) without reading anything back. These tests hold
the greedy ids and ``host_syncs_per_token`` of dense, paged, snapshot
(a stateful arch with ``cache_mode="paged"``) and spec serving to those of
the fixed ``decode_chunk``-step loop, and count the steps run.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving.server import (EngineConfig, LLMServer,  # noqa: E402
                                        SamplingParams)

KW = dict(dtype="float32", param_dtype="float32", vocab_size=512)
PROMPTS = ["alpha prompt for slot one",
           "a rather longer second prompt that crosses a bucket boundary",
           "err 429 err 429 err 429 err 429 err"]
CHUNK = 8

MODES = {
    "dense": ("qwen2.5-3b", dict(cache_mode="dense")),
    "paged": ("qwen2.5-3b", dict(cache_mode="paged", page_size=16)),
    "snapshot": ("xlstm-350m", dict(cache_mode="paged", page_size=16,
                                    prefill_buckets=(32, 64))),
    "spec": ("qwen2.5-3b", dict(cache_mode="dense", spec_len=4,
                                spec_ngram_min=1)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_WEIGHTS = {}


def _weights(arch):
    """Random weights with the EOS row zeroed, so every request runs its
    whole budget (the EOS guard of tests/test_torch_serving.py)."""
    if arch not in _WEIGHTS:
        cfg = ARCHS[arch].reduced(**KW)
        sd = Model(cfg, device="cpu").init(seed=1).state_dict()
        if cfg.tie_embeddings:
            sd["embed.table"][cfg.vocab_size - 1] = 0.0
        else:
            sd["unembed.table"][:, cfg.vocab_size - 1] = 0.0
        _WEIGHTS[arch] = (cfg, sd)
    return _WEIGHTS[arch]


def _serve(mode, budgets, fixed_steps: bool):
    """Serve PROMPTS with per-request budgets; ``fixed_steps`` runs every
    chunk for ``decode_chunk`` steps (the loop before the step bound)."""
    arch, ecfg = MODES[mode]
    cfg, sd = _weights(arch)
    srv = LLMServer(cfg, num_slots=3, capacity=128, params=sd, device="cpu",
                    engine_cfg=EngineConfig(decode_chunk=CHUNK, **ecfg))
    progs = srv.engine.progs
    if fixed_steps:
        fn = progs._decode_chunk_fn
        progs._decode_chunk_fn = lambda *a: fn(*a[:-1], None)
    hs = [srv.submit(p, SamplingParams(max_new_tokens=n))
          for p, n in zip(PROMPTS, budgets)]
    srv.run_until_idle()
    ids = [h.request.output_ids for h in hs]
    assert [len(x) for x in ids] == list(budgets)
    return ids, srv.stats(), progs.decode_steps


@pytest.mark.parametrize("mode", sorted(MODES))
def test_step_bound_keeps_ids_and_syncs(mode):
    """Greedy ids and host syncs per token equal the fixed-step loop's; the
    bounded loop never runs more steps."""
    budgets = (13, 5, 9)
    ids, st, steps = _serve(mode, budgets, fixed_steps=False)
    ids_f, st_f, steps_f = _serve(mode, budgets, fixed_steps=True)
    assert ids == ids_f
    assert st["host_syncs_per_token"] == st_f["host_syncs_per_token"]
    assert st["decode_chunks"] == st_f["decode_chunks"]
    assert steps <= steps_f


@pytest.mark.parametrize("mode", ["dense", "paged", "snapshot"])
def test_chunk_runs_the_steps_its_rows_need(mode):
    """Budgets under ``decode_chunk``: the one decode chunk runs as many
    steps as the longest remaining budget (the first token comes from the
    prefill), not ``decode_chunk``; without the host's step bound the loop
    stops at the same step, once every row is done."""
    budgets = (4, 6, 2)
    _, st, steps = _serve(mode, budgets, fixed_steps=False)
    assert st["decode_chunks"] == 1
    assert steps == max(budgets) - 1
    _, _, steps_f = _serve(mode, budgets, fixed_steps=True)
    assert steps_f == steps < CHUNK
