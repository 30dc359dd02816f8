"""The port's stateful kernels (rglru_scan, mlstm_chunk) against the JAX
package on the CPU, and against their plain versions on the card.

On the CPU the wrappers run their plain versions (the CUDA kernels have
no CPU mode), so these tests hold the plain versions and the wrappers'
contracts to the JAX package: the Pallas kernels in interpret mode, the
sequential oracles of ``repro.kernels.ref`` and the model's chunkwise mLSTM
(``repro.models.xlstm.mlstm_chunkwise``) with its state. Bounds: float32
5e-6 for the scan and 2e-5 for the mLSTM (tests/test_kernels.py:101, 139).
The kernels against their plain versions on the card are the ``gpu`` cases
of tests/test_torch_gpu.py, which imports no JAX (the card's machine has
none).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.mlstm_chunk import mlstm_chunk as jax_mlstm_chunk  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan  # noqa: E402
from repro.models.xlstm import mlstm_chunkwise  # noqa: E402
from repro_torch.kernels import mlstm_chunk as kmc  # noqa: E402
from repro_torch.kernels import rglru_scan as krs  # noqa: E402

SCAN_TOL, MLSTM_TOL = 5e-6, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite runs several
    workers side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _scan_inputs(seed, B, S, R):
    rs = np.random.RandomState(seed)
    a = 1.0 / (1.0 + np.exp(-rs.standard_normal((B, S, R))))
    return (a.astype(np.float32), rs.standard_normal((B, S, R)).astype(np.float32),
            rs.standard_normal((B, R)).astype(np.float32))


def _mlstm_inputs(seed, B, S, H, hd, fg_shift=2.0):
    rs = np.random.RandomState(seed)
    q = (rs.standard_normal((B, S, H, hd)) * 0.5).astype(np.float32)
    k = (rs.standard_normal((B, S, H, hd)) * 0.5).astype(np.float32)
    v = rs.standard_normal((B, S, H, hd)).astype(np.float32)
    ig = rs.standard_normal((B, S, H)).astype(np.float32)
    fg = (rs.standard_normal((B, S, H)) + fg_shift).astype(np.float32)
    return q, k, v, ig, fg


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


# ---------------------------------------------------------------------------
# rglru_scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,R", [(1, 64, 64), (2, 150, 100), (1, 257, 128)])
def test_rglru_scan_matches_pallas_and_ref(B, S, R):
    """No h0 (the Pallas kernel has none): y and h_last against the Pallas
    kernel (interpret mode) and the sequential oracle."""
    a, bx, _ = _scan_inputs(B * S + R, B, S, R)
    y, h = krs.rglru_scan(*_t(a, bx))
    pal, _ = jax_rglru_scan(*_j(a, bx), block_t=32, block_r=64)
    want, hw = ref.rglru_scan(*_j(a, bx))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert _err(y, pal) < SCAN_TOL and _err(y, want) < SCAN_TOL
    assert _err(h, hw) < SCAN_TOL
    y_ref, h_ref = krs.rglru_scan_ref(*_t(a, bx))        # the wrapper's CPU path
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_with_h0_and_out_dtype(out_dtype):
    """h0 starts the recurrence; h_last is the float32 state, not the
    rounded y[:, -1]."""
    a, bx, h0 = _scan_inputs(7, 2, 150, 100)
    y, h = krs.rglru_scan(*_t(a, bx, h0), out_dtype=out_dtype)
    want, hw = ref.rglru_scan(*_j(a, bx, h0))
    assert y.dtype == out_dtype and h.dtype == torch.float32
    assert _err(h, hw) < SCAN_TOL
    tol = SCAN_TOL if out_dtype == torch.float32 else 5e-2
    assert _err(y.float(), want) < tol


def test_rglru_scan_state_carry():
    """Two calls with the state carried between them equal one call."""
    a, bx, h0 = _scan_inputs(8, 2, 90, 48)
    ta, tb, th = _t(a, bx, h0)
    y, h = krs.rglru_scan(ta, tb, th)
    y1, h1 = krs.rglru_scan(ta[:, :37], tb[:, :37], th)
    y2, h2 = krs.rglru_scan(ta[:, 37:], tb[:, 37:], h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)


# ---------------------------------------------------------------------------
# mlstm_chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (1, 32, 1, 32, 8), (2, 96, 2, 32, 32), (1, 100, 2, 64, 32),
])
def test_mlstm_chunk_matches_pallas_and_ref(B, S, H, hd, chunk):
    q, k, v, ig, fg = _mlstm_inputs(B * S + hd, B, S, H, hd)
    h, (C, n, m) = kmc.mlstm_chunk(*_t(q, k, v, ig, fg), chunk=chunk)
    pal = jax_mlstm_chunk(*_j(q, k, v, ig, fg), chunk=chunk)
    want, (Cw, nw, mw) = ref.mlstm(*_j(q, k, v, ig, fg))
    assert h.shape == (B, S, H, hd) and h.dtype == torch.float32
    assert _err(h, pal) < MLSTM_TOL and _err(h, want) < MLSTM_TOL
    assert _err(C, Cw) < MLSTM_TOL and _err(n, nw) < MLSTM_TOL
    assert _err(m, mw) < MLSTM_TOL


@pytest.mark.parametrize("S,chunk", [(64, 16), (75, 32), (40, 64)])
def test_mlstm_chunk_state_matches_chunkwise(S, chunk):
    """State in and out with the semantics of the JAX model's
    ``mlstm_chunkwise(..., state)``: a state from a first call goes in,
    h and (C, n, m) come out equal."""
    q, k, v, ig, fg = _mlstm_inputs(S + chunk, 2, S, 2, 32)
    q0, k0, v0, ig0, fg0 = _mlstm_inputs(99, 2, 21, 2, 32)
    _, jst = mlstm_chunkwise(*_j(q0, k0, v0, ig0, fg0), chunk=chunk)
    _, tst = kmc.mlstm_chunk(*_t(q0, k0, v0, ig0, fg0), chunk=chunk)
    for a, b in zip(tst, jst):
        assert _err(a, b) < MLSTM_TOL
    want, (Cw, nw, mw) = mlstm_chunkwise(*_j(q, k, v, ig, fg), jst, chunk=chunk)
    h, (C, n, m) = kmc.mlstm_chunk(*_t(q, k, v, ig, fg), tst, chunk=chunk)
    assert _err(h, want) < MLSTM_TOL
    assert _err(C, Cw) < MLSTM_TOL and _err(n, nw) < MLSTM_TOL
    assert _err(m, mw) < MLSTM_TOL


@pytest.mark.parametrize("S", [5, 23, 64])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mlstm_chunk_invariant_to_chunk_size(S, chunk):
    """Chunk size is a tiling choice: h and the state do not depend on it
    (tests/test_kernels.py:161-173)."""
    x = _t(*_mlstm_inputs(S * 31 + chunk, 1, S, 1, 16, fg_shift=1.0))
    h, st = kmc.mlstm_chunk(*x, chunk=chunk)
    h1, st1 = kmc.mlstm_chunk(*x, chunk=S)
    assert _err(h, h1) < MLSTM_TOL
    for a, b in zip(st, st1):
        assert _err(a, b) < MLSTM_TOL


def test_mlstm_chunk_two_calls_equal_one():
    """Two half-length calls, the state carried between them, equal one
    call (what prefill followed by extend relies on)."""
    q, k, v, ig, fg = _t(*_mlstm_inputs(5, 2, 90, 2, 32))
    h, st = kmc.mlstm_chunk(q, k, v, ig, fg, chunk=16)
    ha, sa = kmc.mlstm_chunk(q[:, :45], k[:, :45], v[:, :45], ig[:, :45],
                             fg[:, :45], chunk=16)
    hb, sb = kmc.mlstm_chunk(q[:, 45:], k[:, 45:], v[:, 45:], ig[:, 45:],
                             fg[:, 45:], sa, chunk=16)
    assert _err(torch.cat([ha, hb], 1), h) < MLSTM_TOL
    for a, b in zip(sb, st):
        assert _err(a, b) < MLSTM_TOL


def test_mlstm_padding_rows_neither_write_nor_decay():
    """ig = -1e30 / fg = 30 rows (the model's prompt padding) leave the
    state as the unpadded prompt leaves it."""
    q, k, v, ig, fg = _t(*_mlstm_inputs(6, 1, 40, 2, 32))
    _, st = kmc.mlstm_chunk(q[:, :29], k[:, :29], v[:, :29], ig[:, :29],
                            fg[:, :29], chunk=16)
    ig, fg = ig.clone(), fg.clone()
    ig[:, 29:], fg[:, 29:] = kmc.NEG_INF, 30.0
    _, st_pad = kmc.mlstm_chunk(q, k, v, ig, fg, chunk=16)
    for a, b in zip(st_pad, st):
        assert _err(a, b) < MLSTM_TOL
