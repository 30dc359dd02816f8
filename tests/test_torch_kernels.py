"""The port's kernels (repro_torch.kernels) against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the Pallas kernels in interpret mode (and the XLA attention paths)
on the same numpy inputs, at the reference tolerance for float32 (2e-5,
tests/test_kernels.py). The CUDA kernels themselves are held against their
plain versions in tests/test_torch_gpu.py (on the card only).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as pallas_paged  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as kda  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import paged_decode_attention as kpda  # noqa: E402
from repro_torch.kernels import paged_spec_decode_attention as kpsda  # noqa: E402
from repro_torch.kernels import spec_decode_attention as ksda  # noqa: E402
from repro_torch.kernels import spec_scan  # noqa: E402

TOL = 2e-5          # float32, as tests/test_kernels.py


def _rnd(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float32)
                              - np.asarray(want, np.float32))))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,K,hd", [(1, 64, 2, 1, 32), (2, 100, 4, 2, 16),
                                        (1, 130, 4, 4, 64)])
@pytest.mark.parametrize("window", [None, 24])
def test_flash_plain_matches_pallas(B, S, H, K, hd, window):
    rs = np.random.RandomState(S + H)
    q, k, v = _rnd(rs, B, S, H, hd), _rnd(rs, B, S, K, hd), _rnd(rs, B, S, K, hd)
    G = H // K
    # the Pallas kernel takes KV repeated to H heads (repeat_kv order)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(np.repeat(k, G, axis=2)),
                        jnp.asarray(np.repeat(v, G, axis=2)), window=window,
                        block_q=32, block_kv=32)
    got = kfa.flash_attention(_t(q), _t(k), _t(v), q_per_kv=G, window=window)
    assert got.shape == (B, S, H, hd)
    assert _err(got, want) < TOL


@pytest.mark.parametrize("start,S,T,window", [(0, 48, 48, None), (40, 24, 64, None),
                                              (37, 50, 100, None), (30, 20, 64, 16)])
def test_flash_q_start_matches_xla_extend(start, S, T, window):
    """q_start mode == the XLA flash with runtime q_positions (the path the
    JAX package takes for dense and paged extend); keys past the last query
    (stale cache rows) are causally masked."""
    rs = np.random.RandomState(start + S)
    B, H, K, hd = 1, 4, 2, 16
    q, k, v = _rnd(rs, B, S, H, hd), _rnd(rs, B, T, K, hd), _rnd(rs, B, T, K, hd)
    want = jattn.flash_attention(
        jnp.asarray(q), jattn.repeat_kv(jnp.asarray(k), 2),
        jattn.repeat_kv(jnp.asarray(v), 2), window=window,
        q_positions=start + jnp.arange(S, dtype=jnp.int32),
        block_q=16, block_kv=16)
    got = kfa.flash_attention(_t(q), _t(k), _t(v), q_per_kv=2, window=window,
                              q_start=start)
    assert _err(got, want) < TOL


# ---------------------------------------------------------------------------
# decode attention (dense / ring)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,W,K,G,hd", [(1, 64, 1, 1, 32), (3, 200, 2, 4, 32),
                                        (2, 128, 4, 2, 64)])
@pytest.mark.parametrize("vector_clen", [False, True])
def test_decode_plain_matches_pallas(B, W, K, G, hd, vector_clen):
    rs = np.random.RandomState(W + K)
    q = _rnd(rs, B, 1, K * G, hd)
    kc, vc = _rnd(rs, B, W, K, hd), _rnd(rs, B, W, K, hd)
    clen = (np.arange(B, dtype=np.int32) * (W // max(B, 1)) + W // 2 - 1
            if vector_clen else np.int32(W - 1))
    want = pallas_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                         jnp.asarray(clen), q_per_kv=G, block_w=64)
    got = kda.decode_attention(_t(q), _t(kc), _t(vc),
                               _t(clen) if vector_clen else int(clen), q_per_kv=G)
    assert _err(got, want) < TOL


def test_decode_plain_window_ring_matches_pallas():
    """The ring-age window mask (decode_attention.py:47-50) on a wrapped
    ring, the case of tests/test_kernels.py."""
    rs = np.random.RandomState(3)
    B, W, K, G, hd = 2, 64, 2, 2, 32
    q = _rnd(rs, B, 1, K * G, hd)
    kc, vc = _rnd(rs, B, W, K, hd), _rnd(rs, B, W, K, hd)
    clen = np.array([70, 200], np.int32)
    want = pallas_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                         jnp.asarray(clen), q_per_kv=G, window=24, block_w=32)
    got = kda.decode_attention(_t(q), _t(kc), _t(vc), _t(clen), q_per_kv=G,
                               window=24)
    assert _err(got, want) < TOL


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------


def test_paged_plain_matches_pallas():
    """The case of tests/test_paged_kv.py: block tables padded with trash
    page 0, per-row cache lengths."""
    rs = np.random.RandomState(0)
    B, P, ps, K, G, hd = 3, 11, 8, 2, 2, 16
    kpool, vpool = _rnd(rs, P, ps, K, hd), _rnd(rs, P, ps, K, hd)
    q = _rnd(rs, B, 1, K * G, hd)
    bt = np.array([[3, 1, 7, 10], [2, 5, 0, 0], [9, 8, 6, 4]], np.int32)
    clen = np.array([25, 10, 31], np.int32)
    want = pallas_paged(jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool),
                        jnp.asarray(bt), jnp.asarray(clen), q_per_kv=G)
    got = kpda.paged_decode_attention(_t(q), _t(kpool), _t(vpool), _t(bt),
                                      _t(clen), q_per_kv=G)
    assert got.shape == (B, 1, K * G, hd)
    assert _err(got, want) < TOL
    # and it equals the XLA reference the JAX model uses off the TPU
    ref = jattn.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool), jnp.asarray(bt),
        jnp.asarray(clen), q_per_kv=G)
    assert _err(got, ref) < TOL


# ---------------------------------------------------------------------------
# wrappers: the plain version only for CPU tensors, never a fallback
# ---------------------------------------------------------------------------


def _calls(device):
    kw = dict(device=device)
    q = torch.zeros(1, 4, 4, 16, **kw)
    kv = torch.zeros(1, 4, 2, 16, **kw)
    qd = torch.zeros(2, 1, 4, 16, **kw)
    cache = torch.zeros(2, 8, 2, 16, **kw)
    pool = torch.zeros(3, 4, 2, 16, **kw)
    bt = torch.zeros(2, 2, dtype=torch.int32, **kw)
    clen = torch.ones(2, dtype=torch.int32, **kw)
    qs = torch.zeros(2, 3, 4, 16, **kw)
    acc = torch.ones(2, 3, dtype=torch.bool, **kw)
    return [
        (kfa, lambda: kfa.flash_attention(q, kv, kv, q_per_kv=2)),
        (kda, lambda: kda.decode_attention(qd, cache, cache, clen, q_per_kv=2)),
        (kpda, lambda: kpda.paged_decode_attention(qd, pool, pool, bt, clen,
                                                   q_per_kv=2)),
        (spec_scan, lambda: spec_scan.accept_len(acc, clen)),
        (ksda, lambda: ksda.spec_decode_attention(qs, cache, cache, clen, q_per_kv=2)),
        (kpsda, lambda: kpsda.paged_spec_decode_attention(qs, pool, pool, bt, clen,
                                                          q_per_kv=2)),
    ]


@pytest.mark.parametrize("i", range(6))
def test_wrapper_cpu_runs_plain_version_uncounted(i):
    mod, call = _calls("cpu")[i]
    before = mod.launches
    out = call()
    assert out.device.type == "cpu" and torch.isfinite(out.float()).all()
    assert mod.launches == before          # a plain-version call is no launch


@pytest.mark.parametrize("i", range(6))
def test_wrapper_refuses_other_devices(i):
    """A tensor on neither the CPU nor a card raises; nothing falls back."""
    mod, call = _calls("meta")[i]
    with pytest.raises(ValueError, match="unsupported device"):
        call()


def test_flash_routes_by_dtype_and_cpu_counts_none():
    """bf16 launches the tensor-core route, float32 the CUDA-core route (a
    dispatch on type); the plain version on the CPU counts on neither."""
    assert kfa.ROUTES == {torch.bfloat16: "wgmma", torch.float32: "simt_f32"}
    before = dict(kfa.launches_by_route)
    for dtype in kfa.ROUTES:
        q = torch.zeros(1, 4, 2, 16, dtype=dtype)
        kfa.flash_attention(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous(),
                            q_per_kv=2)
    assert kfa.launches_by_route == before


def test_build_commands_target_sm90a():
    """The kernels are built by nvcc by hand for sm_90a, one compile per
    source and one shared-library link."""
    from pathlib import Path
    cmds, link, lib = build.compile_commands(Path("/tmp/out"))
    srcs = {Path(c[c.index("-c") + 1]).name for c in cmds}
    assert srcs == {"flash_attention.cu", "flash_attention_wgmma.cu",
                    "flash_attention_bwd.cu", "flash_attention_bwd_wgmma.cu",
                    "split_decode_attention.cu", "spec_scan.cu",
                    "rglru_scan.cu", "mlstm_chunk.cu", "mlstm_chunk_wgmma.cu",
                    "mlstm_chunk_bwd.cu", "mlstm_chunk_bwd_wgmma.cu",
                    "decode_loop.cu", "slstm_scan.cu"}
    for c in cmds + [link]:
        assert "arch=compute_90a,code=sm_90a" in c
    assert "-shared" in link and lib.suffix == ".so"
    assert build.digest() in lib.name
