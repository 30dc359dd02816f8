"""The split-K plan of the port's paged decode kernels, on the CPU.

The CUDA kernels (csrc/paged_decode_attention.cu) cut each row's positions
at fixed absolute boundaries, every ``SPLIT`` positions, write float32
partials (m, l, acc) per split and merge them in split order with the
log-sum-exp rescale. The kernels run only on the card
(tests/test_torch_gpu.py); here the wrapper's scratch plan is checked, and
a split-and-combine model written in this file, on inputs made from a
numpy seed, is held against the port's plain versions and the JAX
package's paged reference (float32, 1e-6): the split boundaries and the
combine do not change the function, and the S-query form computed the same
way equals S one-token results.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import paged_decode_attention as kpda  # noqa: E402
from repro_torch.kernels import paged_spec_decode_attention as kpsda  # noqa: E402

TOL = 1e-6


def split_combine(q, pool_k, pool_v, bt, cache_len, q_per_kv, split=kpda.SPLIT):
    """Model of the kernels: q [B, S, H, hd] (query s at cache_len + s),
    pools [P, ps, K, hd], bt [B, nw]. Per (row, query, KV head): float32
    (m, l, acc) over each split [j * split, (j + 1) * split) ∩ [0, n_valid),
    then the log-sum-exp merge in split order."""
    B, S, H, hd = q.shape
    ps, K = pool_k.shape[1], pool_k.shape[2]
    nw = bt.shape[1]
    out = torch.empty(B, S, H, hd)
    for b in range(B):
        pages = bt[b].long()
        kview = pool_k[pages].reshape(nw * ps, K, hd)
        vview = pool_v[pages].reshape(nw * ps, K, hd)
        for s in range(S):
            n_valid = min(int(cache_len[b]) + s + 1, nw * ps)
            for kh in range(K):
                qg = q[b, s, kh * q_per_kv:(kh + 1) * q_per_kv]      # [G, hd]
                parts = []
                for j0 in range(0, n_valid, split):
                    j1 = min(j0 + split, n_valid)
                    sc = qg @ kview[j0:j1, kh].T / math.sqrt(hd)      # [G, n]
                    m = sc.max(-1).values
                    p = torch.exp(sc - m[:, None])
                    parts.append((m, p.sum(-1), p @ vview[j0:j1, kh]))
                mm = torch.stack([m for m, _, _ in parts]).max(0).values
                num = torch.zeros(q_per_kv, hd)
                den = torch.zeros(q_per_kv)
                for m, l, acc in parts:
                    w = torch.exp(m - mm)
                    num += acc * w[:, None]
                    den += l * w
                out[b, s, kh * q_per_kv:(kh + 1) * q_per_kv] = num / den[:, None]
    return out


def _inputs(seed, B, S, K, G, hd, ps, nw, cache_len, P=None):
    rs = np.random.RandomState(seed)
    P = P or B * nw + 1
    pool_k = rs.standard_normal((P, ps, K, hd)).astype(np.float32)
    pool_v = rs.standard_normal((P, ps, K, hd)).astype(np.float32)
    q = rs.standard_normal((B, S, K * G, hd)).astype(np.float32)
    bt = (rs.permutation(P - 1)[:B * nw] + 1).reshape(B, nw).astype(np.int32)
    clen = np.asarray(cache_len, np.int32)
    for b, c in enumerate(clen):                # trash page 0 past the live ones
        bt[b, -(-(int(c) + S) // ps):] = 0
    return q, pool_k, pool_v, bt, clen


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


@pytest.mark.parametrize("B,S,K,G,hd,nw,ps", [
    (4, 1, 2, 8, 128, 128, 16),     # qwen2.5-3b, the paged server's table
    (4, 5, 2, 8, 128, 128, 16),     # its verify step (spec_len 4)
    (1, 1, 1, 16, 256, 256, 16),    # MQA at hd 256
    (3, 2, 2, 2, 16, 4, 8),         # not a whole split
    (2, 1, 8, 4, 64, 9, 16),        # 144 positions: two splits, the second short
    (1, 3, 4, 1, 32, 24, 16),       # 384 positions: exactly three splits
])
def test_split_plan_shapes(B, S, K, G, hd, nw, ps):
    n, acc, ml = kpda.split_plan(B, S, K, G, hd, nw, ps)
    assert n == math.ceil(nw * ps / kpda.SPLIT) and (n - 1) * kpda.SPLIT < nw * ps
    assert acc == (B, S, K, G, n, hd) and ml == (B, S, K, G, n, 2)


def test_split_is_whole_pages_of_the_servers_page_size():
    """SPLIT is a fixed multiple of the paged server's page size (16), so a
    split boundary never depends on the batch, the row or S."""
    assert kpda.SPLIT % 16 == 0 and kpda.SPLIT // 16 == 8
    # boundaries of one row are the same however many query positions ride on it
    for s in (1, 5, 9):
        n, _, _ = kpda.split_plan(1, s, 2, 8, 128, 128, 16)
        assert n == 16


@pytest.mark.parametrize("name", ["SPLIT", "MAX_G"])
def test_wrapper_constants_are_the_kernel_sources(name):
    """The wrapper sizes the scratch and checks q_per_kv with its own SPLIT
    and MAX_G; the kernel source fixes them as constexpr. They are one value."""
    src = (Path(kpda.__file__).with_name("csrc") / "paged_decode_attention.cu").read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", src)
    assert found == [str(getattr(kpda, name))]


@pytest.mark.parametrize("case", [
    # (K, G, hd, ps, nw, cache_len per row); SPLIT = 128
    (2, 8, 128, 16, 16, [0, 15, 127, 128]),      # 0, ps - 1, SPLIT - 1, SPLIT
    (2, 8, 128, 16, 16, [255, 129, 200, 17]),    # nw * ps - 1, past a boundary
    (1, 4, 64, 8, 40, [319, 256, 1, 300]),       # page size 8, 2.5 splits
    (2, 2, 16, 16, 24, [383, 250, 130, 64]),     # three whole splits
    (4, 1, 32, 32, 10, [5, 319, 160, 96]),       # page size 32, MHA
])
def test_split_combine_matches_paged_references(case):
    """One query token: the split-and-combine model equals the port's plain
    version and the JAX package's paged reference (float32, 1e-6)."""
    K, G, hd, ps, nw, clen = case
    q, pk, pv, bt, cl = _inputs(sum(clen), len(clen), 1, K, G, hd, ps, nw, clen)
    got = split_combine(torch.from_numpy(q), torch.from_numpy(pk),
                        torch.from_numpy(pv), torch.from_numpy(bt), cl, G)
    port = kpda.paged_decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(bt), torch.from_numpy(cl), q_per_kv=G)
    jax_ref = jattn.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt),
        jnp.asarray(cl), q_per_kv=G)
    assert _err(got, port) < TOL
    assert _err(got, jax_ref) < TOL


@pytest.mark.parametrize("S,clen", [
    (5, [124, 126, 127, 0]),        # the S positions straddle the first boundary
    (5, [250, 251, 60, 3]),         # the second boundary
    (3, [253, 0, 127, 128]),        # up to the table's last position
])
def test_split_combine_multi_query_equals_steps(S, clen):
    """The S-query form of the model equals S one-token results at cache
    lengths clen + s bit for bit, and the port's plain multi-query version
    to 1e-6: split boundaries do not move with S."""
    K, G, hd, ps, nw = 2, 4, 64, 16, 16
    q, pk, pv, bt, cl = _inputs(S + sum(clen), len(clen), S, K, G, hd, ps, nw,
                                clen)
    tq, tk, tv, tb = map(torch.from_numpy, (q, pk, pv, bt))
    got = split_combine(tq, tk, tv, tb, cl, G)
    steps = torch.cat([split_combine(tq[:, s:s + 1], tk, tv, tb, cl + s, G)
                       for s in range(S)], dim=1)
    assert torch.equal(got, steps)
    want = kpsda.paged_spec_attention_ref(tq, tk, tv, tb, torch.from_numpy(cl),
                                          q_per_kv=G)
    assert _err(got, want) < TOL
