"""The split-K plan of the port's decode kernels, on the CPU.

The CUDA kernels (csrc/split_decode_attention.cu) serve the four decode
forms: a dense (ring) cache or a paged pool, one query token or the S of a
verify step. They cut each row's slots at fixed absolute boundaries, every
``SPLIT`` slots, write float32 partials (m, l, acc) per split and merge them
in split order with the log-sum-exp rescale. The kernels run only on the
card (tests/test_torch_gpu.py); here the wrapper's scratch plan is checked,
and a split-and-combine model written in this file, on inputs made from a
numpy seed, is held against the port's plain versions and the JAX package's
references (float32, 1e-6): the split boundaries, the ring-age window mask
and the combine do not change the function, a split the window masks whole
is weighted zero, and the S-query form computed the same way equals S
one-token results.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import decode_attention as kda  # noqa: E402
from repro_torch.kernels import paged_decode_attention as kpda  # noqa: E402
from repro_torch.kernels import paged_spec_decode_attention as kpsda  # noqa: E402
from repro_torch.kernels import spec_decode_attention as ksda  # noqa: E402
from repro_torch.kernels import split_decode as ksd  # noqa: E402
from repro_torch.kernels.flash_attention import NEG_INF  # noqa: E402

TOL = 1e-6


def split_partials(qg, k_rows, v_rows, keep, n_valid, split=ksd.SPLIT):
    """One (row, query, KV head) of the split kernel: qg [G, hd] against
    slots [0, n_valid) of k_rows / v_rows [n_pos, hd]; scores of slots
    ``keep`` rejects are NEG_INF, as in the kernel. Returns the float32
    (m [G], l [G], acc [G, hd]) of each split [j * split, (j + 1) * split)."""
    parts = []
    for j0 in range(0, n_valid, split):
        j1 = min(j0 + split, n_valid)
        sc = qg @ k_rows[j0:j1].T / math.sqrt(qg.shape[-1])          # [G, n]
        sc = torch.where(keep[j0:j1], sc, NEG_INF)
        m = sc.max(-1).values
        p = torch.exp(sc - m[:, None])
        parts.append((m, p.sum(-1), p @ v_rows[j0:j1]))
    return parts


def combine(parts):
    """The combine kernel: the log-sum-exp merge in split order."""
    mm = torch.stack([m for m, _, _ in parts]).max(0).values
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        w = torch.exp(m - mm)
        num += acc * w[:, None]
        den += l * w
    return num / den[:, None]


def kept_slots(clen, n_pos, window):
    """Slots a query at cache length clen attends: below n_valid and, with a
    window, of ring age below min(window, n_valid + 1)."""
    pos = torch.arange(n_pos)
    n_valid = min(clen + 1, n_pos)
    keep = pos < n_valid
    if window is not None:
        age = clen % n_pos - pos
        age = torch.where(age < 0, age + n_pos, age)
        keep &= age < min(window, n_valid + 1)
    return keep, n_valid


def split_combine(q, k_rows, v_rows, cache_len, q_per_kv, window=None):
    """Model of the kernels: q [B, S, H, hd] (query s at cache_len + s)
    against slot-ordered rows [B, n_pos, K, hd] (a dense (ring) cache, or a
    paged pool's gathered view): per (row, query, KV head), the partials of
    each split of the live slots, then their merge."""
    B, S, H, hd = q.shape
    n_pos, K = k_rows.shape[1], k_rows.shape[2]
    out = torch.empty(B, S, H, hd)
    for b in range(B):
        for s in range(S):
            keep, n_valid = kept_slots(int(cache_len[b]) + s, n_pos, window)
            for kh in range(K):
                heads = slice(kh * q_per_kv, (kh + 1) * q_per_kv)
                out[b, s, heads] = combine(split_partials(
                    q[b, s, heads], k_rows[b, :, kh], v_rows[b, :, kh], keep,
                    n_valid))
    return out


def paged_view(pool, bt):
    """[B, nw * ps, K, hd]: each row's pages in position order."""
    g = pool[bt.long()]
    return g.reshape((g.shape[0], -1) + tuple(pool.shape[2:]))


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
    n, acc, ml = ksd.split_plan(B, S, K, G, hd, nw * ps)
    assert n == math.ceil(nw * ps / ksd.SPLIT) and (n - 1) * ksd.SPLIT < nw * ps
    assert acc == (B, S, K, G, n, hd) and ml == (B, S, K, G, n, 2)


def test_split_is_whole_pages_of_the_servers_page_size():
    """SPLIT is a fixed multiple of the paged server's page size (16), so a
    split boundary never depends on the batch, the row or S, nor on the
    cache's layout: a dense cache of W slots splits as a table of W / 16
    pages."""
    assert ksd.SPLIT % 16 == 0 and ksd.SPLIT // 16 == 8
    # boundaries of one row are the same however many query positions ride on it
    for s in (1, 5, 9):
        n, _, _ = ksd.split_plan(1, s, 2, 8, 128, 128 * 16)
        assert n == 16
        assert ksd.split_plan(4, s, 1, 16, 256, 2048)[0] == 16


@pytest.mark.parametrize("name", ["SPLIT", "MAX_G"])
def test_wrapper_constants_are_the_kernel_sources(name):
    """The wrapper sizes the scratch and checks q_per_kv with its own SPLIT
    and MAX_G; the kernel source fixes them as constexpr. They are one value."""
    src = (Path(ksd.__file__).with_name("csrc") / "split_decode_attention.cu").read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", src)
    assert found == [str(getattr(ksd, name))]


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
    tb = torch.from_numpy(bt)
    got = split_combine(torch.from_numpy(q), paged_view(torch.from_numpy(pk), tb),
                        paged_view(torch.from_numpy(pv), tb), cl, G)
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
    kv, vv = paged_view(tk, tb), paged_view(tv, tb)
    got = split_combine(tq, kv, vv, cl, G)
    steps = torch.cat([split_combine(tq[:, s:s + 1], kv, vv, cl + s, G)
                       for s in range(S)], dim=1)
    assert torch.equal(got, steps)
    want = kpsda.paged_spec_attention_ref(tq, tk, tv, tb, torch.from_numpy(cl),
                                          q_per_kv=G)
    assert _err(got, want) < TOL


# ---------------------------------------------------------------------------
# the dense (ring) cache: one-token decode with and without a window, and
# the verify step's S queries
# ---------------------------------------------------------------------------


def _dense_inputs(seed, B, S, W, K, G, hd):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((B, S, K * G, hd)).astype(np.float32)
    kc = rs.standard_normal((B, W, K, hd)).astype(np.float32)
    vc = rs.standard_normal((B, W, K, hd)).astype(np.float32)
    return q, kc, vc


@pytest.mark.parametrize("case", [
    # (K, G, hd, W, window, cache_len per row); SPLIT = 128
    (2, 4, 32, 512, None, [127, 128, 511, 0]),    # SPLIT - 1, SPLIT, W - 1, 0
    (2, 4, 32, 512, 24, [127, 128, 511, 0]),      # the window masks whole splits
    (1, 8, 64, 512, 24, [1000, 600, 1023, 513]),  # wrapped ring, masked splits
    (1, 16, 64, 256, 256, [300, 100, 255, 511]),  # window == W (recurrentgemma)
    (2, 2, 16, 384, 200, [700, 383, 130, 90]),    # window across a boundary
    (4, 1, 16, 200, None, [199, 5, 130, 127]),    # W not a whole split, MHA
])
def test_split_combine_matches_dense_references(case):
    """One query token against a dense (ring) cache: the split-and-combine
    model with the ring-age window mask equals the port's plain version,
    the JAX package's reference and its Pallas kernel in interpret mode
    (float32, 1e-6)."""
    K, G, hd, W, window, clen = case
    q, kc, vc = _dense_inputs(W + sum(clen), len(clen), 1, W, K, G, hd)
    cl = np.asarray(clen, np.int32)
    tq, tk, tv = map(torch.from_numpy, (q, kc, vc))
    got = split_combine(tq, tk, tv, cl, G, window=window)
    port = kda.decode_attention_ref(tq, tk, tv, torch.from_numpy(cl), q_per_kv=G,
                                    window=window)
    jq, jk, jv, jc = map(jnp.asarray, (q, kc, vc, cl))
    jax_ref = jref.decode_attention(jq, jk, jv, jc, q_per_kv=G, window=window)
    pallas = pallas_decode(jq, jk, jv, jc, q_per_kv=G, window=window)
    assert _err(got, port) < TOL
    assert _err(got, jax_ref) < TOL
    assert _err(got, pallas) < TOL


@pytest.mark.parametrize("clen", [1000, 511])
def test_window_masked_split_is_weighted_zero(clen):
    """W = 512, window 24: the slots the query sees lie in one split, so the
    splits before it score NEG_INF everywhere. Such a split's partials are
    m = NEG_INF (finite) with l > 0 and a finite acc, and the combine weights
    it by e^{m - M} = 0: the result is the reference's."""
    W, K, G, hd, window = 512, 1, 4, 32, 24
    q, kc, vc = _dense_inputs(clen, 1, 1, W, K, G, hd)
    tq, tk, tv = map(torch.from_numpy, (q, kc, vc))
    keep, n_valid = kept_slots(clen, W, window)
    parts = split_partials(tq[0, 0], tk[0, :, 0], tv[0, :, 0], keep, n_valid)
    live = [j for j in range(len(parts)) if keep[j * ksd.SPLIT:(j + 1) * ksd.SPLIT].any()]
    assert live == [3] and len(parts) == 4
    M = torch.stack([m for m, _, _ in parts]).max(0).values
    assert torch.isfinite(M).all() and (M > NEG_INF).all()
    for m, l, acc in parts[:3]:
        assert (m == NEG_INF).all() and (l > 0).all() and torch.isfinite(acc).all()
        assert (torch.exp(m - M) == 0).all()
    want = kda.decode_attention_ref(tq, tk, tv, clen, q_per_kv=G, window=window)
    assert _err(combine(parts)[None, None], want) < TOL


@pytest.mark.parametrize("S,clen", [
    (5, [124, 126, 127, 0]),        # the S queries straddle the first boundary
    (5, [250, 251, 60, 3]),         # the second boundary
    (3, [509, 0, 127, 128]),        # up to the cache's last slot
])
def test_split_combine_dense_multi_query_equals_steps(S, clen):
    """Dense verify: the S-query form of the model equals S one-token
    results at cache lengths clen + s bit for bit, the port's plain
    multi-query version and the JAX package's spec_attention to 1e-6."""
    W, K, G, hd = 512, 2, 4, 32
    q, kc, vc = _dense_inputs(S + sum(clen), len(clen), S, W, K, G, hd)
    cl = np.asarray(clen, np.int32)
    tq, tk, tv = map(torch.from_numpy, (q, kc, vc))
    got = split_combine(tq, tk, tv, cl, G)
    steps = torch.cat([split_combine(tq[:, s:s + 1], tk, tv, cl + s, G)
                       for s in range(S)], dim=1)
    assert torch.equal(got, steps)
    want = ksda.spec_attention_ref(tq, tk, tv, torch.from_numpy(cl), q_per_kv=G)
    assert _err(got, want) < TOL
    jax_ref = jattn.spec_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(cl), q_per_kv=G)
    assert _err(got, jax_ref) < TOL
