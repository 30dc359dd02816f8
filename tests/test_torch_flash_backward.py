"""The flash backward's contract on the CPU, against the JAX package.

The backward kernels (``csrc/flash_attention_bwd_wgmma.cu``, bf16;
``csrc/flash_attention_bwd.cu``, float32 and the C entry) run only on the
card, where tests/test_torch_gpu.py holds them to their plain versions.
Here, on numpy inputs made with a seed:

* the plain forward's row log-sum-exp (``flash_attention_ref(...,
  return_lse=True)``, the output the forward kernels write for the
  backward) equals ``jax.nn.logsumexp`` of the JAX package's masked,
  scaled scores (float32, 2e-5);
* the plain backward ``flash_attention_bwd``, given that lse and
  recomputing it, equals ``jax.vjp`` of ``repro.models.attention.
  flash_attention`` over ``repeat_kv`` (the XLA path the reference trains
  on) at 2e-5 relative to max(1, the gradient's largest value): GQA G = 4,
  MHA, a window, q_start > 0 with T > S, head dims 16 and 64;
* ``FlashAttention`` hands its saved lse to the backward; the backward
  operator refuses CPU tensors (the wrapper takes the plain version there);
* the C entry points' argument lists equal the wrapper's ctypes
  ``argtypes``; the bf16 backward's tile constants (``BWD_TILE``,
  ``BWD_WIDE_HD``, ``MAX_SPLITS``) equal the kernel source's; the split
  plan of the dK / dV grid;
* the dry run's cost counter answers the backward's operator with
  ``costs.flash_bwd`` at the input's rate.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402

TOL = 2e-5          # float32, as tests/test_kernels.py
CSRC = Path(kfa.__file__).with_name("csrc")

# (B, S, T, H, K, hd, q_start, window)
SHAPES = [
    (2, 40, 40, 8, 2, 16, 0, None),         # GQA, G = 4
    (1, 70, 70, 4, 4, 64, 0, None),         # MHA at hd 64
    (2, 50, 50, 4, 1, 16, 0, 12),           # a window, one KV head
    (1, 24, 60, 8, 2, 16, 30, None),        # q_start > 0, T > S
    (1, 33, 80, 4, 2, 64, 40, 20),          # q_start, T > S and a window
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, T, H, K, hd, seed):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd), (B, S, H, hd))]


def _err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))))


def _jax_scores(q, k, q_start, window):
    """The reference's masked, scaled scores [B, H, S, T] over repeat_kv(k)."""
    S, T, hd = q.shape[1], k.shape[1], q.shape[3]
    kr = jattn.repeat_kv(jnp.asarray(k), q.shape[2] // k.shape[2])
    s = jnp.einsum("bshd,bthd->bhst", jnp.asarray(q), kr) / np.sqrt(hd)
    mask = jattn._block_mask(q_start + jnp.arange(S), jnp.arange(T), window)
    return jnp.where(mask, s, jattn.NEG_INF)


@pytest.mark.parametrize("B,S,T,H,K,hd,q_start,window", SHAPES)
def test_plain_forward_lse_equals_jax_logsumexp(B, S, T, H, K, hd, q_start, window):
    q, k, v, _ = _inputs(B, S, T, H, K, hd, seed=S + T)
    o, lse = kfa.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), q_per_kv=H // K, window=window,
                                     q_start=q_start, return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    want = jax.nn.logsumexp(_jax_scores(q, k, q_start, window), axis=-1)
    assert _err(lse, want) < TOL
    assert torch.equal(o, kfa.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), q_per_kv=H // K,
        window=window, q_start=q_start))


@pytest.mark.parametrize("given_lse", [True, False])
@pytest.mark.parametrize("B,S,T,H,K,hd,q_start,window", SHAPES)
def test_plain_backward_equals_jax_vjp(B, S, T, H, K, hd, q_start, window, given_lse):
    G = H // K
    q, k, v, do = _inputs(B, S, T, H, K, hd, seed=3 * S + T)

    def ref(q_, k_, v_):
        return jattn.flash_attention(
            q_, jattn.repeat_kv(k_, G), jattn.repeat_kv(v_, G), window=window,
            q_positions=q_start + jnp.arange(S, dtype=jnp.int32), block_q=16, block_kv=16)

    _, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(q_per_kv=G, window=window, q_start=q_start)
    o, lse = kfa.flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    got = kfa.flash_attention_bwd(tq, tk, tv, o, torch.from_numpy(do), block=16,
                                  lse=lse if given_lse else None, **kw)
    for name, g, w in zip("qkv", got, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        assert _err(g, w) <= TOL * scale, name


def test_function_hands_its_saved_lse_to_the_backward(monkeypatch):
    seen = []
    real = kfa.flash_attention_bwd

    def spy(*a, lse=None, **kw):
        seen.append(lse)
        return real(*a, lse=lse, **kw)

    monkeypatch.setattr(kfa, "flash_attention_bwd", spy)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 20, 20, 4, 2, 16, seed=5))
    q.requires_grad_()
    o = kfa.flash_attention(q, k, v, q_per_kv=2)
    o.backward(do)
    _, lse = kfa.flash_attention_ref(q.detach(), k, v, q_per_kv=2, return_lse=True)
    assert len(seen) == 1 and torch.equal(seen[0], lse)


def test_backward_operator_refuses_cpu_tensors():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 16, 16, 2, 1, 16, seed=6))
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        torch.ops.repro_torch.flash_attention_bwd(q, k, v, q, do, lse, 2, None, 0)


# ---------------------------------------------------------------------------
# the C entries, constants and the split plan
# ---------------------------------------------------------------------------

_CTYPE = {"void*": "c_void_p", "int": "c_int"}


def _c_signature(source, name):
    text = (CSRC / source).read_text()
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
    args = [a.strip() for a in m.group(1).replace("\n", " ").split(",")]
    types = []
    for a in args:
        t = re.sub(r"\bconst\b", "", a).rsplit(" ", 1)[0].replace(" ", "")
        types.append(_CTYPE["void*" if t.endswith("*") else t])
    return types


@pytest.mark.parametrize("source,name,argtypes", [
    ("flash_attention.cu", "flash_attention_fwd", kfa.FWD_ARGTYPES),
    ("flash_attention_bwd.cu", "flash_attention_bwd", kfa.BWD_ARGTYPES),
])
def test_c_entry_arguments_are_the_wrapper_argtypes(source, name, argtypes):
    assert _c_signature(source, name) == [t.__name__ for t in argtypes]


def test_backward_tile_is_the_kernel_source():
    text = (CSRC / "flash_attention_bwd_wgmma.cu").read_text()
    assert re.findall(r"constexpr int BR = (\d+);", text) == [str(kfa.BWD_TILE)]
    assert re.findall(r"constexpr int WIDE_HD = (\d+);", text) == [str(kfa.BWD_WIDE_HD)]
    assert re.findall(r"constexpr int MAX_SPLITS = (\d+);", text) == [str(kfa.MAX_SPLITS)]
    assert kfa.BWD_ROUTES == {torch.bfloat16: "wgmma_bwd", torch.float32: "simt_f32_bwd"}
    assert set(kfa.launches_by_route) == {"wgmma", "simt_f32", "wgmma_bwd",
                                          "simt_f32_bwd"}


@pytest.mark.parametrize("B,T,K,G,hd,dtype,want", [
    (2, 2048, 2, 8, 128, torch.bfloat16, 4),   # qwen2.5-3b's train microbatch: 128 blocks
    (2, 2048, 1, 16, 256, torch.bfloat16, 4),  # recurrentgemma-9b's: 64 blocks
    (2, 2048, 16, 1, 128, torch.bfloat16, 1),  # MHA: nothing to split
    (8, 2048, 8, 6, 128, torch.bfloat16, 1),   # 1024 blocks cover the card
    (1, 100, 2, 6, 64, torch.bfloat16, 2),     # G = 6: splits divide it
    (2, 2048, 2, 8, 128, torch.float32, 1),    # the float32 route takes none
    (2, 1024, 8, 4, 256, torch.bfloat16, 2),   # 256 blocks, one an SM: one more split
    (2, 1024, 8, 4, 128, torch.bfloat16, 4),   # the same, two blocks an SM
])
def test_backward_split_plan(B, T, K, G, hd, dtype, want):
    assert kfa.bwd_splits(B, T, K, G, hd, dtype) == want


# ---------------------------------------------------------------------------
# the dry run's counter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cost_counter_answers_the_backward_kernel(dtype):
    from repro_torch.launch import cost
    B, S, H, K, hd, window = 2, 256, 8, 2, 64, 100
    q = torch.empty(B, S, H, hd, dtype=dtype, device="meta", requires_grad=True)
    k = torch.empty(B, S, K, hd, dtype=dtype, device="meta", requires_grad=True)
    v = torch.empty(B, S, K, hd, dtype=dtype, device="meta", requires_grad=True)
    with cost.CostCounter() as counter:
        o = kfa.flash_attention(q, k, v, q_per_kv=H // K, window=window)
        torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    res = counter.result()
    assert res["kernels"] == {"flash_attention": 1, "flash_attention_bwd": 1}
    pairs = costs.flash_pairs(S, window=window)
    r, elt = costs.rate(dtype), q.element_size()
    fwd = costs.flash(B, S, S, H, K, hd, elt, pairs, r, lse=True)
    bwd = costs.flash_bwd(B, S, S, H, K, hd, elt, pairs, r)
    assert res["kernel_flops"] == fwd[0][r] + bwd[0][r]
    assert res["range_product_flops"].get("flash_attention_bwd", 0.0) == 0.0
