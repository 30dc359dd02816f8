"""The port's CUDA kernels on the card (tests marked ``gpu``).

Each kernel against its plain PyTorch version at the tolerances of
tests/test_kernels.py (float32 2e-5, bf16 2e-2; the stateful kernels 5e-6 /
2e-5 / 5e-2), the port's model and server (speculative decode and the
stateful archs' snapshot mode included) on the card against the same code
on the CPU (plain versions), the decode and verify steps as replayed CUDA graphs
against the same steps run eagerly on the card, and the robustness layers
on graphs: a two-replica fleet with a pump per replica, preempt-resume,
journal restore, and a transient fault ahead of the first capture; the
modality archs' kernel geometries (MHA at head dim 64) and servers;
the FAME quickstart on a reduced bf16 server; the sLSTM scan's forward
and gradient kernels against the plain loop (float32 and bf16, masks,
states, the verify record, bit-identical repeats, a graph replay);
training: the gradients of
the flash, rglru_scan and mlstm_chunk wrappers (their
autograd.Functions: the kernel forward; flash's and
mLSTM's backwards are their backward kernels on the dtype's route, the
scan's its gradient kernel, each bit-identical from call to call) against
plain autograd, the split-K decode forms refusing a gradient, and train steps
of qwen, recurrentgemma and xlstm on the card against the CPU. This file
imports no JAX, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test skips: a CUDA kernel has no CPU mode.
"""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import threading  # noqa: E402

from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.kernels import decode_attention as kda  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels import mlstm_chunk as kmc  # noqa: E402
from repro_torch.kernels import paged_decode_attention as kpda  # noqa: E402
from repro_torch.kernels import paged_spec_decode_attention as kpsda  # noqa: E402
from repro_torch.kernels import rglru_scan as krs  # noqa: E402
from repro_torch.kernels import slstm_scan as kss  # noqa: E402
from repro_torch.kernels import spec_decode_attention as ksda  # noqa: E402
from repro_torch.kernels import spec_scan  # noqa: E402
from repro_torch.kernels import split_decode as ksd  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.serving import kvpool  # noqa: E402
from repro_torch.serving.faults import FaultInjector, TransientFault  # noqa: E402
from repro_torch.serving.fleet import FleetServer  # noqa: E402
from repro_torch.serving.scheduler import OverloadPolicy  # noqa: E402
from repro_torch.serving.server import EngineConfig, LLMServer, SamplingParams  # noqa: E402


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (sm_90a) and nvcc: the CUDA kernels "
                    "have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


GPU_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_start,window", [(0, None), (37, None), (20, 16)])
def test_gpu_flash_kernel_matches_plain(dtype, q_start, window):
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(1)
    S, T = 70, 107 + q_start
    q = torch.randn(2, S, 8, 64, generator=g, device=dev).to(dtype)
    k = torch.randn(2, T, 2, 64, generator=g, device=dev).to(dtype)
    v = torch.randn(2, T, 2, 64, generator=g, device=dev).to(dtype)
    before = kfa.launches
    got = kfa.flash_attention(q, k, v, q_per_kv=4, window=window, q_start=q_start)
    torch.cuda.synchronize()
    assert kfa.launches == before + 1
    want = kfa.flash_attention_ref(q, k, v, q_per_kv=4, window=window,
                                   q_start=q_start)
    assert float((got.float() - want.float()).abs().max()) < GPU_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,H,K,hd,q_start,window", [
    (1, 100, 100, 4, 4, 16, 0, None),       # GQA ratio 1, hd 16
    (2, 70, 107, 8, 2, 32, 37, None),       # T = q_start + S, not tile multiples
    (1, 130, 130, 8, 1, 64, 0, 24),         # window narrower than a tile
    (2, 200, 200, 16, 2, 128, 0, 100),      # GQA 8, window wider than a tile
    (1, 65, 193, 16, 2, 128, 128, None),    # extend: q_start 128
    (1, 300, 300, 16, 1, 256, 0, 48),       # K = 1 at hd 256 (GQA 16), window
    (1, 77, 300, 16, 1, 256, 223, None),    # extend at hd 256
])
def test_gpu_flash_wgmma_route_matches_plain(B, S, T, H, K, hd, q_start, window):
    """The bf16 tensor-core route against the plain version (2e-2) over
    head dims 16-256, ragged S and T, q_start, windows and GQA ratios 1, 8,
    16; it counts on the wgmma route and on no other."""
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(S + T + hd)
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, T, K, hd, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, T, K, hd, generator=g, device=dev).to(torch.bfloat16)
    before = dict(kfa.launches_by_route)
    got = kfa.flash_attention(q, k, v, q_per_kv=H // K, window=window,
                              q_start=q_start)
    torch.cuda.synchronize()
    assert kfa.launches_by_route == {**before, "wgmma": before["wgmma"] + 1}
    want = kfa.flash_attention_ref(q, k, v, q_per_kv=H // K, window=window,
                                   q_start=q_start)
    assert float((got.float() - want.float()).abs().max()) < GPU_TOL[torch.bfloat16]
    q32, k32, v32 = q.float(), k.float(), v.float()
    kfa.flash_attention(q32, k32, v32, q_per_kv=H // K, window=window,
                        q_start=q_start)
    torch.cuda.synchronize()
    assert kfa.launches_by_route["simt_f32"] == before["simt_f32"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G", [(128, 8), (256, 16), (16, 2)])
def test_gpu_paged_split_kernel_at_split_edges(dtype, hd, G):
    """Split-K paged decode at cache lengths 0, ps - 1, SPLIT - 1, SPLIT
    and nw * ps - 1, trash-page padding: the plain version's result, and
    two calls give identical bits."""
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(hd + G)
    ps, nw, P = 16, 20, 120
    split = ksd.SPLIT
    clen = torch.tensor([0, ps - 1, split - 1, split, nw * ps - 1], dtype=torch.int32,
                        device=dev)
    B = clen.shape[0]
    kp = torch.randn(P, ps, 2, hd, generator=g, device=dev).to(dtype)
    vp = torch.randn(P, ps, 2, hd, generator=g, device=dev).to(dtype)
    q = torch.randn(B, 1, 2 * G, hd, generator=g, device=dev).to(dtype)
    bt = torch.randperm(P - 1, generator=g, device=dev)[:B * nw].add(1).reshape(B, nw)
    bt = bt.to(torch.int32)
    for b, c in enumerate(clen.tolist()):           # trash-page padding
        bt[b, -(-(c + 1) // ps):] = 0
    before = kpda.launches
    got = kpda.paged_decode_attention(q, kp, vp, bt, clen, q_per_kv=G)
    again = kpda.paged_decode_attention(q, kp, vp, bt, clen, q_per_kv=G)
    torch.cuda.synchronize()
    assert kpda.launches == before + 2
    want = kpda.paged_decode_attention_ref(q, kp, vp, bt, clen, q_per_kv=G)
    assert float((got.float() - want.float()).abs().max()) < GPU_TOL[dtype]
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clen", [[124, 126, 127], [252, 250, 0]])
def test_gpu_paged_spec_straddling_a_split_equals_steps(dtype, clen):
    """The S = 5 verify form whose positions straddle a split boundary
    equals 5 one-token calls bit for bit, and its plain version."""
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(sum(clen))
    S, ps, nw, P = 5, 16, 20, 70
    kp = torch.randn(P, ps, 2, 128, generator=g, device=dev).to(dtype)
    vp = torch.randn(P, ps, 2, 128, generator=g, device=dev).to(dtype)
    q = torch.randn(3, S, 16, 128, generator=g, device=dev).to(dtype)
    bt = torch.randperm(P - 1, generator=g, device=dev)[:3 * nw].add(1).reshape(3, nw)
    bt = bt.to(torch.int32)
    cl = torch.tensor(clen, dtype=torch.int32, device=dev)
    for b, c in enumerate(clen):
        bt[b, -(-(c + S) // ps):] = 0
    got = kpsda.paged_spec_decode_attention(q, kp, vp, bt, cl, q_per_kv=8)
    steps = [kpda.paged_decode_attention(q[:, s:s + 1].contiguous(), kp, vp, bt,
                                         cl + s, q_per_kv=8) for s in range(S)]
    torch.cuda.synchronize()
    assert torch.equal(got, torch.cat(steps, dim=1))
    want = kpsda.paged_spec_attention_ref(q, kp, vp, bt, cl, q_per_kv=8)
    assert float((got.float() - want.float()).abs().max()) < GPU_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,G,hd", [(2, 8, 128), (1, 16, 256), (2, 2, 16),
                                    (4, 4, 64), (1, 16, 32)])
@pytest.mark.parametrize("window", [None, 24, 320])
def test_gpu_dense_split_kernel_at_split_edges(dtype, K, G, hd, window):
    """Split-K dense decode at cache lengths 0, SPLIT - 1, SPLIT, W - 1 and
    a wrapped ring (W = 320, two and a half splits), with no window, one
    that masks whole splits and one as wide as the ring: the plain
    version's result, and two calls give identical bits."""
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(hd + G + (window or 0))
    W, split = 320, ksd.SPLIT
    clen = torch.tensor([0, split - 1, split, W - 1, 3 * W + 70], dtype=torch.int32,
                        device=dev)
    B = clen.shape[0]
    kc = torch.randn(B, W, K, hd, generator=g, device=dev).to(dtype)
    vc = torch.randn(B, W, K, hd, generator=g, device=dev).to(dtype)
    q = torch.randn(B, 1, K * G, hd, generator=g, device=dev).to(dtype)
    before = kda.launches
    got = kda.decode_attention(q, kc, vc, clen, q_per_kv=G, window=window)
    again = kda.decode_attention(q, kc, vc, clen, q_per_kv=G, window=window)
    torch.cuda.synchronize()
    assert kda.launches == before + 2
    want = kda.decode_attention_ref(q, kc, vc, clen, q_per_kv=G, window=window)
    assert float((got.float() - want.float()).abs().max()) < GPU_TOL[dtype]
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clen", [[124, 126, 127], [252, 250, 0]])
def test_gpu_dense_spec_straddling_a_split_equals_steps(dtype, clen):
    """The dense S = 5 verify form whose queries straddle a split boundary
    equals 5 one-token calls bit for bit, and its plain version."""
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(sum(clen) + 1)
    S, W = 5, 320
    kc = torch.randn(3, W, 2, 128, generator=g, device=dev).to(dtype)
    vc = torch.randn(3, W, 2, 128, generator=g, device=dev).to(dtype)
    q = torch.randn(3, S, 16, 128, generator=g, device=dev).to(dtype)
    cl = torch.tensor(clen, dtype=torch.int32, device=dev)
    got = ksda.spec_decode_attention(q, kc, vc, cl, q_per_kv=8)
    steps = [kda.decode_attention(q[:, s:s + 1].contiguous(), kc, vc, cl + s,
                                  q_per_kv=8) for s in range(S)]
    torch.cuda.synchronize()
    assert torch.equal(got, torch.cat(steps, dim=1))
    want = ksda.spec_attention_ref(q, kc, vc, cl, q_per_kv=8)
    assert float((got.float() - want.float()).abs().max()) < GPU_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 24])
def test_gpu_decode_kernel_matches_plain(dtype, window):
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(3, 1, 8, 128, generator=g, device=dev).to(dtype)
    kc = torch.randn(3, 300, 2, 128, generator=g, device=dev).to(dtype)
    vc = torch.randn(3, 300, 2, 128, generator=g, device=dev).to(dtype)
    clen = torch.tensor([0, 170, 450], dtype=torch.int32, device=dev)
    before = kda.launches
    got = kda.decode_attention(q, kc, vc, clen, q_per_kv=4, window=window)
    torch.cuda.synchronize()
    assert kda.launches == before + 1
    want = kda.decode_attention_ref(q, kc, vc, clen, q_per_kv=4, window=window)
    assert float((got.float() - want.float()).abs().max()) < GPU_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["dense", "paged"])
def test_gpu_mha_split_decode_at_musicgen_heads(dtype, form):
    """musicgen-large's decode geometry: MHA (G = 1, 32 query heads over 32
    KV heads) at head dim 64, at cache lengths 0, SPLIT - 1, SPLIT, a page
    edge and the capacity edge: the plain version's result, and two calls
    give identical bits."""
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(64 + (form == "paged"))
    H, hd, ps, T, split = 32, 64, 16, 4 * ksd.SPLIT, ksd.SPLIT
    clen = torch.tensor([0, split - 1, split, 3 * ps - 1, T - 1], dtype=torch.int32,
                        device=dev)
    B = clen.shape[0]
    q = torch.randn(B, 1, H, hd, generator=g, device=dev).to(dtype)
    if form == "dense":
        kc = torch.randn(B, T, H, hd, generator=g, device=dev).to(dtype)
        vc = torch.randn(B, T, H, hd, generator=g, device=dev).to(dtype)
        before = kda.launches
        got = kda.decode_attention(q, kc, vc, clen, q_per_kv=1)
        again = kda.decode_attention(q, kc, vc, clen, q_per_kv=1)
        torch.cuda.synchronize()
        assert kda.launches == before + 2
        want = kda.decode_attention_ref(q, kc, vc, clen, q_per_kv=1)
    else:
        nw = T // ps
        P = B * nw + 1
        kp = torch.randn(P, ps, H, hd, generator=g, device=dev).to(dtype)
        vp = torch.randn(P, ps, H, hd, generator=g, device=dev).to(dtype)
        bt = torch.randperm(P - 1, generator=g, device=dev)[:B * nw].add(1)
        bt = bt.reshape(B, nw).to(torch.int32)
        for b, c in enumerate(clen.tolist()):       # trash-page padding
            bt[b, -(-(c + 1) // ps):] = 0
        before = kpda.launches
        got = kpda.paged_decode_attention(q, kp, vp, bt, clen, q_per_kv=1)
        again = kpda.paged_decode_attention(q, kp, vp, bt, clen, q_per_kv=1)
        torch.cuda.synchronize()
        assert kpda.launches == before + 2
        want = kpda.paged_decode_attention_ref(q, kp, vp, bt, clen, q_per_kv=1)
    assert float((got.float() - want.float()).abs().max()) < GPU_TOL[dtype]
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("S,T,q_start", [(300, 300, 0), (77, 333, 256),
                                         (2048, 2048, 0)])
def test_gpu_flash_wgmma_at_hd64_mha(S, T, q_start):
    """The bf16 wgmma route at musicgen-large's prefill geometry, H = K =
    32 at head dim 64 (one column block of the Geo<64> tile), prefill and
    extend, against the plain version (2e-2); the float32 route at the
    same shapes against it at 2e-5."""
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(S + T)
    q = torch.randn(1, S, 32, 64, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(1, T, 32, 64, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(1, T, 32, 64, generator=g, device=dev).to(torch.bfloat16)
    before = dict(kfa.launches_by_route)
    got = kfa.flash_attention(q, k, v, q_per_kv=1, q_start=q_start)
    torch.cuda.synchronize()
    assert kfa.launches_by_route == {**before, "wgmma": before["wgmma"] + 1}
    want = kfa.flash_attention_ref(q, k, v, q_per_kv=1, q_start=q_start)
    assert float((got.float() - want.float()).abs().max()) < GPU_TOL[torch.bfloat16]
    q32, k32, v32 = q.float(), k.float(), v.float()
    got32 = kfa.flash_attention(q32, k32, v32, q_per_kv=1, q_start=q_start)
    want32 = kfa.flash_attention_ref(q32, k32, v32, q_per_kv=1, q_start=q_start)
    assert float((got32 - want32).abs().max()) < GPU_TOL[torch.float32]


@pytest.mark.gpu
def test_gpu_flash_swa_at_mixtral_prefill_matches_plain():
    """mixtral-8x22b's largest prefill bucket: q [1,8192,48,128], 8 KV heads
    (G = 6), window 4096, bf16. The plain version runs by blocks of 1024
    queries over the keys their window can reach (the same rows; a whole
    [48, 8192, 8192] score matrix would take ~13 GB)."""
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(4)
    S, H, K, hd, win, n = 8192, 48, 8, 128, 4096, 1024
    q = torch.randn(1, S, H, hd, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(1, S, K, hd, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(1, S, K, hd, generator=g, device=dev).to(torch.bfloat16)
    before = kfa.launches_by_route["wgmma"]
    got = kfa.flash_attention(q, k, v, q_per_kv=H // K, window=win)
    torch.cuda.synchronize()
    assert kfa.launches_by_route["wgmma"] == before + 1
    err = 0.0
    for i in range(0, S, n):
        lo = max(0, i - win + 1)
        want = kfa.flash_attention_ref(q[:, i:i + n], k[:, lo:i + n], v[:, lo:i + n],
                                       q_per_kv=H // K, window=win, q_start=i - lo)
        err = max(err, float((got[:, i:i + n].float() - want.float()).abs().max()))
    assert err < GPU_TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_decode_swa_ring_at_mixtral_decode_matches_plain(dtype):
    """mixtral-8x22b's decode step: q [4,1,48,128] over a ring of 4096 slots
    [4,4096,8,128] (G = 6), window 4096, cache lengths before, at and past
    the wrap."""
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(4, 1, 48, 128, generator=g, device=dev).to(dtype)
    kc = torch.randn(4, 4096, 8, 128, generator=g, device=dev).to(dtype)
    vc = torch.randn(4, 4096, 8, 128, generator=g, device=dev).to(dtype)
    clen = torch.tensor([300, 4095, 4097, 8000], dtype=torch.int32, device=dev)
    before = kda.launches
    got = kda.decode_attention(q, kc, vc, clen, q_per_kv=6, window=4096)
    torch.cuda.synchronize()
    assert kda.launches == before + 1
    want = kda.decode_attention_ref(q, kc, vc, clen, q_per_kv=6, window=4096)
    assert float((got.float() - want.float()).abs().max()) < GPU_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_paged_kernel_matches_plain(dtype):
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(3)
    kp = torch.randn(40, 16, 2, 128, generator=g, device=dev).to(dtype)
    vp = torch.randn(40, 16, 2, 128, generator=g, device=dev).to(dtype)
    q = torch.randn(3, 1, 16, 128, generator=g, device=dev).to(dtype)
    bt = torch.randperm(39, generator=g, device=dev)[:24].add(1).reshape(3, 8)
    bt = bt.to(torch.int32)
    bt[1, 2:] = 0                                   # trash-page padding
    clen = torch.tensor([127, 20, 64], dtype=torch.int32, device=dev)
    before = kpda.launches
    got = kpda.paged_decode_attention(q, kp, vp, bt, clen, q_per_kv=8)
    torch.cuda.synchronize()
    assert kpda.launches == before + 1
    want = kpda.paged_decode_attention_ref(q, kp, vp, bt, clen, q_per_kv=8)
    assert float((got.float() - want.float()).abs().max()) < GPU_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(4, 5), (64, 33), (3, 1), (7, 64)])
def test_gpu_accept_len_kernel_matches_plain(B, S):
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(B * 100 + S)
    acc = torch.rand(B, S, generator=g, device=dev) < 0.8
    acc[0] = True                                   # all accept
    if B > 1:
        acc[1] = False                              # all reject
    lens = torch.randint(0, S, (B,), generator=g, device=dev, dtype=torch.int32)
    lens[0] = S - 1
    before = spec_scan.launches
    got = spec_scan.accept_len(acc, lens)
    torch.cuda.synchronize()
    assert spec_scan.launches == before + 1
    assert got.tolist() == spec_scan.accept_len_ref(acc, lens).tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 5])
def test_gpu_spec_decode_kernel_matches_plain(dtype, S):
    """Dense multi-query decode == its plain version, and == S one-token
    decode calls at cache lengths clen + s bit for bit."""
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(3, S, 16, 128, generator=g, device=dev).to(dtype)
    kc = torch.randn(3, 300, 2, 128, generator=g, device=dev).to(dtype)
    vc = torch.randn(3, 300, 2, 128, generator=g, device=dev).to(dtype)
    clen = torch.tensor([0, 170, 298 - S], dtype=torch.int32, device=dev)
    before = ksda.launches
    got = ksda.spec_decode_attention(q, kc, vc, clen, q_per_kv=8)
    torch.cuda.synchronize()
    assert ksda.launches == before + 1
    want = ksda.spec_attention_ref(q, kc, vc, clen, q_per_kv=8)
    assert float((got.float() - want.float()).abs().max()) < GPU_TOL[dtype]
    steps = [kda.decode_attention(q[:, s:s + 1].contiguous(), kc, vc, clen + s,
                                  q_per_kv=8) for s in range(S)]
    assert torch.equal(got, torch.cat(steps, dim=1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 5])
def test_gpu_paged_spec_decode_kernel_matches_plain(dtype, S):
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(5)
    kp = torch.randn(40, 16, 2, 128, generator=g, device=dev).to(dtype)
    vp = torch.randn(40, 16, 2, 128, generator=g, device=dev).to(dtype)
    q = torch.randn(3, S, 16, 128, generator=g, device=dev).to(dtype)
    bt = torch.randperm(39, generator=g, device=dev)[:24].add(1).reshape(3, 8)
    bt = bt.to(torch.int32)
    bt[1, 2:] = 0                                   # trash-page padding
    clen = torch.tensor([120, 20, 64], dtype=torch.int32, device=dev)
    before = kpsda.launches
    got = kpsda.paged_spec_decode_attention(q, kp, vp, bt, clen, q_per_kv=8)
    torch.cuda.synchronize()
    assert kpsda.launches == before + 1
    want = kpsda.paged_spec_attention_ref(q, kp, vp, bt, clen, q_per_kv=8)
    assert float((got.float() - want.float()).abs().max()) < GPU_TOL[dtype]
    steps = [kpda.paged_decode_attention(q[:, s:s + 1].contiguous(), kp, vp, bt,
                                         clen + s, q_per_kv=8) for s in range(S)]
    assert torch.equal(got, torch.cat(steps, dim=1))


# ---------------------------------------------------------------------------
# the model and the server on the card against the same code on the CPU
# ---------------------------------------------------------------------------


def _qwen():
    return ARCHS["qwen2.5-3b"].reduced(dtype="float32", param_dtype="float32",
                                       vocab_size=512)


@pytest.mark.gpu
def test_gpu_model_modes_match_cpu():
    """Prefill, dense extend and decode through the CUDA kernels give the
    CPU's (plain-version) logits within 1e-4, float32."""
    dev = _need_card()
    cfg = _qwen()
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device=dev)
    pc = cpu.init(seed=0)
    pg = gpu.load({k: v.to(dev) for k, v in pc.state_dict().items()})
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, 500, (2, 24), generator=g)
    out = {}
    for name, m, p, d in (("cpu", cpu, pc, "cpu"), ("gpu", gpu, pg, dev)):
        cache = m.init_cache(2, 64)
        l0, _ = m.prefill(p, m.make_batch(toks[:, :16].to(d)), cache, length=16,
                          with_logits="last")
        l1, _ = m.extend(p, m.make_batch(toks[:1, 16:].to(d), start=16),
                         {k: {kk: {n: t[:, :1] for n, t in vv.items()}
                              for kk, vv in v.items()} for k, v in cache.items()},
                         16, length=8, with_logits="all")
        clen = torch.tensor([23, 15], dtype=torch.int32, device=d)
        b = {"tokens": toks[:, 23:24].to(d), "positions": clen[:, None].long()}
        l2, _ = m.decode_step(p, b, cache, clen)
        out[name] = [t.float().cpu() for t in (l0, l1, l2)]
    for a, b in zip(out["cpu"], out["gpu"]):
        assert float((a - b).abs().max()) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_gpu_server_greedy_matches_cpu(mode):
    """LLMServer on the card gives the CPU server's greedy ids (float32,
    same weights), with the kernels launched on the way."""
    dev = _need_card()
    cfg = _qwen()
    sd = Model(cfg, device="cpu").init(seed=1).state_dict()
    sd["embed.table"][cfg.vocab_size - 1] = 0.0        # EOS guard
    prompts = ["alpha prompt for slot one", "third prompt",
               "a rather longer second prompt that crosses a bucket boundary"]
    ids = {}
    for d in ("cpu", dev):
        srv = LLMServer(cfg, num_slots=3, capacity=128, device=d,
                        params={k: v.to(d) for k, v in sd.items()},
                        engine_cfg=EngineConfig(cache_mode=mode, page_size=16,
                                                decode_chunk=4))
        before = (kfa.launches, kda.launches, kpda.launches)
        hs = [srv.submit(p, SamplingParams(max_new_tokens=10)) for p in prompts]
        srv.run_until_idle()
        ids[str(d)] = [h.request.output_ids for h in hs]
        if d != "cpu":
            assert kfa.launches > before[0]
            assert (kpda.launches if mode == "paged" else kda.launches) > \
                before[2 if mode == "paged" else 1]
    assert all(len(x) == 10 for x in ids["cpu"])
    assert ids[str(dev)] == ids["cpu"]


@pytest.mark.gpu
def test_gpu_quickstart_session_launches_the_kernels():
    """``repro_torch.examples.quickstart`` with every agent role on
    ``TorchLLM`` over a reduced bf16 paged server on the card: the session
    runs its three queries, admissions go through the flash kernel on its
    wgmma route and decode through the paged decode kernel."""
    from repro_torch.examples import quickstart
    dev = _need_card()
    cfg = ARCHS["qwen2.5-3b"].reduced(vocab_size=512)
    assert cfg.dtype == "bfloat16"
    server = quickstart.make_server(cfg, dev)
    llm = quickstart.torch_backend(server, "qwen2.5-3b")
    before = (kfa.launches_by_route["wgmma"], kpda.launches)
    res, lines = quickstart.run("LA", "M+C", "singleton", llm)
    torch.cuda.synchronize()
    assert len(res.statuses) == 3 and lines[-1].startswith("serving stats:")
    assert kfa.launches_by_route["wgmma"] > before[0]
    assert kpda.launches > before[1]
    assert server.stats()["session_turns"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["musicgen-large", "chameleon-34b"])
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_gpu_modality_server_greedy_matches_cpu(arch, mode):
    """The modality archs' LLMServer on the card (musicgen's frame stub
    built inside the decode graph) gives the CPU server's greedy ids
    (float32, same weights, the EOS column of the unembed zeroed)."""
    dev = _need_card()
    cfg = ARCHS[arch].reduced(dtype="float32", param_dtype="float32",
                              vocab_size=512)
    sd = Model(cfg, device="cpu").init(seed=2).state_dict()
    sd["unembed.table"][:, cfg.vocab_size - 1] = 0.0  # EOS guard
    prompts = ["alpha prompt for slot one", "third prompt",
               "a rather longer second prompt that crosses a bucket boundary"]
    ids = {}
    for d in ("cpu", dev):
        srv = LLMServer(cfg, num_slots=3, capacity=128, device=d,
                        params={k: v.to(d) for k, v in sd.items()},
                        engine_cfg=EngineConfig(cache_mode=mode, page_size=16,
                                                decode_chunk=4))
        hs = [srv.submit(p, SamplingParams(max_new_tokens=10)) for p in prompts]
        srv.run_until_idle()
        ids[str(d)] = [h.request.output_ids for h in hs]
    assert all(len(x) == 10 for x in ids["cpu"])
    assert ids[str(dev)] == ids["cpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_gpu_spec_server_greedy_matches_cpu(mode):
    """LLMServer(spec_len=6) on the card gives the CPU server's greedy ids
    (float32, same weights) through the verify kernels."""
    dev = _need_card()
    cfg = _qwen()
    sd = Model(cfg, device="cpu").init(seed=1).state_dict()
    sd["embed.table"][cfg.vocab_size - 1] = 0.0        # EOS guard
    prompts = ["Tool result: ERROR 429 rate limit exceeded at gateway. " * 2,
               "log: a=1 b=2; log: a=1 b=2; log: a=1 b=3; what changed?"]
    ids = {}
    for d in ("cpu", dev):
        srv = LLMServer(cfg, num_slots=2, capacity=160, device=d,
                        params={k: v.to(d) for k, v in sd.items()},
                        engine_cfg=EngineConfig(cache_mode=mode, page_size=16,
                                                decode_chunk=4, spec_len=6))
        before = (spec_scan.launches, ksda.launches, kpsda.launches)
        hs = [srv.submit(p, SamplingParams(max_new_tokens=40)) for p in prompts]
        srv.run_until_idle()
        ids[str(d)] = [h.request.output_ids for h in hs]
        assert srv.stats()["verify_steps"] > 0
        if d != "cpu":
            assert spec_scan.launches > before[0]
            assert (kpsda.launches if mode == "paged" else ksda.launches) > \
                before[2 if mode == "paged" else 1]
    assert all(len(x) == 40 for x in ids["cpu"])
    assert ids[str(dev)] == ids["cpu"]


# ---------------------------------------------------------------------------
# the stateful kernels and archs (recurrentgemma-9b, xlstm-350m)
# ---------------------------------------------------------------------------


def _rand(dev, *shape, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev) * scale


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gpu_rglru_kernel_matches_plain(out_dtype):
    dev = _need_card()
    a = torch.sigmoid(_rand(dev, 2, 300, 200, seed=1))
    bx, h0 = _rand(dev, 2, 300, 200, seed=2), _rand(dev, 2, 200, seed=3)
    for h_in in (None, h0):
        before = krs.launches
        y, h = krs.rglru_scan(a, bx, h_in, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert krs.launches == before + 1
        yw, hw = krs.rglru_scan_ref(a, bx, h_in, out_dtype=out_dtype)
        tol = 5e-6 if out_dtype == torch.float32 else 5e-2
        assert float((y.float() - yw.float()).abs().max()) < tol
        assert float((h - hw).abs().max()) < 5e-6


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,R,route", [
    (1, 4096, 4096, "chunked"),      # recurrentgemma-9b's largest prefill bucket
    (4, 5, 4096, "sequential"),      # its verify step (spec_len 4)
    (2, 64, 96, "sequential"), (2, 65, 96, "chunked"),   # the route's edge
    (3, 1000, 200, "chunked"),       # partial tiles in S and in channels
])
def test_gpu_rglru_routes_match_plain(B, S, R, route):
    """Each route against the sequential plain version: float32 y and
    h_last within 5e-6 (the chunked route composes the carries in another
    association), bf16 y within 5e-2; ``launches_by_route`` counts the
    route picked by S."""
    dev = _need_card()
    a = torch.sigmoid(_rand(dev, B, S, R, seed=11))
    bx, h0 = _rand(dev, B, S, R, scale=0.5, seed=12), _rand(dev, B, R, seed=13)
    before = dict(krs.launches_by_route)
    for out_dtype in (torch.float32, torch.bfloat16):
        y, h = krs.rglru_scan(a, bx, h0, out_dtype=out_dtype)
        torch.cuda.synchronize()
        yw, hw = krs.rglru_scan_ref(a, bx, h0, out_dtype=out_dtype)
        tol = 5e-6 if out_dtype == torch.float32 else 5e-2
        assert float((y.float() - yw.float()).abs().max()) < tol
        assert float((h - hw).abs().max()) < 5e-6
    assert krs.launches_by_route == {**before, route: before[route] + 2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,B,S,H,hd,chunk", [
    (torch.float32, 2, 96, 2, 32, 32), (torch.float32, 2, 100, 2, 64, 32),
    (torch.bfloat16, 2, 100, 2, 64, 32), (torch.bfloat16, 2, 300, 4, 128, 256),
    # xlstm's chunk in float32, held to the plain version run in float64
    (torch.float32, 2, 300, 2, 128, 256), (torch.float32, 1, 300, 1, 512, 256),
    # xlstm-350m's largest prefill bucket, and an extend shorter than the chunk
    (torch.bfloat16, 1, 2048, 4, 512, 256), (torch.bfloat16, 1, 130, 4, 512, 256)])
def test_gpu_mlstm_kernel_matches_plain(dtype, B, S, H, hd, chunk):
    """State in and out, on the route of the dtype (bf16: ``"wgmma"``,
    float32: ``"simt_f32"``); the bounds and references of
    tests/test_kernels.py:139: bf16 5e-2 against the plain version's float32
    result (the inputs widened, h not rounded to bf16: two bf16 roundings of
    one value differ by an ulp, 0.0625 at |h| >= 8), up to xlstm-350m's
    width and chunk; float32 2e-5, chunks of 32 against the float32 plain
    version, chunks of 256 against the plain version in float64 (the float32
    plain version's own rounding of its gates is ~2e-5 there)."""
    dev = _need_card()
    q, k = (_rand(dev, B, S, H, hd, scale=0.5, seed=s).to(dtype) for s in (4, 5))
    v = _rand(dev, B, S, H, hd, seed=6).to(dtype)
    ig, fg = _rand(dev, B, S, H, seed=7), _rand(dev, B, S, H, seed=8) + 2.0
    _, st = kmc.mlstm_chunk_ref(q[:, :17], k[:, :17], v[:, :17], ig[:, :17],
                                fg[:, :17], chunk=chunk)
    before, by_route = kmc.launches, dict(kmc.launches_by_route)
    h, state = kmc.mlstm_chunk(q, k, v, ig, fg, st, chunk=chunk)
    torch.cuda.synchronize()
    route = kmc.ROUTES[dtype]
    assert kmc.launches == before + 1
    assert kmc.launches_by_route == {**by_route, route: by_route[route] + 1}
    if dtype == torch.float32 and chunk >= 256:
        x64 = (t.double() for t in (q, k, v, ig, fg))
        hw, state_w = kmc.mlstm_chunk_ref(*x64, tuple(t.double() for t in st),
                                          chunk=chunk)
    else:
        hw, state_w = kmc.mlstm_chunk_ref(q.float(), k.float(), v.float(), ig, fg, st,
                                          chunk=chunk)
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    assert float((h.double() - hw.double()).abs().max()) < tol
    for a, b in zip(state, state_w):
        assert float((a.double() - b.double()).abs().max()) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
@pytest.mark.parametrize("mode,spec_len", [("dense", 0), ("paged", 0),
                                           ("dense", 4)])
def test_gpu_stateful_server_greedy_matches_cpu(arch, mode, spec_len):
    """LLMServer on the card gives the CPU server's greedy ids for the
    reduced stateful archs (float32, same weights) in dense, snapshot and
    spec mode, through the rglru_scan / mlstm_chunk kernels."""
    dev = _need_card()
    cfg = ARCHS[arch].reduced(dtype="float32", param_dtype="float32",
                              vocab_size=512)
    sd = Model(cfg, device="cpu").init(seed=1).state_dict()
    if cfg.tie_embeddings:                               # EOS guard
        sd["embed.table"][cfg.vocab_size - 1] = 0.0
    else:
        sd["unembed.table"][:, cfg.vocab_size - 1] = 0.0
    sysp = "System: cooperating agents share this conversation verbatim. "
    prompts = [sysp + "[planner] plan", sysp + "[actor] act now",
               "Tool result: ERROR 429 rate limit exceeded. " * 2]
    kern = krs if arch.startswith("recurrentgemma") else kmc
    ids = {}
    for d in ("cpu", dev):
        srv = LLMServer(cfg, num_slots=3, capacity=128, device=d,
                        params={k: v.to(d) for k, v in sd.items()},
                        engine_cfg=EngineConfig(cache_mode=mode, page_size=16,
                                                decode_chunk=4, spec_len=spec_len,
                                                spec_ngram_min=1))
        before = kern.launches
        out = []
        for _ in range(2):                               # the second wave hits
            hs = [srv.submit(p, SamplingParams(max_new_tokens=16)) for p in prompts]
            srv.run_until_idle()
            out += [h.request.output_ids for h in hs]
        ids[str(d)] = out
        if mode == "paged":
            assert srv.stats()["snapshot_hits"] > 0
        if d != "cpu":
            assert kern.launches > before
    assert all(len(x) == 16 for x in ids["cpu"])
    assert ids[str(dev)] == ids["cpu"]


# ---------------------------------------------------------------------------
# the decode and verify steps as replayed CUDA graphs against eager steps
# ---------------------------------------------------------------------------

GRAPH_CASES = {
    "qwen-dense": ("qwen2.5-3b", dict(cache_mode="dense")),
    "qwen-paged": ("qwen2.5-3b", dict(cache_mode="paged")),
    "rgemma-dense": ("recurrentgemma-9b", dict(cache_mode="dense")),
    "rgemma-snapshot": ("recurrentgemma-9b", dict(cache_mode="paged")),
    "xlstm-dense": ("xlstm-350m", dict(cache_mode="dense")),
    "xlstm-snapshot": ("xlstm-350m", dict(cache_mode="paged")),
    "qwen-spec-dense": ("qwen2.5-3b", dict(cache_mode="dense", spec_len=4)),
    "qwen-spec-paged": ("qwen2.5-3b", dict(cache_mode="paged", spec_len=4)),
    "rgemma-spec-ring": ("recurrentgemma-9b", dict(cache_mode="dense", spec_len=4)),
    # MoE: routing with no host sync inside the captured steps
    "mixtral-dense": ("mixtral-8x22b", dict(cache_mode="dense")),
    "mixtral-snapshot": ("mixtral-8x22b", dict(cache_mode="paged")),
    "mixtral-spec-ring": ("mixtral-8x22b", dict(cache_mode="dense", spec_len=4)),
    "dbrx-dense": ("dbrx-132b", dict(cache_mode="dense")),
    "dbrx-paged": ("dbrx-132b", dict(cache_mode="paged")),
    "dbrx-spec-paged": ("dbrx-132b", dict(cache_mode="paged", spec_len=4)),
}
GRAPH_PROMPTS = ["System: cooperating agents share this conversation. [planner] plan",
                 "Tool result: ERROR 429 rate limit exceeded. " * 2,
                 "log: a=1 b=2; log: a=1 b=2; log: a=1 b=3; what changed?",
                 "a fourth prompt, admitted when a slot frees"]
GRAPH_PARAMS = [dict(max_new_tokens=14), dict(max_new_tokens=11),
                dict(max_new_tokens=9, temperature=0.9, seed=1),
                dict(max_new_tokens=10, temperature=1.1, top_k=5, seed=2)]


def _guarded_weights(cfg, seed=1):
    sd = Model(cfg, device="cpu").init(seed=seed).state_dict()
    if cfg.tie_embeddings:                               # EOS guard
        sd["embed.table"][cfg.vocab_size - 1] = 0.0
    else:
        sd["unembed.table"][:, cfg.vocab_size - 1] = 0.0
    return sd


def _graph_server(cfg, sd, dev, pump=False, **ecfg):
    return LLMServer(cfg, num_slots=3, capacity=128, device=dev, pump=pump,
                     params={k: v.to(dev) for k, v in sd.items()},
                     engine_cfg=EngineConfig(page_size=16, decode_chunk=4,
                                             spec_ngram_min=1, **ecfg))


def _run_traced(srv, eager: bool):
    """Serve GRAPH_PROMPTS to the end through the engine's steps; returns
    (ids, the slots' carries after every step, launches by counter)."""
    eng = srv.engine
    before = launch_counts.snapshot()
    hs = [srv.submit(p, SamplingParams(**kw))
          for p, kw in zip(GRAPH_PROMPTS, GRAPH_PARAMS)]
    trace = []
    with (eng.progs.eager() if eager else contextlib.nullcontext()):
        while eng.step() or eng._queue:
            trace.append([(s.cache_len, s.remaining, list(s.generated or ()))
                          for s in eng.slots])
    torch.cuda.synchronize()
    after = launch_counts.snapshot()
    assert all(h.request.status == "completed" for h in hs)
    return ([h.request.output_ids for h in hs], trace,
            {k: after[k] - before[k] for k in after if after[k] != before[k]})


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_gpu_graph_steps_match_eager(case):
    """Greedy, sampled and top-k requests, a fourth admitted when a slot
    frees: the graph path's ids and per-step carries equal the eager
    steps', the caches agree within 1e-5 and so do the logits of one more
    decode step on them (float32); the kernels count the same launches;
    every decode (verify) step ran as a replay or as the warm-up of one
    capture per variant (a host sync in a captured step fails its capture,
    so the MoE cases show that routing syncs with nothing)."""
    dev = _need_card()
    arch, ecfg = GRAPH_CASES[case]
    cfg = ARCHS[arch].reduced(dtype="float32", param_dtype="float32",
                              vocab_size=512)
    sd = _guarded_weights(cfg)
    out, srvs = {}, {}
    for how in ("eager", "graph"):
        srvs[how] = _graph_server(cfg, sd, dev, **ecfg)
        out[how] = _run_traced(srvs[how], eager=how == "eager")
    assert out["graph"][0] == out["eager"][0]
    assert out["graph"][1] == out["eager"][1]
    assert out["graph"][2] == out["eager"][2]
    # a paged pool's trash page takes the writes of masked rows, several to
    # one place in one step (which one lands is not fixed): it is never read
    first = kvpool.TRASH_PAGE + 1 if srvs["graph"].engine.paged else 0
    caches = [[t.narrow(1 if k == "scan" else 0, first,
                        t.shape[1 if k == "scan" else 0] - first)
               for k in sorted(c) for t in ttfm.tree_leaves(c[k])]
              for c in (srvs[h].engine.cache for h in ("graph", "eager"))]
    for a, b in zip(*caches):
        assert float((a.double() - b.double()).abs().max()) < 1e-5
    if ecfg["cache_mode"] == "dense":           # logits on the caches
        model = srvs["graph"].engine.model
        batch = {"tokens": torch.tensor([[5], [6], [7]], device=dev),
                 "positions": torch.tensor([[40], [41], [42]], device=dev)}
        clen = torch.tensor([40, 41, 42], dtype=torch.int32, device=dev)
        lg = [model.decode_step(srvs[h].engine.params, batch,
                                ttfm.tree_map(lambda t: t.clone(), srvs[h].engine.cache),
                                clen)[0] for h in ("graph", "eager")]
        assert float((lg[0] - lg[1]).abs().max()) < 1e-5
    g, e = srvs["graph"].engine.progs, srvs["eager"].engine.progs
    assert sum(e.graph_captures.values()) == sum(e.graph_replays.values()) == 0
    assert 1 <= g.graph_captures["decode"] <= 3
    assert g.graph_captures["decode"] + g.graph_replays["decode"] == g.decode_steps
    assert g.decode_steps == e.decode_steps
    if ecfg.get("spec_len"):
        assert g.verify_steps == e.verify_steps > 0
        assert 1 <= g.graph_captures["verify"] <= 3
        assert g.graph_captures["verify"] + g.graph_replays["verify"] == g.verify_steps


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_gpu_while_chunk_stops_at_eos(mode, monkeypatch):
    """Random weights with no EOS guard, so rows stop at EOS at different
    steps: a chunk on the while graph runs the steps of the eager chunk,
    which checks ``done`` on the host after every step, with equal ids;
    the step count pulled with each chunk (``chunk_steps()``) equals the
    steps the device ran (a counter the captured step itself advances),
    and no decode step ran after every row's last emit
    (``chip_smoke.count_run_on``)."""
    from repro_torch.serving.programs import EnginePrograms
    dev = _need_card()
    chip_smoke = _chip_smoke()
    monkeypatch.setattr(EnginePrograms, "_decode_chunk_fn",
                        EnginePrograms._decode_chunk_fn)    # restored after
    chip_smoke.count_run_on()
    cfg = _qwen()
    sd = Model(cfg, device="cpu").init(seed=4).state_dict()
    prompts = [f"request {i}: " + "tool output line. " * (i + 1) for i in range(6)]
    srv = _graph_server(cfg, sd, dev, cache_mode=mode)
    hs = [srv.submit(p, SamplingParams(max_new_tokens=12)) for p in prompts]
    srv.run_until_idle()
    first = {}                  # the EOS id: a token most rows emit mid-way
    for h in hs:
        ids = h.request.output_ids
        for t in set(ids[1:]):
            first.setdefault(t, []).append(ids.index(t, 1))
    eos = min(first, key=lambda t: (-len(first[t]), sum(first[t]) / len(first[t])))
    out = {}
    for how in ("eager", "graph"):
        srv = _graph_server(cfg, sd, dev, cache_mode=mode)
        progs = srv.engine.progs
        srv.engine.tokenizer.eos_id = progs.eos_id = eos
        ran = torch.zeros((), dtype=torch.int64, device=dev)
        step, settle, pulled = progs._decode_step, progs.settle, []

        def counted(*a, step=step, ran=ran, **kw):
            ran.add_(1)                 # captured with the step: one per step run
            return step(*a, **kw)

        def spy(n=None, settle=settle, pulled=pulled, progs=progs):
            if n is not None and progs._pending is not None:
                pulled.append(int(n))
            settle(n)

        progs._decode_step, progs.settle = counted, spy
        with (progs.eager() if how == "eager" else contextlib.nullcontext()):
            hs = [srv.submit(p, SamplingParams(max_new_tokens=12)) for p in prompts]
            srv.run_until_idle()
        ids = [h.request.output_ids for h in hs]
        out[how] = (ids, progs.decode_steps, srv.stats()["decode_chunks"])
        assert progs.decode_steps == int(ran)
        assert chip_smoke.run_on_steps(srv) == 0
        if how == "graph":
            assert pulled and sum(pulled) == int(ran)
            assert max(pulled) <= srv.engine.engine_cfg.decode_chunk
            assert progs.graph_captures["decode"] + progs.graph_replays["decode"] \
                == progs.decode_steps
    assert out["graph"] == out["eager"]
    assert any(len(i) < 12 for i in out["graph"][0])    # some row hit EOS


def _chip_smoke():
    """The repository's ``chip_smoke.py`` as a module (its run-on count)."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def _while_graph(dev):
    """A ``WhileGraph`` around a captured step that adds one to ``step``,
    launched once (3 steps)."""
    from repro_torch.kernels import decode_loop
    step = torch.zeros(1, dtype=torch.int64, device=dev)
    nsteps = torch.full((1,), 3, dtype=torch.int32, device=dev)
    done = torch.zeros(2, dtype=torch.bool, device=dev)
    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=s, capture_error_mode="thread_local"):
        step.add_(1)
    wg = decode_loop.WhileGraph(g, step, nsteps, done)
    wg.launch()
    torch.cuda.synchronize()
    assert int(step) == 3
    return wg


@pytest.mark.gpu
@pytest.mark.parametrize("destroy", ["immediate", "deferred"])
def test_gpu_dropped_while_graph_inside_a_capture(destroy):
    """A ``WhileGraph`` dropped and collected inside another graph's capture.
    Destroying its executable graph there (what its ``__del__`` did first)
    fails with cudaErrorStreamCaptureUnsupported (900) and invalidates the
    capture; the deferred destroy keeps it until the next loop build, and
    the capture completes."""
    import ctypes
    import gc
    from repro_torch.kernels import decode_loop
    dev = _need_card()
    held = [_while_graph(dev)]
    x = torch.zeros(4, device=dev)
    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    g = torch.cuda.CUDAGraph()
    rc = []

    def drop():
        wg = held.pop()
        if destroy == "immediate":
            rc.append(decode_loop._entry("decode_loop_destroy", [ctypes.c_void_p])(wg._exec))
            wg._exec = None
        del wg
        gc.collect()

    def capture():
        with torch.cuda.graph(g, stream=s, capture_error_mode="thread_local"):
            x.add_(1)
            drop()
            x.add_(1)

    if destroy == "immediate":
        with pytest.raises(RuntimeError, match="capture"):
            capture()
        assert rc == [900]
        return
    capture()
    assert len(decode_loop._dropped) == 1
    g.replay()
    torch.cuda.synchronize()
    assert float(x[0]) == 2.0
    fresh = _while_graph(dev)           # the next build destroys the dropped one
    assert not decode_loop._dropped
    del fresh


@pytest.mark.gpu
@pytest.mark.parametrize("guard", [True, False])
def test_gpu_capture_with_garbage_graphs(guard, monkeypatch):
    """A replayed ``torch.cuda.CUDAGraph`` becomes cyclic garbage inside a
    server's first decode capture, with automatic collections at every
    allocation. Under ``programs._no_gc`` nothing is collected there and
    the request completes; without it the collection destroys that graph's
    executable inside the capture, the capture fails and the request ends
    FAILED with the capture's error (how one request of a fleet run on the
    card failed before the guard)."""
    import gc
    from repro_torch.serving import programs
    dev = _need_card()
    cfg = _qwen()
    srv = _graph_server(cfg, _guarded_weights(cfg), dev, cache_mode="dense")
    progs = srv.engine.progs
    y = torch.zeros(4, device=dev)
    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    other = torch.cuda.CUDAGraph()
    with torch.cuda.graph(other, stream=s):
        y.add_(1)
    other.replay()
    torch.cuda.synchronize()
    holder = [other]
    del other
    step = progs._decode_step

    def dropping(*a, **kw):
        if holder and torch.cuda.is_current_stream_capturing():
            cyc = [holder.pop()]
            cyc.append(cyc)             # garbage only a collection frees
            del cyc
            for _ in range(200):        # allocations: collections, if enabled
                [[] for _ in range(4)]
        return step(*a, **kw)

    progs._decode_step = dropping
    if not guard:
        monkeypatch.setattr(programs, "_no_gc", contextlib.nullcontext)
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        h = srv.submit(GRAPH_PROMPTS[0], SamplingParams(max_new_tokens=9))
        srv.run_until_idle()
    finally:
        gc.set_threshold(*thresholds)
    assert not holder
    if guard:
        assert h.request.status == "completed", repr(h.request.error)
        assert progs.graph_captures["decode"] == 1
    else:
        assert h.request.status == "failed"
        assert "capture" in str(h.request.error)


@pytest.mark.gpu
def test_gpu_host_sync_in_captured_step_raises():
    """A host sync inside the captured step: the chunk raises (the capture
    fails) instead of running the steps eagerly, no graph is kept, and the
    server fails the chunk's requests instead of completing them."""
    dev = _need_card()
    cfg = _qwen()
    srv = _graph_server(cfg, _guarded_weights(cfg), dev, cache_mode="dense")
    progs = srv.engine.progs
    decode_step = progs.model.decode_step

    def syncing(*a, **kw):
        logits, cache = decode_step(*a, **kw)
        if float(logits.abs().max()) < 0:           # a host sync
            raise AssertionError
        return logits, cache

    progs.model.decode_step = syncing
    h = srv.submit(GRAPH_PROMPTS[0], SamplingParams(max_new_tokens=9))
    srv.run_until_idle()
    assert h.request.status == "failed"
    assert isinstance(h.request.error, RuntimeError)
    assert progs.graph_captures["decode"] == 0 and not progs._graphs
    eng = srv.engine
    B = eng.num_slots
    z = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(RuntimeError):
        progs.decode_chunk(eng.params, eng.cache, z, z + 3, z + 5,
                           torch.zeros(B, dtype=torch.bool), None, None, None, z, None, 4)
    assert progs.graph_captures["decode"] == 0 and not progs._graphs
    progs.model.decode_step = decode_step           # the card still works
    h = srv.submit(GRAPH_PROMPTS[1], SamplingParams(max_new_tokens=9))
    srv.run_until_idle()
    assert h.request.status == "completed" and progs.graph_captures["decode"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_gpu_graph_steps_under_the_background_pump(mode):
    """The background pump owns the step loop, so it captures and replays
    the graphs on its own thread: ids (spec_len=4, decode and verify
    graphs) equal the cooperative graph server's and the eager steps'."""
    dev = _need_card()
    cfg = _qwen()
    sd = _guarded_weights(cfg)
    ids = {}
    for how in ("pump", "cooperative", "eager"):
        srv = _graph_server(cfg, sd, dev, cache_mode=mode, spec_len=4,
                            pump=how == "pump")
        progs = srv.engine.progs
        threads = []
        capture = progs._capture

        def spy(step, *loop, capture=capture, threads=threads):
            threads.append(threading.get_ident())
            return capture(step, *loop)

        progs._capture = spy            # before any work reaches the pump
        with (progs.eager() if how == "eager" else contextlib.nullcontext()):
            hs = [srv.submit(p, SamplingParams(**kw))
                  for p, kw in zip(GRAPH_PROMPTS, GRAPH_PARAMS)]
            for h in hs:
                h.result()
        ids[how] = [h.request.output_ids for h in hs]
        if how == "eager":
            assert not threads
        else:
            assert progs.graph_captures["decode"] >= 1 and threads
            assert (threading.get_ident() in threads) == (how == "cooperative")
        srv.close()
    assert ids["pump"] == ids["cooperative"] == ids["eager"]


# ---------------------------------------------------------------------------
# the fleet and the robustness layers on graphs
# ---------------------------------------------------------------------------


def _graph_counts(progs):
    return (progs.decode_steps, progs.graph_captures["decode"],
            progs.graph_replays["decode"])


@pytest.mark.gpu
def test_gpu_fleet_two_pumps_share_weights_and_count_launches():
    """Two replicas on one card, each with its pump thread capturing and
    replaying its own decode graphs while four client threads submit: the
    replicas hold the same weight tensors, every decode step of each was a
    replay or a capture's warm-up, both served, and the paged-decode kernel
    counted exactly one launch per layer per decode step (a capture's own
    launches only, whatever the other pump launched meanwhile)."""
    dev = _need_card()
    build.library()                     # build before any pump starts
    cfg = _qwen()
    fleet = FleetServer(cfg, num_replicas=2, num_slots=3, capacity=128,
                        params={k: v.to(dev) for k, v in _guarded_weights(cfg).items()},
                        device=dev, pump=True,
                        engine_cfg=EngineConfig(cache_mode="paged", page_size=16,
                                                decode_chunk=4))
    with fleet:
        ptrs = [{t.data_ptr() for t in r.server.params.parameters()}
                for r in fleet.replicas]
        assert fleet.replicas[1].server.params is fleet.replicas[0].server.params
        assert ptrs[0] == ptrs[1]
        torch.cuda.synchronize()
        before = launch_counts.snapshot()
        prompts = [f"{i} client {i} asks about topic {i % 3}: " * 2 for i in range(8)]
        out, errs = {}, []

        def client(shard):
            try:
                for p in shard:
                    h = fleet.submit(p, SamplingParams(max_new_tokens=12))
                    h.result()
                    out[p] = h.request
            except BaseException as e:  # surfaced below
                errs.append(e)

        ts = [threading.Thread(target=client, args=(prompts[i::4],)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(300.0)
        assert not errs and not any(t.is_alive() for t in ts)
        fleet.run_until_idle()
        torch.cuda.synchronize()
        after = launch_counts.snapshot()
        assert all(r.status == "completed" for r in out.values()) and len(out) == 8
        steps = 0
        for r in fleet.replicas:
            n, caps, reps = _graph_counts(r.server.engine.progs)
            assert n > 0 and caps + reps == n and 1 <= caps <= 3, (r.idx, n, caps, reps)
            steps += n
        key = ("paged_decode_attention", "")
        assert after[key] - before[key] == cfg.num_layers * steps
        assert after["flash_attention", ""] > before["flash_attention", ""]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_gpu_preempt_resume_on_graphs(mode):
    """Priority preemption on a graph server (float32): the victim (the
    sampled request, first among equals) resumes to exactly its
    uninterrupted output (its RNG chain continues in the sampled decode
    graph's staged keys), and every decode step ran on the graphs."""
    dev = _need_card()
    cfg = _qwen()
    sd = _guarded_weights(cfg)
    lows = [SamplingParams(max_new_tokens=24, temperature=0.7, seed=5),
            SamplingParams(max_new_tokens=24)]
    prompts = ["a long low priority ramble ", "another long low priority job "]
    ids = {}
    for how in ("uninterrupted", "preempted"):
        srv = LLMServer(cfg, num_slots=2, capacity=128, device=dev, seed=7,
                        params={k: v.to(dev) for k, v in sd.items()},
                        engine_cfg=EngineConfig(cache_mode=mode, page_size=8,
                                                decode_chunk=2),
                        overload=OverloadPolicy(preempt=True))
        hs = [srv.submit(p, sp) for p, sp in zip(prompts, lows)]
        if how == "preempted":
            while any(h.request.status != "running" for h in hs):
                srv.step()
            srv.step()
            hi = srv.submit("urgent", SamplingParams(max_new_tokens=6, priority=5))
        srv.run_until_idle()
        ids[how] = [h.request.output_ids for h in hs]
        progs = srv.engine.progs
        n, caps, reps = _graph_counts(progs)
        assert caps + reps == n > 0
        if how == "preempted":
            st = srv.stats()
            assert hi.request.status == "completed"
            assert st["preemptions"] >= 1 and st["preempt_resumes"] >= 1
    assert all(len(x) == 24 for x in ids["uninterrupted"])
    assert ids["preempted"] == ids["uninterrupted"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,mode", [("qwen2.5-3b", "dense"),
                                       ("qwen2.5-3b", "paged"),
                                       ("recurrentgemma-9b", "paged")])
def test_gpu_journal_restore_on_graphs(arch, mode, tmp_path):
    """A server on the card spills its journal after turn 1 and is closed;
    a fresh one restores it and its turn 2 equals the uninterrupted
    server's (float32; paged KV pages and recurrentgemma's snapshots)."""
    dev = _need_card()
    cfg = ARCHS[arch].reduced(dtype="float32", param_dtype="float32",
                              vocab_size=512)
    sd = _guarded_weights(cfg)
    t1, t2 = "user: hello there assistant:", " user: and what else? assistant:"
    sp = SamplingParams(max_new_tokens=12)
    path = str(tmp_path / "journal.json")

    def server(**kw):
        return LLMServer(cfg, num_slots=2, capacity=192, device=dev,
                         params={k: v.to(dev) for k, v in sd.items()},
                         engine_cfg=EngineConfig(cache_mode=mode, page_size=16,
                                                 decode_chunk=4), **kw)

    ref = server()
    s = ref.open_session()
    s.submit(t1, sp).result()
    want = s.submit(s.text + t2, sp)
    want.result()
    a = server(journal_path=path)
    sa = a.open_session()
    sa.submit(t1, sp).result()
    a.close()
    b = server()
    sb = b.restore_sessions(path)[sa.sid]
    h = sb.submit(sb.text + t2, sp)
    h.result()
    assert len(want.request.output_ids) == 12
    assert h.request.output_ids == want.request.output_ids
    n, caps, reps = _graph_counts(b.engine.progs)
    assert caps + reps == n > 0


@pytest.mark.gpu
def test_gpu_transient_fault_before_first_capture():
    """A TransientFault at the first decode dispatch fires before the
    capture: the retry captures once, the graph pool stays usable, and the
    output equals a fault-free server's."""
    dev = _need_card()
    cfg = _qwen()
    sd = _guarded_weights(cfg)
    ids = []
    for faulty in (False, True):
        inj = FaultInjector(seed=0)
        srv = LLMServer(cfg, num_slots=3, capacity=128, device=dev, injector=inj,
                        params={k: v.to(dev) for k, v in sd.items()},
                        engine_cfg=EngineConfig(cache_mode="paged", page_size=16,
                                                decode_chunk=4))
        if faulty:
            inj.fail_next("decode", 1, exc=TransientFault)
        h = srv.submit(GRAPH_PROMPTS[0], SamplingParams(max_new_tokens=13))
        srv.run_until_idle()
        assert h.request.status == "completed"
        progs = srv.engine.progs
        assert progs.graph_captures["decode"] == 1 and progs._pool is not None
        assert progs.dispatch_retries == int(faulty)
        ids.append(h.request.output_ids)
    assert ids[0] == ids[1] and len(ids[0]) == 13


@pytest.mark.gpu
def test_gpu_admission_beside_a_capture():
    """Replica 1 admits a request eagerly (prefill, first-token pull) while
    replica 0's decode capture is held open: the capture succeeds, records
    replica 0's own launches alone (one paged decode a layer), replica 1's
    launches count once, and both requests equal a single server's."""
    dev = _need_card()
    build.library()
    cfg = _qwen()
    sd = {k: v.to(dev) for k, v in _guarded_weights(cfg).items()}
    ecfg = EngineConfig(cache_mode="paged", page_size=16, decode_chunk=4)
    prompts, sp = GRAPH_PROMPTS[:2], SamplingParams(max_new_tokens=12)
    ref = LLMServer(cfg, num_slots=3, capacity=128, device=dev, params=sd,
                    engine_cfg=ecfg)
    want = []
    for p in prompts:
        h = ref.submit(p, sp)
        h.result()
        want.append(h.request.output_ids)
    with FleetServer(cfg, num_replicas=2, num_slots=3, capacity=128, params=sd,
                     device=dev, pump=True, engine_cfg=ecfg) as fleet:
        a, b = (r.server for r in fleet.replicas)
        model = a.engine.progs.model
        step = model.decode_step
        capturing, admitted = threading.Event(), threading.Event()

        def held(*args, **kw):
            if torch.cuda.is_current_stream_capturing() and not capturing.is_set():
                capturing.set()
                assert admitted.wait(120)
            return step(*args, **kw)

        model.decode_step = held
        before = launch_counts.snapshot()
        ha = a.submit(prompts[0], sp)
        assert capturing.wait(120)
        hb = b.submit(prompts[1], sp)
        while hb.request.status == "queued":
            threading.Event().wait(0.002)
        assert a.engine.progs.graph_captures["decode"] == 0   # still capturing
        admitted.set()
        ha.result()
        hb.result()
        torch.cuda.synchronize()
        after = launch_counts.snapshot()
        record = a.engine.progs._graphs["decode", "greedy"].launches
        assert record == {("paged_decode_attention", ""): cfg.num_layers}
        steps = sum(r.server.engine.progs.decode_steps for r in fleet.replicas)
        key = ("paged_decode_attention", "")
        assert after[key] - before[key] == cfg.num_layers * steps
        assert [ha.request.output_ids, hb.request.output_ids] == want


# ---------------------------------------------------------------------------
# training: the kernels' gradients, the split-K forms refusing one, and
# train steps on the card against the CPU
# ---------------------------------------------------------------------------


FLASH_BWD_SHAPES = [  # (B, S, T, H, K, hd, q_start, window)
    (2, 300, 300, 16, 2, 128, 0, None),     # qwen2.5-3b's heads, G = 8
    (1, 200, 200, 8, 4, 64, 0, 48),
    (1, 2048, 2048, 16, 1, 256, 0, 2048),   # recurrentgemma-9b's: hd 256, G = 16
    (1, 260, 260, 8, 8, 64, 0, None),       # G = 1 (musicgen's MHA at hd 64)
    (2, 150, 150, 4, 2, 16, 0, 40),         # hd 16
    (1, 100, 230, 8, 2, 32, 130, None),     # T > S, q_start (an extend)
    (1, 90, 200, 4, 1, 128, 110, 64),       # T > S, q_start and a window
    (2, 333, 333, 8, 2, 64, 0, None),       # S, T not multiples of a 128-row block
    (1, 400, 400, 8, 2, 128, 0, 100),       # a window that cuts the tiles
    (1, 256, 256, 12, 4, 128, 0, None),     # G = 3
    (1, 150, 400, 8, 2, 256, 250, None),    # an extend at hd 256: T > S, q_start
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,K,hd,q_start,window", FLASH_BWD_SHAPES)
def test_gpu_flash_backward_through_the_kernel_matches_plain(dtype, B, S, T, H, K,
                                                             hd, q_start, window,
                                                             monkeypatch):
    """The autograd.Function on the card (forward: the kernel, launched
    once, writing its lse; backward: the backward kernel on the dtype's
    route, launched once, never the plain ``flash_attention_bwd``) against
    autograd of the plain version on the same tensors, at the tolerances of
    the CPU tests (2e-5 float32, 2e-2 bf16, relative to max(1, the
    gradient's largest value))."""
    dev = _need_card()

    def plain_bwd(*a, **kw):
        raise AssertionError("the plain backward ran on the card")

    monkeypatch.setattr(kfa, "flash_attention_bwd", plain_bwd)
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v, do = (torch.randn(*s, generator=g, device=dev).to(dtype)
                   for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd), (B, S, H, hd)))
    kw = dict(q_per_kv=H // K, window=window, q_start=q_start)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = dict(kfa.launches_by_route)
    o = kfa.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    fwd, bwd = kfa.ROUTES[dtype], kfa.BWD_ROUTES[dtype]
    assert kfa.launches_by_route == {**before, fwd: before[fwd] + 1, bwd: before[bwd] + 1}
    want = torch.autograd.grad(kfa.flash_attention_ref(q, k, v, **kw), (q, k, v), do)
    tol = GPU_TOL[dtype]
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == w.dtype, name
        scale = max(1.0, float(w.float().abs().max()))
        assert float((a.float() - w.float()).abs().max()) <= tol * scale, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,K,hd,q_start,window", [
    (2, 2048, 2048, 16, 2, 128, 0, None),   # qwen2.5-3b's train microbatch
    (2, 2048, 2048, 16, 1, 256, 0, 2048),   # recurrentgemma-9b's
    (1, 300, 700, 16, 2, 128, 400, None),   # q_start > 0
    FLASH_BWD_SHAPES[0],
    FLASH_BWD_SHAPES[2],
])
def test_gpu_flash_backward_is_bit_identical_from_call_to_call(dtype, B, S, T, H, K, hd,
                                                               q_start, window):
    """No atomics: two backward calls on the same inputs give the same bits
    (the split dK / dV partials are added in split order), at both train
    microbatches and with q_start > 0."""
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = (torch.randn(*s, generator=g, device=dev).to(dtype)
                   for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd), (B, S, H, hd)))
    kw = dict(q_per_kv=H // K, window=window, q_start=q_start)
    o, lse = kfa._forward(q, k, v, with_lse=True, **kw)
    a = kfa._launch_bwd(q, k, v, o, do, lse, H // K, window, q_start)
    b = kfa._launch_bwd(q, k, v, o, do, lse, H // K, window, q_start)
    torch.cuda.synchronize()
    for name, x, y in zip("qkv", a, b):
        assert torch.equal(x, y), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_serving_forward_writes_no_lse_and_the_same_bytes(dtype):
    """The serving call passes no lse buffer and returns the same bytes as
    the training call, whose lse equals the plain version's."""
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn(*s, generator=g, device=dev).to(dtype)
               for s in ((2, 300, 16, 128), (2, 300, 2, 128), (2, 300, 2, 128)))
    served = kfa.flash_attention(q, k, v, q_per_kv=8)
    o, lse = kfa._forward(q, k, v, q_per_kv=8, with_lse=True)
    none, empty = kfa._launch(q, k, v, 8, None, 0, False)
    torch.cuda.synchronize()
    assert torch.equal(served, o) and torch.equal(none, o) and empty.numel() == 0
    _, want = kfa.flash_attention_ref(q, k, v, q_per_kv=8, return_lse=True)
    assert float((lse - want).abs().max()) < 1e-4


@pytest.mark.gpu
def test_gpu_forward_only_kernels_refuse_a_gradient():
    """The split-K decode forms (dense and paged, one-token) raise under
    autograd on the card instead of returning an output without a
    gradient; without grad (serving) they launch as before."""
    dev = _need_card()
    qd = torch.randn(2, 1, 8, 64, device=dev, requires_grad=True)
    kc = torch.randn(2, 128, 2, 64, device=dev)
    clen = torch.tensor([5, 100], device=dev)
    with pytest.raises(NotImplementedError, match="train mode never decodes"):
        kda.decode_attention(qd, kc, kc, clen, q_per_kv=4)
    pool = torch.randn(9, 16, 2, 64, device=dev)
    bt = torch.arange(8, dtype=torch.int32, device=dev).reshape(2, 4)
    with pytest.raises(NotImplementedError, match="train mode never decodes"):
        kpda.paged_decode_attention(qd, pool, pool, bt, clen // 2, q_per_kv=4)
    with torch.no_grad():
        kda.decode_attention(qd, kc, kc, clen, q_per_kv=4)
        kpda.paged_decode_attention(qd, pool, pool, bt, clen // 2, q_per_kv=4)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,R,route", [(4, 5, 256, "sequential"),
                                         (2, 300, 200, "chunked"),
                                         (2, 2048, 4096, "chunked")])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gpu_rglru_reverse_scan_gradient_matches_plain(B, S, R, route, out_dtype):
    """``RGLRUScan`` on the card (forward: one launch on the route S picks,
    writing y and the float32 states it saves; backward: the gradient
    kernel, one launch on that route's ``_bwd`` counterpart, never the
    plain ``rglru_scan_bwd_ref``) against autograd of the plain version on
    the same tensors, gradients of y (dy in y's dtype) and of h_last: a, bx
    and h0 at 2e-5 relative to max(1, the gradient's largest value); y at
    the forward's bounds (float32 5e-6, bf16 5e-2); the kept states equal
    the plain version's float32 states at 5e-6; two backward calls give the
    same bits."""
    dev = _need_card()
    a = torch.sigmoid(_rand(dev, B, S, R, seed=21))
    bx, h0 = _rand(dev, B, S, R, scale=0.5, seed=22), _rand(dev, B, R, seed=23)
    a[:, S // 2:S // 2 + 3], bx[:, S // 2:S // 2 + 3] = 1.0, 0.0       # masked steps
    dy, dh = _rand(dev, B, S, R, seed=24).to(out_dtype), _rand(dev, B, R, seed=25)
    ins = [t.clone().requires_grad_() for t in (a, bx, h0)]
    before = dict(krs.launches_by_route)
    plain_bwd = krs.rglru_scan_bwd_ref
    try:
        krs.rglru_scan_bwd_ref = None           # the card never runs it
        y, h = krs.rglru_scan(*ins, out_dtype=out_dtype)
        assert type(y.grad_fn).__name__ == "RGLRUScanBackward"
        got = torch.autograd.grad((y, h), ins, (dy, dh))
    finally:
        krs.rglru_scan_bwd_ref = plain_bwd
    torch.cuda.synchronize()
    assert krs.launches_by_route == {**before, route: before[route] + 1,
                                     f"{route}_bwd": before[f"{route}_bwd"] + 1}
    yw, hw = krs.rglru_scan_ref(*ins, out_dtype=out_dtype)
    want = torch.autograd.grad((yw, hw), ins, (dy, dh))
    tol = 5e-6 if out_dtype == torch.float32 else 5e-2
    assert float((y.float() - yw.float()).abs().max()) < tol
    for name, g, w in zip(("a", "bx", "h0"), got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 2e-5 * scale, name
    _, _, kept = krs._forward(a, bx, h0, out_dtype=out_dtype, with_states=True)
    states, _ = krs.rglru_scan_ref(a, bx, h0)
    assert kept.dtype == torch.float32 and float((kept - states).abs().max()) < 5e-6
    first, second = (krs.rglru_scan_bwd(a, kept, dy, h0, dh) for _ in range(2))
    assert all(torch.equal(x, z) for x, z in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,R,out_dtype", [(2, 2048, 4096, torch.bfloat16),
                                             (2, 2048, 4096, torch.float32),
                                             (1, 4096, 4096, torch.bfloat16)])
def test_gpu_rglru_forward_repeat_calls_are_bit_identical(B, S, R, out_dtype):
    """The chunked forward at recurrentgemma-9b's train microbatch (with the
    states it keeps) and at its largest prefill bucket: five calls on the
    same inputs give the same bits. Its decoupled look-back composes a
    carry from whichever predecessors have published when it looks, so
    this holds only while every tile finds its predecessor's state."""
    dev = _need_card()
    a = torch.sigmoid(_rand(dev, B, S, R, seed=31))
    bx, h0 = _rand(dev, B, S, R, scale=0.5, seed=32), _rand(dev, B, R, seed=33)
    before = krs.launches_by_route["chunked"]
    first = krs._forward(a, bx, h0, out_dtype=out_dtype, with_states=True)
    for _ in range(4):
        again = krs._forward(a, bx, h0, out_dtype=out_dtype, with_states=True)
        assert all(torch.equal(x, z) for x, z in zip(first, again))
    torch.cuda.synchronize()
    assert krs.launches_by_route["chunked"] == before + 5


# ---- the sLSTM scan: forward and gradient kernels ------------------------
# (B, S, H, hd, state in, mask, all_states): xlstm-350m's train microbatch,
# a 1500-token admission in its 2048 bucket (right padding), decode, verify
# and small shapes at both edges of hd and of a cluster's rows
SLSTM_CASES = [
    (4, 1024, 4, 256, False, False, False),
    (1, 2048, 4, 256, False, True, False),
    (4, 1, 4, 256, True, False, False),
    (4, 5, 4, 256, True, True, True),
    (2, 37, 2, 32, True, True, False),
    (3, 20, 4, 16, True, True, True),
    (9, 10, 2, 64, False, True, False),
    (1, 3, 1, 128, True, False, True),
]


def _slstm_inputs(dev, dtype, B, S, H, hd, with_state, with_mask, seed=0):
    """Inputs at xlstm-350m's scales under its init: R of the fan-in scaled
    rule over its three stacked sLSTM layers (std (3·4·H·hd)^-1/2), gates_x
    of std 0.3 (an RMS-normed x through the fan-in scaled w_gates). At
    larger scales the recurrence amplifies each rounding over 1000 steps:
    the plain loop in bf16 drifts far from its own float64 result, and so
    does the kernel, so the comparison could not tell a fault."""
    D = H * hd
    gx = _rand(dev, B, S, 4, D, scale=0.3, seed=seed).to(dtype)
    R = _rand(dev, H, 4, hd, hd, scale=(12 * H * hd) ** -0.5, seed=seed + 1).to(dtype)
    state = None
    if with_state:
        state = (_rand(dev, B, D, seed=seed + 2), _rand(dev, B, D, seed=seed + 3).abs() + 0.5,
                 _rand(dev, B, D, scale=0.5, seed=seed + 4), _rand(dev, B, D, seed=seed + 5))
    mask = None
    if with_mask:
        mask = torch.rand(B, S, generator=torch.Generator(device=dev).manual_seed(seed + 6),
                          device=dev) > 0.2
        mask[0, S * 3 // 4:] = False                 # a right-padded row
        mask[:, 0] = True
    return gx, R, state, mask


def _scaled(got, want):
    return float((got.double() - want.double()).abs().max()) / max(
        1.0, float(want.double().abs().max()))


SLSTM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd,with_state,with_mask,all_states", SLSTM_CASES)
def test_gpu_slstm_kernel_matches_plain(dtype, B, S, H, hd, with_state, with_mask,
                                        all_states):
    """The forward kernel (one launch on ``cluster``) against the plain loop
    on the same tensors: y and the state (the last, or after every step)
    within 1e-5 (float32) / 2e-2 (bf16) of max(1, the largest value); two
    calls give the same bits."""
    dev = _need_card()
    gx, R, state, mask = _slstm_inputs(dev, dtype, B, S, H, hd, with_state, with_mask)
    before = kss.launches_by_route["cluster"]
    y, st = kss.slstm_scan(gx, R, state, mask, all_states)
    torch.cuda.synchronize()
    assert kss.launches_by_route["cluster"] == before + 1
    yw, stw = kss.slstm_scan_ref(gx, R, state, mask, all_states)
    assert y.dtype == dtype and y.shape == yw.shape
    assert _scaled(y, yw) <= SLSTM_TOL[dtype]
    for a, b in zip(st, stw):
        assert a.shape == b.shape and _scaled(a, b) <= SLSTM_TOL[dtype]
    y2, st2 = kss.slstm_scan(gx, R, state, mask, all_states)
    assert torch.equal(y, y2) and all(torch.equal(a, b) for a, b in zip(st, st2))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd,with_state,with_mask", [
    (4, 1024, 4, 256, False, False), (2, 37, 2, 32, True, True),
    (3, 20, 4, 16, True, True), (9, 10, 2, 64, True, False)])
def test_gpu_slstm_gradient_matches_plain(dtype, B, S, H, hd, with_state, with_mask):
    """``SLSTMScan`` on the card (forward: one ``cluster`` launch keeping
    the gates and states; backward: one ``cluster_bwd`` launch, never the
    plain loop or ``slstm_scan_bwd_ref``) against autograd through the plain
    loop, gradients of y and of the last state: gates_x, r_gates and the
    state passed in within 1e-4 (float32) / 2e-2 (bf16) of max(1, the
    gradient's largest value); two backward calls give the same bits. The
    bf16 kernel is held to the plain loop run in float32 on the same
    values: autograd through the bf16 loop adds each step's bf16 dR in bf16
    (S roundings), where the kernel path forms dR in one product with
    float32 sums."""
    dev = _need_card()
    gx, R, state, mask = _slstm_inputs(dev, dtype, B, S, H, hd, with_state, with_mask,
                                       seed=10)
    D = H * hd
    dy = _rand(dev, B, S, D, seed=20).to(dtype)
    dlast = tuple(_rand(dev, B, D, scale=s, seed=21 + i)
                  for i, s in enumerate((1.0, 0.3, 1.0, 0.1)))
    ins = [gx.clone().requires_grad_(), R.clone().requires_grad_()]
    ins += [t.clone().requires_grad_() for t in state or ()]
    before = dict(kss.launches_by_route)
    plain = kss.slstm_scan_ref, kss.slstm_scan_bwd_ref
    try:
        kss.slstm_scan_ref = kss.slstm_scan_bwd_ref = None      # the card never runs them
        y, last = kss.slstm_scan(ins[0], ins[1], ins[2:] or None, mask)
        assert type(y.grad_fn).__name__ == "SLSTMScanBackward"
        got = torch.autograd.grad([y, *last], ins, [dy, *dlast])
    finally:
        kss.slstm_scan_ref, kss.slstm_scan_bwd_ref = plain
    torch.cuda.synchronize()
    assert kss.launches_by_route == {"cluster": before["cluster"] + 1,
                                     "cluster_bwd": before["cluster_bwd"] + 1}
    wide = [t.detach().float().requires_grad_() for t in ins]
    yw, lw = kss.slstm_scan_ref(wide[0], wide[1], wide[2:] or None, mask)
    want = torch.autograd.grad([yw, *lw], wide, [dy.float(), *dlast])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, b in zip(("gates_x", "r_gates", "c0", "n0", "h0", "m0"), got, want):
        assert _scaled(a, b) <= tol, name
    _, (cs, ns, hs, ms), g = kss._forward(gx, R, state, mask, keep_gates=True)
    s0 = None if state is None else (state[0], state[1], state[3])
    first, second = (kss.slstm_scan_bwd(g, R, cs, ns, ms, s0, mask, dy, dlast)
                     for _ in range(2))
    assert torch.equal(first[0], second[0])
    assert (first[1] is None) == (state is None)
    if state is not None:
        assert all(torch.equal(a, b) for a, b in zip(first[1], second[1]))


@pytest.mark.gpu
def test_gpu_slstm_cluster_launch_replays_in_a_graph():
    """The decode shape's cluster launch captured in a CUDA graph replays
    to the eager call's bits (the serving steps capture it)."""
    dev = _need_card()
    gx, R, state, _ = _slstm_inputs(dev, torch.bfloat16, 4, 1, 4, 256, True, False)
    want = kss.slstm_scan(gx, R, state)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kss.slstm_scan(gx, R, state)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kss.slstm_scan(gx, R, state)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(out[1], want[1]))


@pytest.mark.gpu
def test_gpu_slstm_refuses_what_the_kernel_does_not_take():
    dev = _need_card()
    gx, R, _, _ = _slstm_inputs(dev, torch.float32, 1, 4, 2, 48, False, False)
    with pytest.raises(ValueError, match="head dim"):
        kss.slstm_scan(gx, R)
    gx, R, _, _ = _slstm_inputs(dev, torch.float32, 1, 4, 2, 32, False, False)
    with pytest.raises(ValueError, match="r_gates must be"):
        kss.slstm_scan(gx.to(torch.bfloat16), R)


# the bf16 backward's tiling edges: 64-row pair tiles kept per chunk, 64 or
# 128 columns a dq / dk / dv block, GC_c per chunk
MLSTM_BF16_EDGES = [
    (torch.bfloat16, 1, 1024, 2, 128, 512),       # the longest chunk (MAX_CHUNK)
    (torch.bfloat16, 2, 300, 2, 128, 64),         # one tile a chunk, 5 chunks
    (torch.bfloat16, 2, 300, 2, 64, 100),         # L not a multiple of 64
    (torch.bfloat16, 1, 1000, 2, 128, 256),       # S not a multiple of the chunk
    (torch.bfloat16, 2, 512, 2, 256, 256),        # hd 256
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,B,S,H,hd,chunk", [
    (torch.float32, 2, 100, 2, 64, 32), (torch.float32, 2, 300, 2, 128, 256),
    (torch.bfloat16, 2, 100, 2, 64, 32),
    (torch.bfloat16, 2, 1024, 4, 512, 256),       # xlstm-350m's train microbatch
    *MLSTM_BF16_EDGES])
def test_gpu_mlstm_function_with_the_kernel_forward_matches_plain(dtype, B, S, H, hd,
                                                                  chunk, monkeypatch):
    """``MLSTMChunk`` on the card (forward: the kernel on the dtype's route,
    launched once, keeping the chunk start states; backward: the backward
    kernel on ``BWD_ROUTES[dtype]``, launched once, and never the plain
    ``mlstm_chunk_bwd``) against autograd of the plain version on the same
    tensors: each gradient at float32 1e-4 and bf16 2e-2 relative to max(1,
    its largest value)."""
    dev = _need_card()
    q, k = (_rand(dev, B, S, H, hd, scale=0.5, seed=s).to(dtype) for s in (31, 32))
    v = _rand(dev, B, S, H, hd, seed=33).to(dtype)
    ig, fg = _rand(dev, B, S, H, seed=34), _rand(dev, B, S, H, seed=35) + 2.0
    dh = _rand(dev, B, S, H, hd, seed=36).to(dtype)
    ins = [t.clone().requires_grad_() for t in (q, k, v, ig, fg)]

    def plain_backward(*a, **kw):
        raise AssertionError("the plain mlstm_chunk_bwd ran on the card")

    monkeypatch.setattr(kmc, "mlstm_chunk_bwd", plain_backward)
    before = dict(kmc.launches_by_route)
    h, _ = kmc.mlstm_chunk(*ins, chunk=chunk)
    assert type(h.grad_fn).__name__ == "MLSTMChunkBackward"
    got = torch.autograd.grad(h, ins, dh)
    torch.cuda.synchronize()
    route, bwd = kmc.ROUTES[dtype], kmc.BWD_ROUTES[dtype]
    assert kmc.launches_by_route == {**before, route: before[route] + 1,
                                     bwd: before[bwd] + 1}
    hw, _ = kmc.mlstm_chunk_ref(*ins, chunk=chunk)
    want = torch.autograd.grad(hw, ins, dh)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(("q", "k", "v", "ig", "fg"), got, want):
        assert g.dtype == w.dtype, name
        scale = max(1.0, float(w.float().abs().max()))
        assert float((g.float() - w.float()).abs().max()) <= tol * scale, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,S,hd,chunk", [(torch.float32, 100, 64, 32),
                                              (torch.bfloat16, 100, 64, 32),
                                              (torch.bfloat16, 300, 128, 64),
                                              (torch.bfloat16, 600, 256, 256)])
def test_gpu_mlstm_backward_with_a_state_in_and_out_matches_plain(dtype, S, hd, chunk):
    """S not a multiple of the chunk, a state in (held constant) and a
    gradient of the state out (dC, dn) from a reader invariant to the
    stabiliser's shift, the next segment's plain version: the backward kernel
    against autograd of the plain version through both segments, float32
    1e-4 and bf16 2e-2 relative to max(1, the gradient's largest value);
    bf16 also at 128 columns a dq / dk / dv block and at hd 256."""
    dev = _need_card()
    B, H = 2, 2
    q, k = (_rand(dev, B, S, H, hd, scale=0.5, seed=s).to(dtype) for s in (41, 42))
    v = _rand(dev, B, S, H, hd, seed=43).to(dtype)
    ig, fg = _rand(dev, B, S, H, seed=44), _rand(dev, B, S, H, seed=45) + 2.0
    dh = _rand(dev, B, S, H, hd, seed=46).to(dtype)
    nxt = [_rand(dev, B, 9, H, hd, seed=s) for s in (47, 48, 49, 50)]
    nxt[3:3] = [_rand(dev, B, 9, H, seed=51), _rand(dev, B, 9, H, seed=52) + 2.0]
    _, st = kmc.mlstm_chunk_ref(q[:, :17].float(), k[:, :17].float(), v[:, :17].float(),
                                ig[:, :17], fg[:, :17], chunk=chunk)
    ins = [t.clone().requires_grad_() for t in (q, k, v, ig, fg)]
    bwd = kmc.BWD_ROUTES[dtype]
    before = kmc.launches_by_route[bwd]
    grads = []
    for fn in (kmc.mlstm_chunk, kmc.mlstm_chunk_ref):
        h, st_out = fn(*ins, st, chunk=chunk)
        h2, _ = kmc.mlstm_chunk_ref(*nxt[:5], st_out, chunk=chunk)
        loss = (h.float() * dh.float()).sum() + (h2 * nxt[5]).sum()
        grads.append(torch.autograd.grad(loss, ins))
    torch.cuda.synchronize()
    assert kmc.launches_by_route[bwd] == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(("q", "k", "v", "ig", "fg"), *grads):
        scale = max(1.0, float(w.float().abs().max()))
        assert float((g.float() - w.float()).abs().max()) <= tol * scale, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,B,S,H,hd,chunk", [
    (torch.float32, 2, 100, 2, 64, 32), (torch.bfloat16, 2, 100, 2, 64, 32),
    (torch.bfloat16, 2, 1024, 4, 512, 256), *MLSTM_BF16_EDGES])
def test_gpu_mlstm_backward_is_bit_identical_from_call_to_call(dtype, B, S, H, hd, chunk):
    """No atomics: two backward calls on the same inputs and kept states give
    the same bits; the forward with its states kept writes the same h and
    state out as the serving forward, and its kept states are the plain
    version's (``chunk_states_ref``: bf16 5e-2, C rounded to TF32 and carried
    from bf16 inputs; float32 2e-5)."""
    dev = _need_card()
    q, k = (_rand(dev, B, S, H, hd, scale=0.5, seed=s).to(dtype) for s in (51, 52))
    v = _rand(dev, B, S, H, hd, seed=53).to(dtype)
    ig, fg = _rand(dev, B, S, H, seed=54), _rand(dev, B, S, H, seed=55) + 2.0
    dh = _rand(dev, B, S, H, hd, seed=56).to(dtype)
    h, (C, n, m), kept = kmc._forward(q, k, v, ig, fg, chunk=chunk, with_states=True)
    h2, (C2, n2, m2) = kmc._forward(q, k, v, ig, fg, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in ((h, h2), (C, C2), (n, n2), (m, m2)))
    want = kmc.chunk_states_ref(q.float(), k.float(), v.float(), ig, fg, chunk=chunk)
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    for got, w in zip(kept[1:], want):
        w = w.double()
        scale = max(1.0, float(w.abs().max()))
        assert float((got.double() - w).abs().max()) <= tol * scale
    outs = [torch.ops.repro_torch.mlstm_chunk_bwd(q, k, v, ig, fg, dh, None, None, C, n,
                                                  *kept, False, chunk) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gpu_train_step_matches_cpu():
    """One float32 train step of a reduced qwen (accumulation 2, remat
    full) on the card equals the same step of the port on the CPU: loss
    at 1e-4, the kernel's forward launched twice a layer a microbatch
    (forward and recompute) and its backward once, on the float32 route."""
    from repro_torch.training import data as tdata
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train_step as tts
    dev = _need_card()
    cfg = ARCHS["qwen2.5-3b"].reduced(dtype="float32", param_dtype="float32",
                                      vocab_size=512, num_layers=3)
    sd = Model(cfg, device="cpu").init(seed=0).state_dict()
    dcfg = tdata.DataConfig(global_batch=4, seq_len=64, vocab_size=cfg.vocab_size)
    losses = {}
    for where in ("cpu", dev):
        params = Model(cfg, device=where).load(sd, trainable=True)
        step = tts.make_train_step(cfg, tts.TrainConfig(
            opt=topt.AdamWConfig(lr=1e-3, warmup_steps=1), accum_steps=2))
        before, bwd = kfa.launches, kfa.launches_by_route["simt_f32_bwd"]
        _, _, m = step(params, topt.init_opt_state(params),
                       tdata.SyntheticLM(dcfg, cfg, device=where).batch_at(0))
        losses[str(where)] = float(m["loss"])
        if where != "cpu":
            torch.cuda.synchronize()
            assert kfa.launches - before == 3 * cfg.num_layers * 2
            assert kfa.launches_by_route["simt_f32_bwd"] - bwd == cfg.num_layers * 2
    assert abs(losses[str(dev)] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
def test_gpu_stateful_train_step_matches_cpu(arch):
    """One float32 train step of a reduced recurrentgemma-9b / xlstm-350m
    (accumulation 2, remat full) on the card equals the same step on the
    CPU: loss and grad norm at 1e-4 (relative). Launches: rglru_scan 3 a recurrent layer of the
    scanned period (forward, recompute, reverse scan) and 2 a tail layer
    (no recompute), flash likewise (forward, recompute, its backward
    kernel), mlstm_chunk likewise (forward, recompute, its backward kernel
    on ``simt_f32_bwd``), slstm_scan likewise (forward, recompute, its
    gradient kernel on ``cluster_bwd``), each a microbatch; no split-K
    launch."""
    from repro_torch.training import data as tdata
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train_step as tts
    dev = _need_card()
    cfg = ARCHS[arch].reduced(dtype="float32", param_dtype="float32", vocab_size=512)
    sd = Model(cfg, device="cpu").init(seed=0).state_dict()
    dcfg = tdata.DataConfig(global_batch=4, seq_len=96, vocab_size=cfg.vocab_size)
    scanned = len(cfg.pattern) * cfg.num_scan_groups
    want = {"rglru_scan": 0, "flash_attention": 0, "mlstm_chunk": 0, "split_decode": 0,
            "slstm_scan": 0}
    for i, kind in enumerate(cfg.layer_kinds):
        runs = 2 if i < scanned else 1
        key = {"recurrent": "rglru_scan", "local_attn": "flash_attention",
               "mlstm": "mlstm_chunk", "slstm": "slstm_scan"}.get(kind)
        if key:
            want[key] += 2 * (runs + 1)
    bwd = 2 * cfg.layer_kinds.count("mlstm")
    out = {}
    for where in ("cpu", dev):
        params = Model(cfg, device=where).load(sd, trainable=True)
        step = tts.make_train_step(cfg, tts.TrainConfig(
            opt=topt.AdamWConfig(lr=1e-3, warmup_steps=1), accum_steps=2))
        launch_counts.reset()
        _, _, m = step(params, topt.init_opt_state(params),
                       tdata.SyntheticLM(dcfg, cfg, device=where).batch_at(0))
        out[str(where)] = (float(m["loss"]), float(m["grad_norm"]))
        if where != "cpu":
            torch.cuda.synchronize()
            snap = launch_counts.snapshot()
            got = {k: snap[k, ""] for k in want}
            assert got == want
            assert snap["mlstm_chunk", "simt_f32_bwd"] == bwd
            assert snap["slstm_scan", "cluster_bwd"] == 2 * cfg.layer_kinds.count("slstm")
    for i, what in enumerate(("loss", "grad_norm")):
        want_v, got_v = out["cpu"][i], out[str(dev)][i]
        assert abs(got_v - want_v) <= 1e-4 * abs(want_v), (what, got_v, want_v)


# ---- the device mesh ---------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 600])
def test_gpu_seqpar_decode_equals_one_launch(dtype, window):
    """The sequence-parallel decode (a partials launch per sequence shard,
    one combine) at qwen2.5-3b's decode shape, caches [4, 2048, 2, 128] cut
    into 4 shards of 512 slots: bit-equal to the one-launch split-K kernel,
    and within the tolerance of the plain version."""
    from repro_torch.distributed.collectives import (make_seqpar_decode_attention,
                                                     seqpar_decode_ref)
    from repro_torch.distributed.mesh import make_test_mesh
    dev = _need_card()
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(4, 1, 16, 128, generator=g, device=dev).to(dtype)
    kc, vc = (torch.randn(4, 2048, 2, 128, generator=g, device=dev).to(dtype)
              for _ in range(2))
    clen = torch.tensor([0, 511, 1300, 2047], dtype=torch.int32, device=dev)
    f = make_seqpar_decode_attention(make_test_mesh((1, 4), devices=dev))
    before = dict(ksd.launches_by_route)
    got = f(q, kc, vc, clen, q_per_kv=8, window=window)
    torch.cuda.synchronize()
    assert ksd.launches_by_route["partials"] - before["partials"] == 4
    assert ksd.launches_by_route["combine"] - before["combine"] == 1
    one = kda.decode_attention(q, kc, vc, clen, q_per_kv=8, window=window)
    assert torch.equal(got, one)
    want = seqpar_decode_ref(q, kc.chunk(4, 1), vc.chunk(4, 1), clen, q_per_kv=8,
                             window=window)
    assert float((got.float() - want.float()).abs().max()) < GPU_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_gpu_mesh_server_matches_unsharded(mode):
    """A (2, 2) mesh on the one card (float32, qwen with 4 KV heads,
    spec_len 4): the same greedy ids as the unsharded server on the card;
    every decode / verify step a graph replay or a capture's warm-up, and
    the decode kernel launched once a layer, step and shard."""
    from repro_torch.distributed.mesh import make_test_mesh
    dev = _need_card()
    cfg = ARCHS["qwen2.5-3b"].reduced(dtype="float32", param_dtype="float32",
                                      vocab_size=512, num_kv_heads=4)
    sd = Model(cfg, device="cpu").init(seed=1).state_dict()
    sd["embed.table"][cfg.vocab_size - 1] = 0.0        # EOS guard
    prompts = ["alpha prompt for slot one", "err 429 err 429 err 429 err 4",
               "a rather longer second prompt", "third prompt"]
    ids = {}
    for mesh in (None, make_test_mesh((2, 2), devices=dev)):
        srv = LLMServer(cfg, num_slots=4, capacity=128, device=dev,
                        params={k: v.to(dev) for k, v in sd.items()},
                        engine_cfg=EngineConfig(cache_mode=mode, page_size=16,
                                                decode_chunk=4, spec_len=4, mesh=mesh))
        kmod = kpda if mode == "paged" else kda
        before = kmod.launches
        hs = [srv.submit(p, SamplingParams(max_new_tokens=10)) for p in prompts]
        srv.run_until_idle()
        torch.cuda.synchronize()
        ids[mesh is None] = [h.request.output_ids for h in hs]
        progs = srv.engine.progs
        assert progs.graphs and srv.stats().get("step_graphs", True)
        steps = progs.decode_steps
        assert sum(progs.graph_captures.values()) + sum(progs.graph_replays.values()) \
            == steps + progs.verify_steps
        shards = [progs.launch_shards(srv.params, i) for i in range(cfg.num_layers)]
        assert kmod.launches - before == launch_counts.expected(steps, shards)
        assert shards == [1 if mesh is None else 4] * cfg.num_layers
        srv.close()
    assert all(len(x) == 10 for x in ids[True])
    assert ids[False] == ids[True]


# ---------------------------------------------------------------------------
# the baseline layouts (train / decode tables) on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_gpu_train_table_step_matches_unsharded():
    """A float32 train step of a reduced qwen (accumulation 2) under the
    train table on a (2, 2) mesh of ``cuda:0`` positions (FSDP over "data",
    q heads and mlp over "model", row-parallel sums) equals the unsharded
    step on the card: loss, every gradient leaf and the updated params
    within 1e-5; flash launched on every "model" part and "data" shard:
    forward, recompute and its backward kernel (float32 route)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.training import data as tdata
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train_step as tts
    dev = _need_card()
    cfg = _qwen()
    sd = {k: v.to(dev) for k, v in Model(cfg, device="cpu").init(seed=0).state_dict().items()}
    batch = tdata.SyntheticLM(tdata.DataConfig(global_batch=4, seq_len=64,
                                               vocab_size=cfg.vocab_size), cfg,
                              device=dev).batch_at(0)
    step = tts.make_train_step(cfg, tts.TrainConfig(accum_steps=2))
    ref = Model(cfg, device=dev).load(sd, trainable=True)
    l0, _, g0 = step.loss_and_grads(ref, batch)
    ref, _, _ = step(ref, topt.init_opt_state(ref), batch)
    rules = shd.rules_for(make_test_mesh((2, 2), devices=dev), "train")
    placed = shd.place_params(Model(cfg, device=dev).load(sd), rules, trainable=True)
    before, bwd = kfa.launches, kfa.launches_by_route["simt_f32_bwd"]
    with shd.use_rules(rules):
        l1, _, g1 = step.loss_and_grads(placed, batch)
        torch.cuda.synchronize()
        assert kfa.launches - before == 3 * cfg.num_layers * 2 * 2 * 2
        assert kfa.launches_by_route["simt_f32_bwd"] - bwd == cfg.num_layers * 2 * 2 * 2
        placed, _, _ = step(placed, topt.init_opt_state(placed), batch)
    assert abs(float(l1) - float(l0)) <= 1e-5 * abs(float(l0))
    for k, g in g0.items():
        assert float((shd.gather(g1[k]) - g).abs().max()) <= 1e-5, k
    want, got = shd.full_state_dict(ref), shd.full_state_dict(placed)
    for k, p in want.items():
        assert float((got[k] - p).abs().max()) <= 1e-5, k


@pytest.mark.gpu
def test_gpu_decode_table_seqpar_matches_unsharded():
    """Prefill under the prefill table and decode steps under the decode
    table on a (1, 2) mesh of ``cuda:0`` positions: the cache cut by
    sequence ("kv_seq"), the split kernel's partials per shard and one
    combine; greedy ids equal the unsharded model's, logits within 1e-5."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.mesh import make_test_mesh
    dev = _need_card()
    cfg = _qwen()
    params = Model(cfg, device=dev).init(seed=0)
    B, S, cap = 2, 40, 256
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, 500, (B, S), generator=g).to(dev)
    rules_pf = shd.rules_for(make_test_mesh((1, 2), devices=dev), "prefill")
    rules_dec = shd.rules_for(rules_pf["mesh"], "decode")
    out = {}
    for how in ("unsharded", "mesh"):
        p = params if how == "unsharded" else shd.place_params(params, rules_pf)
        cache = ttfm.init_cache(cfg, B, cap, dev)
        if how == "mesh":
            cache = shd.shard_put(cache, shd.cache_pspecs(cfg, rules_pf), rules_pf["mesh"])
        ctx = (lambda r: contextlib.nullcontext()) if how == "unsharded" else shd.use_rules
        pos = torch.arange(S, device=dev).expand(B, S)
        with ctx(rules_pf):
            lg, cache = ttfm.prefill(p, {"tokens": tok, "positions": pos}, cfg, cache)
        nxt, logits, ids = lg[:, -1].argmax(-1), [], []
        for i in range(8):
            clen = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            with ctx(rules_dec):
                lg, cache = ttfm.decode_step(p, {"tokens": nxt[:, None],
                                                 "positions": clen[:, None].long()},
                                             cfg, cache, clen)
            nxt = lg[:, 0].argmax(-1)
            logits.append(lg[:, 0])
            ids.append(nxt)
        out[how] = (torch.stack(logits), torch.stack(ids))
    assert torch.equal(out["mesh"][1], out["unsharded"][1])
    assert float((out["mesh"][0] - out["unsharded"][0]).abs().max()) <= 1e-5
