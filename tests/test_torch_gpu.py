"""The port's CUDA kernels on the card (tests marked ``gpu``).

Each kernel against its plain PyTorch version at the tolerances of
tests/test_kernels.py (float32 2e-5, bf16 2e-2), and the port's model and
server (speculative decode included) on the card against the same code on
the CPU (plain versions). This
file imports no JAX, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test skips: a CUDA kernel has no CPU mode.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.kernels import decode_attention as kda  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import paged_decode_attention as kpda  # noqa: E402
from repro_torch.kernels import paged_spec_decode_attention as kpsda  # noqa: E402
from repro_torch.kernels import spec_decode_attention as ksda  # noqa: E402
from repro_torch.kernels import spec_scan  # noqa: E402
from repro_torch.models import Model  # noqa: E402
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
