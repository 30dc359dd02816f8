"""The port's CUDA kernels on the card (tests marked ``gpu``).

Each kernel against its plain PyTorch version at the tolerances of
tests/test_kernels.py (float32 2e-5, bf16 2e-2), and the port's model and
server on the card against the same code on the CPU (plain versions). This
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
