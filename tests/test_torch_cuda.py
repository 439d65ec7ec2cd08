"""The four CUDA kernels of the port against their plain PyTorch versions,
on the card.  Marked ``cuda``; each skips without a CUDA device (the check
runs inside a fixture, so every worker collects the same tests).  Run on
the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no ``jax``: that machine has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import compression as tc
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.codebook_matmul_packed import codebook_matmul_packed
from repro_torch.kernels.codebook_matmul_packed_t import \
    codebook_matmul_packed_t
from repro_torch.kernels.quantized_gather import quantized_gather

KS = (2, 4, 16, 256)
PREFILL_CASES = {
    "gqa-ragged": dict(b=2, c=5, h=4, kv=2, hd=8, s=13, start=8),
    "window-softcap": dict(b=1, c=7, h=6, kv=3, hd=12, s=20, start=13,
                           window=4, softcap=5.0),
    "first-block": dict(b=2, c=6, h=2, kv=2, hd=8, s=6, start=0),
    "serving-block": dict(b=4, c=64, h=16, kv=16, hd=64, s=128, start=64),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest -m cuda` on the H100")
    return torch.device("cuda")


def _card_operands(k, rows, cols, cuda, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    cb = torch.sort(torch.randn(k, generator=g, device=cuda))[0]
    idx = torch.randint(0, k, (rows, cols), generator=g, device=cuda)
    return g, cb, idx


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_cuda_quantized_gather_exact(cuda, k):
    g, cb, idx = _card_operands(k, 300, 129, cuda, k)
    words = tc.as_words(tc.pack_rows(idx.cpu().numpy(), k), cuda)
    tok = torch.randint(0, 300, (17,), generator=g, device=cuda)
    before = quantized_gather.launches
    got = quantized_gather(tok, words, cb, 129)
    torch.cuda.synchronize()
    assert quantized_gather.launches == before + 1
    assert torch.equal(got, ref.quantized_gather_ref(tok, words, cb, 129))


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("m,kd,n", [(3, 37, 70), (40, 300, 130),
                                    (4, 1024, 2816)])
def test_cuda_codebook_matmul_packed(cuda, k, m, kd, n):
    g, cb, idx = _card_operands(k, kd, n, cuda, k + m)
    words = tc.as_words(tc.pack_indices_2d(idx.cpu().numpy(), k), cuda)
    x = torch.randn(m, kd, generator=g, device=cuda)
    got = codebook_matmul_packed(x, words, cb)
    want = ref.packed_codebook_matmul_ref(x, words, cb)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("order", ["row", "kd"])
@pytest.mark.parametrize("m,d,v", [(3, 37, 101), (9, 50, 777)])
def test_cuda_codebook_matmul_packed_t(cuda, k, order, m, d, v):
    g, cb, idx = _card_operands(k, v, d, cuda, k + m)
    host = idx.cpu().numpy()
    words = tc.as_words(tc.pack_rows(host, k) if order == "row"
                        else tc.pack_indices_2d(host, k), cuda)
    x = torch.randn(m, d, generator=g, device=cuda)
    got = codebook_matmul_packed_t(x, words, cb, v, order=order)
    want = ref.packed_codebook_matmul_t_ref(x, words, cb, v, order=order)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_cuda_blockwise_prefill(cuda, case):
    p = dict(PREFILL_CASES[case])
    window, softcap = p.pop("window", None), p.pop("softcap", None)
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(p["b"], p["c"], p["h"], p["hd"], generator=g,
                    device=cuda)
    k = torch.randn(p["b"], p["s"], p["kv"], p["hd"], generator=g,
                    device=cuda)
    v = torch.randn(p["b"], p["s"], p["kv"], p["hd"], generator=g,
                    device=cuda)
    q_pos = torch.arange(p["start"], p["start"] + p["c"], device=cuda)
    k_pos = torch.arange(p["s"], device=cuda)
    kw = dict(window=window, softcap=softcap, scale=p["hd"] ** -0.5)
    got = dispatch.blockwise_prefill_attention(q, k, v, q_pos, k_pos, **kw)
    want = dispatch.blockwise_prefill_attention(
        q.cpu(), k.cpu(), v.cpu(), q_pos.cpu(), k_pos.cpu(), **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
def test_cuda_uint8_route_raises(cuda):
    x = torch.zeros(2, 8, device=cuda)
    with pytest.raises(NotImplementedError, match="row 11"):
        dispatch.quantized_matmul(x, torch.zeros(8, 4, dtype=torch.uint8,
                                                 device=cuda),
                                  torch.zeros(4, device=cuda))
