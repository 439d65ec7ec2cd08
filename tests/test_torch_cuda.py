"""The CUDA kernels of the port against their plain PyTorch versions, on
the card.  Marked ``cuda``; each skips without a CUDA device (the check
runs inside a fixture, so every worker collects the same tests).  Run on
the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no ``jax``: that machine has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import compression as tc
from repro_torch.core import kvquant
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.blockwise_prefill_quant import \
    blockwise_prefill_quant
from repro_torch.kernels.codebook_matmul_packed import codebook_matmul_packed
from repro_torch.kernels.codebook_matmul_packed_t import \
    codebook_matmul_packed_t
from repro_torch.kernels.page_gather import page_gather
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_attention_quant import paged_attention_quant
from repro_torch.kernels.quantized_gather import quantized_gather
from repro_torch.models import attention as attn

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


def _paged_operands(cuda, b, h, kv, hd, page, npg, seed, n_phys=None):
    """q [B,1,H,hd] and pools [P+1, page, KV, hd] whose pages beyond each
    slot's pos hold large garbage; a page table over a random permutation
    of the usable pages."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    n_phys = n_phys or b * npg + 1
    q = 3 * torch.randn(b, 1, h, hd, generator=g, device=cuda)
    kp = torch.randn(n_phys, page, kv, hd, generator=g, device=cuda)
    vp = torch.randn(n_phys, page, kv, hd, generator=g, device=cuda)
    perm = torch.randperm(n_phys - 1, generator=g, device=cuda)[:b * npg] + 1
    table = perm.reshape(b, npg).to(torch.int32)
    return q, kp, vp, table


def _check_paged(got, want, alive):
    assert torch.isfinite(got).all()
    live, dead = got[alive], got[~alive]
    scale = float(want[alive].abs().max()) if alive.any() else 1.0
    if alive.any():
        assert (live - want[alive]).abs().max() <= 1e-4 * scale
    # dead slots: the kernel writes 0 (the Pallas rule); the plain version
    # follows the jnp spec there (mean of the trash page's V)
    assert torch.equal(dead, torch.zeros_like(dead))


@pytest.mark.cuda
@pytest.mark.parametrize("rep,hd,page,softcap", [
    (1, 8, 8, None), (2, 64, 16, 30.0), (4, 128, 8, None),
    (1, 128, 16, 30.0), (2, 8, 16, None), (4, 64, 8, 30.0)])
def test_cuda_paged_attention(cuda, rep, hd, page, softcap):
    kv, npg = 2, 3
    cap = npg * page
    q, kp, vp, table = _paged_operands(cuda, 5, kv * rep, kv, hd, page, npg,
                                       rep * hd + page)
    pos = torch.tensor([0, page - 1, page, cap - 1, 5], dtype=torch.int32,
                       device=cuda)
    alive = torch.tensor([True, True, True, True, False], device=cuda)
    kw = dict(softcap=softcap, scale=hd ** -0.5)
    before = paged_attention.launches
    got = paged_attention(q, kp, vp, table, pos, alive, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    _check_paged(got, ref.paged_attention_ref(q, kp, vp, table, pos, alive,
                                              **kw), alive)
    # int64 table / pos / bool alive are converted by the wrapper; a stale
    # table row of the dead slot never matters
    table[4] = table[0]
    again = paged_attention(q, kp, vp, table.long(), pos.long(), alive, **kw)
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_cuda_paged_attention_all_dead_and_serving_shape(cuda):
    q, kp, vp, table = _paged_operands(cuda, 3, 4, 2, 64, 16, 2, 11)
    dead = torch.zeros(3, dtype=torch.bool, device=cuda)
    pos = torch.tensor([3, 20, 31], dtype=torch.int32, device=cuda)
    got = paged_attention(q, kp, vp, table, pos, dead, scale=0.125)
    assert torch.equal(got, torch.zeros_like(got))
    # decode at the qwen1.5-0.5b engine shapes: 4 slots, 16 heads of 64,
    # pages of 16, 9 logical pages per slot, 36 usable pages
    q, kp, vp, table = _paged_operands(cuda, 4, 16, 16, 64, 16, 9, 12)
    pos = torch.tensor([127, 130, 143, 0], dtype=torch.int32, device=cuda)
    alive = torch.tensor([True, True, True, False], device=cuda)
    got = paged_attention(q, kp, vp, table, pos, alive, scale=0.125)
    torch.cuda.synchronize()
    _check_paged(got, ref.paged_attention_ref(q, kp, vp, table, pos, alive,
                                              scale=0.125), alive)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,feat,page", [
    (torch.float32, (16, 64), 16), (torch.float32, (2, 8), 8),
    (torch.bfloat16, (3, 5), 16), (torch.int32, (7,), 5),
    (torch.uint8, (3,), 5)])          # 16-, 4- and 1-byte copy words
@pytest.mark.parametrize("b", [1, 4])
def test_cuda_page_gather_exact(cuda, dtype, feat, page, b):
    g = torch.Generator(device=cuda).manual_seed(b)
    npg, n_phys = 9, 4 * 9 + 1
    pool = torch.randint(0, 100, (n_phys, page) + feat, generator=g,
                         device=cuda).to(dtype)
    table = torch.randint(0, n_phys, (b, npg), generator=g, device=cuda,
                          dtype=torch.int32)
    alive = torch.ones(b, dtype=torch.bool, device=cuda)
    alive[-1] = b == 1
    before = page_gather.launches
    got = page_gather(pool, table, alive)
    torch.cuda.synchronize()
    assert page_gather.launches == before + 1
    assert got.dtype == dtype
    assert torch.equal(got, ref.gather_pages_ref(pool, table, alive))
    # the view of a pool slice (one layer of the stacked engine pools)
    stacked = torch.stack([pool, pool.flip(0)])
    assert torch.equal(page_gather(stacked[1], table, alive),
                       ref.gather_pages_ref(stacked[1], table, alive))


# ---------------------------------------------------------------------------
# Codebook-quantized KV pages (kernel rows 5 and 7)
# ---------------------------------------------------------------------------

QUANT_CASES = [(bits, mode) for bits in (2, 4, 8) for mode in ("page", "head")]


def _quant_pool(g, cuda, n_phys, page, kv, hd, bits, mode):
    """Random word pools [n_phys, page, KV, Wd] (any bits, ragged last word
    included) and sorted random codebooks [n_phys, Gcb, 2**bits]."""
    wd = kvquant.words_per(hd, bits)
    gcb = kv if mode == "head" else 1
    shape = (n_phys, page, kv, wd)
    kw, vw = (torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                            device=cuda, dtype=torch.int64).to(torch.int32)
              for _ in range(2))
    kc, vc = (torch.sort(torch.randn(n_phys, gcb, 1 << bits, generator=g,
                                     device=cuda), dim=-1)[0]
              for _ in range(2))
    return kw, vw, kc, vc


@pytest.mark.cuda
@pytest.mark.parametrize("bits,mode", QUANT_CASES)
@pytest.mark.parametrize("rep,hd,page,softcap", [
    (1, 64, 16, None), (2, 128, 8, 30.0), (4, 12, 16, None)])
def test_cuda_paged_attention_quant(cuda, bits, mode, rep, hd, page,
                                    softcap):
    kv, npg, b = 2, 3, 5
    g = torch.Generator(device=cuda).manual_seed(bits * 100 + hd)
    n_phys = b * npg + 1
    kw, vw, kc, vc = _quant_pool(g, cuda, n_phys, page, kv, hd, bits, mode)
    q = 3 * torch.randn(b, 1, kv * rep, hd, generator=g, device=cuda)
    perm = torch.randperm(n_phys - 1, generator=g, device=cuda)[:b * npg] + 1
    table = perm.reshape(b, npg).to(torch.int32)
    pos = torch.tensor([0, page - 1, page, npg * page - 1, 5],
                       dtype=torch.int32, device=cuda)
    alive = torch.tensor([True, True, True, True, False], device=cuda)
    kw_ = dict(bits=bits, head_dim=hd, softcap=softcap, scale=hd ** -0.5)
    before = paged_attention_quant.launches
    got = paged_attention_quant(q, kw, vw, kc, vc, table, pos, alive, **kw_)
    torch.cuda.synchronize()
    assert paged_attention_quant.launches == before + 1
    _check_paged(got, ref.paged_attention_quant_ref(
        q, kw, vw, kc, vc, table, pos, alive, **kw_), alive)
    dead = torch.zeros_like(alive)
    got = paged_attention_quant(q, kw, vw, kc, vc, table, pos, dead, **kw_)
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.cuda
@pytest.mark.parametrize("bits,mode", QUANT_CASES)
@pytest.mark.parametrize("rep,hd,window,softcap", [
    (1, 64, None, None), (2, 12, 5, 30.0), (4, 128, None, 30.0)])
def test_cuda_blockwise_prefill_quant(cuda, bits, mode, rep, hd, window,
                                      softcap):
    b, c, kv, page, npg, start = 2, 13, 2, 8, 4, 9
    g = torch.Generator(device=cuda).manual_seed(bits * 10 + rep)
    kw, vw, kc, vc = _quant_pool(g, cuda, b * npg, page, kv, hd, bits, mode)
    s = npg * page
    view = [t.reshape((b, s) + t.shape[2:]) for t in (kw, vw)]
    cbs = [t.reshape((b, npg) + t.shape[1:]) for t in (kc, vc)]
    q = torch.randn(b, c, kv * rep, hd, generator=g, device=cuda)
    q_pos = torch.arange(start, start + c, device=cuda)
    k_pos = torch.arange(s, device=cuda)
    kw_ = dict(page_size=page, bits=bits, head_dim=hd, window=window,
               softcap=softcap, scale=hd ** -0.5)
    before = blockwise_prefill_quant.launches
    got = dispatch.blockwise_prefill_attention_quant(q, *view, *cbs, q_pos,
                                                     k_pos, **kw_)
    torch.cuda.synchronize()
    assert blockwise_prefill_quant.launches == before + 1
    want = dispatch.blockwise_prefill_attention_quant(
        q.cpu(), *(t.cpu() for t in view + cbs), q_pos.cpu(), k_pos.cpu(),
        **kw_)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["page", "head"])
def test_cuda_quant_write_path_is_deterministic_and_attended(cuda, mode):
    """Pools written by the port's quantizing write path on the card: the
    codebook fit gives the same bits on every run, and both kernels agree
    with their plain versions over what it stored."""
    bits, b, kv, hd, page, npg = 4, 3, 4, 64, 8, 4
    g = torch.Generator(device=cuda).manual_seed(7)
    table = (torch.randperm(b * npg, generator=g, device=cuda) + 1).reshape(
        b, npg).to(torch.int32)
    alive = torch.tensor([True, True, False], device=cuda)
    new = torch.randn(b, 2 * page + 3, kv, hd, generator=g, device=cuda)
    runs = []
    for _ in range(2):
        cache = attn.init_quant_paged_kv_cache(b * npg, page, kv, hd, bits,
                                               mode, device=cuda)
        attn._write_block_slot_quant(cache.k_words, cache.k_cb, table, 3,
                                     alive, new, page, bits, mode)
        runs.append(cache)
    assert torch.equal(runs[0].k_words, runs[1].k_words)
    assert torch.equal(runs[0].k_cb, runs[1].k_cb)
    words, cbs = runs[0].k_words, runs[0].k_cb
    pos = torch.tensor([2 * page + 5, 3, 0], dtype=torch.int32, device=cuda)
    q = torch.randn(b, 1, kv, hd, generator=g, device=cuda)
    kw_ = dict(bits=bits, head_dim=hd, scale=hd ** -0.5)
    got = paged_attention_quant(q, words, words, cbs, cbs, table, pos, alive,
                                **kw_)
    torch.cuda.synchronize()
    _check_paged(got, ref.paged_attention_quant_ref(
        q, words, words, cbs, cbs, table, pos, alive, **kw_), alive)
