"""The CUDA kernels of the port against their plain PyTorch versions, on
the card.  Marked ``cuda``; each skips without a CUDA device (the check
runs inside a fixture, so every worker collects the same tests).  Run on
the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no ``jax``: that machine has none.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core import compression as tc
from repro_torch.core import kvquant
from repro_torch.kernels import build, dispatch, ref
from repro_torch.kernels.blockwise_prefill import blockwise_prefill
from repro_torch.kernels.blockwise_prefill_quant import \
    blockwise_prefill_quant
from repro_torch.kernels.codebook_matmul import codebook_matmul
from repro_torch.kernels.codebook_matmul_packed import codebook_matmul_packed
from repro_torch.kernels.codebook_matmul_packed_t import \
    codebook_matmul_packed_t
from repro_torch.kernels.fixed_quant import fixed_quant
from repro_torch.kernels.kmeans_assign import kmeans_assign
from repro_torch.kernels.mla_paged_attention import mla_paged_attention
from repro_torch.kernels.mla_paged_attention_quant import \
    mla_paged_attention_quant
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
    # the deepseek-v2-lite MLA prefill: keys of nope 128 + rope 64, values
    # of 128, over one slot's 9-page view
    "mla-hd192-vd128": dict(b=1, c=64, h=16, kv=16, hd=192, vd=128, s=144,
                            start=64),
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
    v = torch.randn(p["b"], p["s"], p["kv"], p.get("vd", p["hd"]),
                    generator=g, device=cuda)
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
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("m,kd,n", [(3, 37, 70), (40, 300, 130),
                                    (4, 1024, 2816), (5, 64, 99)])
def test_cuda_codebook_matmul(cuda, k, m, kd, n):
    """Kernel row 11 (uint8 indices) against its plain version: four-byte
    index loads (N % 4 == 0) and one-byte ones, split-K at decode rows."""
    g, cb, idx = _card_operands(k, kd, n, cuda, 3 * k + m)
    idx = idx.to(torch.uint8)
    x = torch.randn(m, kd, generator=g, device=cuda)
    before = codebook_matmul.launches
    got = codebook_matmul(x, idx, cb)
    want = ref.codebook_matmul_ref(x, idx, cb)
    torch.cuda.synchronize()
    assert codebook_matmul.launches == before + 1
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    # the serving route: batched x, and a grouped (3-D) leaf decoded then
    # multiplied outside the kernel
    y = dispatch.quantized_matmul(x[None], idx, cb)
    assert codebook_matmul.launches == before + 2
    assert torch.equal(y[0], got)
    y3 = dispatch.quantized_matmul(x[:, :kd // 2], idx[None, :kd // 2], cb)
    assert codebook_matmul.launches == before + 2
    assert y3.shape == (1, m, n)


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


# ---------------------------------------------------------------------------
# MLA paged decode over latent pages (kernel rows 8 and 9)
# ---------------------------------------------------------------------------

MLA_SHAPES = {
    # a small odd shape: 3 heads, latent 40, rope 6, pages of 5
    "odd": dict(h=3, lat=40, rd=6, page=5, npg=3),
    # the deepseek-v2-lite serving decode: 16 heads, latent 512, rope 64,
    # pages of 16, 9 logical pages per slot
    "serving": dict(h=16, lat=512, rd=64, page=16, npg=9),
}


def _mla_case(cuda, h, lat, rd, page, npg, seed, b=5):
    g = torch.Generator(device=cuda).manual_seed(seed)
    n_phys = b * npg + 1
    q_eff = torch.randn(b, 1, h, lat, generator=g, device=cuda)
    q_rope = torch.randn(b, 1, h, rd, generator=g, device=cuda)
    perm = torch.randperm(n_phys - 1, generator=g, device=cuda)[:b * npg] + 1
    table = perm.reshape(b, npg).to(torch.int32)
    cap = npg * page
    pos = torch.tensor([0, page - 1, page, cap - 1, 5][:b],
                       dtype=torch.int32, device=cuda)
    alive = torch.tensor([True, True, True, True, False][:b], device=cuda)
    return g, n_phys, q_eff, q_rope, table, pos, alive


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(MLA_SHAPES))
def test_cuda_mla_paged_attention(cuda, shape):
    sh = MLA_SHAPES[shape]
    g, n_phys, q_eff, q_rope, table, pos, alive = _mla_case(
        cuda, **sh, seed=len(shape))
    c_pool = torch.randn(n_phys, sh["page"], sh["lat"], generator=g,
                         device=cuda)
    r_pool = torch.randn(n_phys, sh["page"], sh["rd"], generator=g,
                         device=cuda)
    scale = (128 + 64) ** -0.5
    before = mla_paged_attention.launches
    got = mla_paged_attention(q_eff, q_rope, c_pool, r_pool, table, pos,
                              alive, scale=scale)
    torch.cuda.synchronize()
    assert mla_paged_attention.launches == before + 1
    _check_paged(got, ref.mla_paged_attention_ref(
        q_eff, q_rope, c_pool, r_pool, table, pos, alive, scale=scale),
        alive)
    dead = torch.zeros_like(alive)
    got = mla_paged_attention(q_eff, q_rope, c_pool, r_pool, table, pos,
                              dead, scale=scale)
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", sorted(MLA_SHAPES))
@pytest.mark.parametrize("written", [True, False])
def test_cuda_mla_paged_attention_quant(cuda, bits, shape, written):
    """Row 9 against its plain version over latent word pools written by
    the port's quantizing write path (one codebook per page) or random
    words with sorted random codebooks."""
    sh = MLA_SHAPES[shape]
    g, n_phys, q_eff, q_rope, table, pos, alive = _mla_case(
        cuda, **sh, seed=bits + len(shape))
    cache = attn.init_quant_paged_mla_cache(n_phys - 1, sh["page"],
                                            sh["lat"], sh["rd"], bits,
                                            device=cuda)
    if written:
        every = torch.arange(1, n_phys, device=cuda)[None]
        one = torch.ones(1, dtype=torch.bool, device=cuda)
        for words, cbs, d in ((cache.c_words, cache.c_cb, sh["lat"]),
                              (cache.r_words, cache.r_cb, sh["rd"])):
            rows = 2 * torch.randn(1, (n_phys - 1) * sh["page"], 1, d,
                                   generator=g, device=cuda)
            attn._write_block_slot_quant(words.unsqueeze(-2), cbs, every, 0,
                                         one, rows, sh["page"], bits, "page")
    else:
        for words in (cache.c_words, cache.r_words):
            words.copy_(torch.randint(-2 ** 31, 2 ** 31 - 1, words.shape,
                                      generator=g, device=cuda,
                                      dtype=torch.int64).to(torch.int32))
        for cbs in (cache.c_cb, cache.r_cb):
            cbs.copy_(torch.sort(torch.randn(cbs.shape, generator=g,
                                             device=cuda), dim=-1)[0])
    kw = dict(bits=bits, kv_lora=sh["lat"], rope_dim=sh["rd"],
              scale=(128 + 64) ** -0.5)
    before = mla_paged_attention_quant.launches
    got = mla_paged_attention_quant(q_eff, q_rope, *cache, table, pos, alive,
                                    **kw)
    torch.cuda.synchronize()
    assert mla_paged_attention_quant.launches == before + 1
    _check_paged(got, ref.mla_paged_attention_quant_ref(
        q_eff, q_rope, *cache, table, pos, alive, **kw), alive)
    dead = torch.zeros_like(alive)
    got = mla_paged_attention_quant(q_eff, q_rope, *cache, table, pos, dead,
                                    **kw)
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.cuda
@pytest.mark.parametrize("g,p,k", [(0, 5000, 2), (0, 70001, 16),
                                   (0, 4099, 256), (3, 9999, 4),
                                   (2, 1 << 20, 16)])
def test_cuda_kmeans_assign(cuda, g, p, k):
    gen = torch.Generator(device=cuda).manual_seed(p + k)
    shape = (g, p) if g else (p,)
    w = torch.randn(shape, generator=gen, device=cuda)
    cb = torch.randn(shape[:-1] + (k,), generator=gen, device=cuda)
    cb[..., -1] = cb[..., 0]               # a tie: the lower index wins
    n0 = kmeans_assign.launches
    assign, sums, counts = kmeans_assign(w, cb)
    torch.cuda.synchronize()
    assert kmeans_assign.launches == n0 + 1
    want = ref.kmeans_assign_ref(w, cb)
    assert torch.equal(assign, want[0])
    assert torch.equal(counts, want[2])
    scale = want[1].abs().max().item()
    assert (sums - want[1]).abs().max().item() <= 1e-5 * scale
    again = kmeans_assign(w, cb)
    assert all(torch.equal(a, b) for a, b in zip(again, (assign, sums,
                                                         counts)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["binary", "ternary", "pow2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fixed_quant(cuda, mode, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = (torch.randn(8, 1000, generator=gen, device=cuda) * 0.3).to(dtype)
    n = torch.arange(0, 12, device=cuda, dtype=torch.float32)
    special = torch.cat([torch.exp2(-n), 1.5 * torch.exp2(-n),
                         torch.tensor([0.0, -0.0, 1e-40, -1e-40, 0.5],
                                      device=cuda)]).to(dtype)
    for c, scale in ((4, 1.0), (7, 1.0), (4, 0.37)):
        for x in (w, special):
            got = fixed_quant(x, mode, pow2_c=c, scale=scale)
            want = ref.fixed_quant_ref(x, mode, c, scale)
            assert got.dtype == dtype and got.shape == x.shape
            assert torch.equal(got.view(torch.int16) if dtype ==
                               torch.bfloat16 else got.view(torch.int32),
                               want.view(torch.int16) if dtype ==
                               torch.bfloat16 else want.view(torch.int32))


# ---------------------------------------------------------------------------
# Rows 4 and 10 at the engine's prefill shapes: skipped tiles, alive dtypes
# ---------------------------------------------------------------------------

def _prefill_view(g, cuda, c, h, kv, hd, s, tile, b=1, start=0, vd=None):
    """Random q and a view of s rows (random values in every row, the pad
    included) padded with sentinel positions to a tile multiple."""
    s_pad = -(-s // tile) * tile
    q = torch.randn(b, c, h, hd, generator=g, device=cuda)
    k = torch.randn(b, s_pad, kv, hd, generator=g, device=cuda)
    v = torch.randn(b, s_pad, kv, vd or hd, generator=g, device=cuda)
    k_pos = torch.full((s_pad,), ref.POS_SENTINEL, dtype=torch.int32,
                       device=cuda)
    k_pos[:s] = torch.arange(s, dtype=torch.int32, device=cuda)
    q_pos = torch.arange(start, start + c, dtype=torch.int32, device=cuda)
    return q, k, v, q_pos, k_pos


def _held_prefill(q, k, v, q_pos, k_pos, **kw):
    before = blockwise_prefill.launches
    got = blockwise_prefill(q, k, v, q_pos, k_pos, **kw)
    torch.cuda.synchronize()
    assert blockwise_prefill.launches == before + 1
    want = ref.blockwise_prefill_ref(q, k, v, q_pos, k_pos, **kw)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("start", [0, 64])
def test_cuda_blockwise_prefill_engine_view(cuda, start):
    """One slot's 64-token block over its 9-page view (144 rows padded to
    192): the tiles past the block are skipped."""
    g = torch.Generator(device=cuda).manual_seed(20 + start)
    view = _prefill_view(g, cuda, c=64, h=16, kv=16, hd=64, s=144, tile=64,
                         start=start)
    _held_prefill(*view, scale=0.125, token_tile=64)


@pytest.mark.cuda
def test_cuda_blockwise_prefill_window_skips_first_tile(cuda):
    """A window that leaves the first tile wholly invisible, GQA rep 4,
    softcap on."""
    g = torch.Generator(device=cuda).manual_seed(21)
    q, k, v, q_pos, k_pos = _prefill_view(g, cuda, c=16, h=8, kv=2, hd=64,
                                          s=128, tile=32, b=2, start=96)
    assert int(q_pos.min()) - 31 >= 40
    _held_prefill(q, k, v, q_pos, k_pos, window=40, softcap=20.0,
                  scale=0.125, token_tile=32)


@pytest.mark.cuda
def test_cuda_blockwise_prefill_queries_before_every_key(cuda):
    """No query sees any row: the output is all 0, as the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(22)
    q, k, v, q_pos, _ = _prefill_view(g, cuda, c=8, h=4, kv=4, hd=64, s=64,
                                      tile=64)
    k_pos = torch.arange(100, 164, dtype=torch.int32, device=cuda)
    got, want = _held_prefill(q, k, v, q_pos, k_pos, scale=0.125,
                              token_tile=64)
    assert torch.equal(want, torch.zeros_like(want))
    assert torch.equal(got, want)


# Launch plans of row 4 that no other case reaches on a 132-SM H100, as
# (query rows a warp, K/V buffers): one buffer where two do not fit in
# shared memory, and two rows a warp.
PREFILL_PLANS = {
    "mla-tile128-one-buffer": (dict(c=64, h=16, kv=16, hd=192, vd=128,
                                    s=144, tile=128, start=64), (1, 1)),
    "mla-tile128-one-buffer-4-rows": (dict(b=4, c=64, h=16, kv=16, hd=192,
                                           vd=128, s=144, tile=128,
                                           start=64), (4, 1)),
    "hd64-tile256-one-buffer": (dict(c=64, h=16, kv=16, hd=64, s=144,
                                     tile=256, start=64), (1, 1)),
    "b2-block-2-rows": (dict(b=2, c=64, h=16, kv=16, hd=64, s=64, tile=64),
                        (2, 2)),
    "b2-engine-view-2-rows": (dict(b=2, c=64, h=16, kv=16, hd=64, s=144,
                                   tile=64, start=64), (2, 2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PREFILL_PLANS))
def test_cuda_blockwise_prefill_launch_plans(cuda, case):
    p, want_plan = PREFILL_PLANS[case]
    g = torch.Generator(device=cuda).manual_seed(24)
    q, k, v, q_pos, k_pos = _prefill_view(g, cuda, **p)
    grid = build.function("blockwise_prefill", "repro_blockwise_prefill_grid",
                          [ctypes.c_int] * 8 + [ctypes.c_void_p] * 4)
    out = [ctypes.c_int() for _ in range(4)]
    build.check(grid(*q.shape[:3], k.shape[2], k.shape[1], q.shape[3],
                     v.shape[3], p["tile"], *(ctypes.byref(x) for x in out)),
                "blockwise_prefill")
    assert (out[2].value, out[3].value) == want_plan
    _held_prefill(q, k, v, q_pos, k_pos, scale=p["hd"] ** -0.5,
                  token_tile=p["tile"])


@pytest.mark.cuda
def test_cuda_blockwise_prefill_nan_in_unseen_v_rows(cuda):
    """A NaN in a V row no query sees: in a tile some query sees, the
    masked probability 0 multiplies it on both routes, so the kv head's
    outputs are NaN alike; in a tile no query sees, the kernel never reads
    it (the plain version, folding every tile, still multiplies it)."""
    g = torch.Generator(device=cuda).manual_seed(25)
    q, k, v, q_pos, k_pos = _prefill_view(g, cuda, c=16, h=4, kv=2, hd=64,
                                          s=100, tile=64, start=24)
    kw = dict(scale=0.125, token_tile=64)
    v[0, 50, 0] = float("nan")      # k_pos 50 > every q_pos; tile 0 is seen
    got = blockwise_prefill(q, k, v, q_pos, k_pos, **kw)
    want = ref.blockwise_prefill_ref(q, k, v, q_pos, k_pos, **kw)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(want[:, :, :2]).all()          # kv head 0's heads
    assert (got[:, :, 2:] - want[:, :, 2:]).abs().max() <= \
        1e-4 * want[:, :, 2:].abs().max()
    v[0, 50, 0] = 0.0
    v[0, 70, 0] = float("nan")      # tile 1 (rows 64..127): no query sees it
    got = blockwise_prefill(q, k, v, q_pos, k_pos, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.isnan(ref.blockwise_prefill_ref(q, k, v, q_pos, k_pos,
                                                 **kw)[:, :, :2]).all()
    v[0, 70, 0] = 0.0
    want = ref.blockwise_prefill_ref(q, k, v, q_pos, k_pos, **kw)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("alive_dtype", [torch.bool, torch.uint8,
                                         torch.int32])
@pytest.mark.parametrize("case", ["prefill-64KB-pages", "1-byte-words",
                                  "8-slots-2-dead"])
def test_cuda_page_gather_alive_dtypes(cuda, case, alive_dtype):
    g = torch.Generator(device=cuda).manual_seed(23)
    b, npg, page, feat, dtype = {
        "prefill-64KB-pages": (1, 9, 16, (16, 64), torch.float32),
        "1-byte-words": (3, 4, 5, (3,), torch.uint8),
        "8-slots-2-dead": (8, 9, 16, (16, 64), torch.float32),
    }[case]
    n_phys = b * npg + 1
    pool = torch.randint(-999, 999, (n_phys, page) + feat, generator=g,
                         device=cuda).to(dtype)
    table = 1 + torch.randperm(n_phys - 1, generator=g, device=cuda)[
        :b * npg].reshape(b, npg).to(torch.int32)
    alive = torch.ones(b, dtype=torch.bool, device=cuda)
    if b == 8:
        alive[[1, 6]] = False
    before = page_gather.launches
    got = page_gather(pool, table, alive.to(alive_dtype))
    torch.cuda.synchronize()
    assert page_gather.launches == before + 1
    assert torch.equal(got, ref.gather_pages_ref(pool, table, alive))
    for s in torch.nonzero(~alive).flatten().tolist():
        assert torch.equal(got[s], pool[0].repeat((npg,) + (1,) * len(feat)))


# ---------------------------------------------------------------------------
# Kernel rows 1 and 11 redesigned: both launch plans (decode at M <= 16,
# 3xTF32 tensor cores above) at every index width, ragged shapes included
# ---------------------------------------------------------------------------

MATMUL_MS = (1, 4, 16, 17, 64, 256)
MATMUL_KS = (2, 4, 8, 16, 32, 256)        # 1..8 bits: 3 and 5 bits pad words
MATMUL_SHAPES = ((37, 70), (1000, 130), (2816, 1024), (1024, 2816))
_MATMUL_OPERANDS = {}


def _matmul_operands(cuda, k, kd, n):
    """(codebook, uint8 indices, pack_indices_2d words) on the card, made
    once per (k, kd, n)."""
    key = (k, kd, n)
    if key not in _MATMUL_OPERANDS:
        g, cb, idx = _card_operands(k, kd, n, cuda, k + kd + n)
        words = tc.as_words(tc.pack_indices_2d(idx.cpu().numpy(), k), cuda)
        _MATMUL_OPERANDS[key] = (cb, idx.to(torch.uint8), words)
    return _MATMUL_OPERANDS[key]


def _hold_matmul(fn, x, operand, cb, want):
    """Two calls: equal bits, one launch each, within 1e-4 x max |y|."""
    before = fn.launches
    got = fn(x, operand, cb)
    again = fn(x, operand, cb)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(got, again)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("kd,n", MATMUL_SHAPES)
@pytest.mark.parametrize("k", MATMUL_KS)
@pytest.mark.parametrize("m", MATMUL_MS)
def test_cuda_codebook_matmul_packed_plans(cuda, m, k, kd, n):
    cb, _, words = _matmul_operands(cuda, k, kd, n)
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, kd, generator=g, device=cuda)
    _hold_matmul(codebook_matmul_packed, x, words, cb,
                 ref.packed_codebook_matmul_ref(x, words, cb))


@pytest.mark.cuda
@pytest.mark.parametrize("kd,n", MATMUL_SHAPES)
@pytest.mark.parametrize("k", MATMUL_KS)
@pytest.mark.parametrize("m", MATMUL_MS)
def test_cuda_codebook_matmul_plans(cuda, m, k, kd, n):
    cb, idx, _ = _matmul_operands(cuda, k, kd, n)
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, kd, generator=g, device=cuda)
    _hold_matmul(codebook_matmul, x, idx, cb,
                 ref.codebook_matmul_ref(x, idx, cb))


@pytest.mark.cuda
def test_cuda_codebook_matmul_step_rows_match_the_plans(cuda):
    """The host's launch plans count K steps as the kernels stage them."""
    from repro_torch.kernels.codebook_matmul import STAGES, STEP_ROWS
    from repro_torch.kernels.codebook_matmul_packed import (TC_COLS, step_rows,
                                                            tc_smem_bytes)
    packed = build.function("codebook_matmul_packed",
                            "repro_codebook_matmul_packed_step_rows",
                            [ctypes.c_int])
    assert [packed(bits) for bits in range(1, 9)] == [
        step_rows(bits) for bits in range(1, 9)]
    assert build.function("codebook_matmul",
                          "repro_codebook_matmul_step_rows", [])() == STEP_ROWS
    # and their shared memory (the plans' residency) as the kernels lay it out
    packed_smem = build.function("codebook_matmul_packed",
                                 "repro_codebook_matmul_packed_tc_smem",
                                 [ctypes.c_int, ctypes.c_int])
    uint8_smem = build.function("codebook_matmul",
                                "repro_codebook_matmul_tc_smem",
                                [ctypes.c_int])
    for cols in TC_COLS:
        for bits in range(1, 9):
            rows, lanes = step_rows(bits), 32 // bits
            assert packed_smem(bits, cols) == tc_smem_bytes(
                rows, cols, rows // lanes * (cols + 8) * 4, 1 << bits)
        assert uint8_smem(cols) == tc_smem_bytes(
            STEP_ROWS, cols, STEP_ROWS * (cols + 4), 256, STAGES)


@pytest.mark.cuda
@pytest.mark.parametrize("write", ["slot", "block"])
def test_cuda_dense_trash_page_writes_are_deterministic(cuda, write):
    """Dead slots colliding on the trash page: two dense writes on the card
    leave equal pools, page 0 included, equal to the CPU route's."""
    g = torch.Generator(device=cuda).manual_seed(11)
    b, page, npg, kv, hd = 8, 8, 9, 4, 64
    table = (torch.randperm(b * npg, generator=g, device=cuda) + 1).reshape(
        b, npg).to(torch.int32)
    alive = torch.tensor([1, 0, 0, 1, 0, 0, 0, 1], dtype=torch.bool,
                         device=cuda)
    if write == "block":
        # five dead slots write 64 rows each into page 0's 8 cells
        new = torch.randn(b, 64, kv, hd, generator=g, device=cuda)
        fn, args = attn._write_block_slot, (table, 3, alive, new, page)
    else:
        # every dead slot writes offset 5 of page 0
        new = torch.randn(b, kv, hd, generator=g, device=cuda)
        pos = torch.tensor([5, 13, 21, 29, 5, 13, 45, 60], dtype=torch.int32,
                           device=cuda)
        fn, args = attn._write_slot, (table, pos, alive, new, page)
    shape = (b * npg + 1, page, kv, hd)
    pools = [fn(torch.zeros(shape, device=cuda), *args) for _ in range(2)]
    cpu = fn(torch.zeros(shape),
             *(a.cpu() if torch.is_tensor(a) else a for a in args))
    torch.cuda.synchronize()
    assert torch.equal(pools[0], pools[1])
    assert torch.equal(pools[0].cpu(), cpu)


# --- rows 6 and 8 split over pages: the plans' boundaries ------------------

SPLIT_NPG = (1, 9, 17, 256)


def _split_pos(pages, page, npg):
    """pos at the last row of split 0, the first row of split 1, the last
    row, a slot whose rows all lie in split 0, and a dead slot's."""
    cap, edge = npg * page, pages * page
    pos = [min(edge - 1, cap - 1), min(edge, cap - 1), cap - 1,
           min(3, cap - 1), 5]
    return pos, [True, True, True, True, False]


def _poison_past_pos(pool, table, pos, alive):
    """A copy of the pool with NaN in every row that no slot sees."""
    keep = torch.zeros(pool.shape[:2], dtype=torch.bool, device=pool.device)
    page = pool.shape[1]
    for b in range(table.shape[0]):
        if alive[b]:
            s = torch.arange(int(pos[b]) + 1, device=pool.device)
            keep[table[b].long()[s // page], s % page] = True
    out = torch.full_like(pool, float("nan"))
    out[keep] = pool[keep]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("npg", SPLIT_NPG)
@pytest.mark.parametrize("kv,rep,hd,page,softcap", [
    (16, 1, 64, 16, None), (2, 2, 12, 8, 30.0), (2, 5, 128, 16, None)])
def test_cuda_paged_attention_split_boundaries(cuda, npg, kv, rep, hd, page,
                                               softcap):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.codebook_matmul_packed import sm_count
    b = 5
    q, kp, vp, table = _paged_operands(cuda, b, kv * rep, kv, hd, page, npg,
                                       npg + hd)
    plan = pa.plan(b, kv, rep, npg, sm_count(cuda.index))
    pos, alive = _split_pos(plan.pages, page, npg)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    alive = torch.tensor(alive, device=cuda)
    kw = dict(softcap=softcap, scale=hd ** -0.5)
    before = paged_attention.launches
    got = paged_attention(q, kp, vp, table, pos, alive, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    _check_paged(got, ref.paged_attention_ref(q, kp, vp, table, pos, alive,
                                              **kw), alive)
    again = paged_attention(q, kp, vp, table, pos, alive, **kw)
    assert torch.equal(again, got)              # a fixed merge order


@pytest.mark.cuda
@pytest.mark.parametrize("npg", (9, 17))
def test_cuda_paged_attention_nan_past_pos(cuda, npg):
    q, kp, vp, table = _paged_operands(cuda, 5, 16, 16, 64, 16, npg, npg)
    pos, alive = _split_pos(2, 16, npg)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    alive = torch.tensor(alive, device=cuda)
    got = paged_attention(q, _poison_past_pos(kp, table, pos, alive),
                          _poison_past_pos(vp, table, pos, alive), table, pos,
                          alive, scale=0.125)
    torch.cuda.synchronize()
    _check_paged(got, ref.paged_attention_ref(q, kp, vp, table, pos, alive,
                                              scale=0.125), alive)


def _mla_split_operands(cuda, sh, npg, seed, b=5):
    g = torch.Generator(device=cuda).manual_seed(seed)
    n_phys = b * npg + 1
    q_eff = torch.randn(b, 1, sh["h"], sh["lat"], generator=g, device=cuda)
    q_rope = torch.randn(b, 1, sh["h"], sh["rd"], generator=g, device=cuda)
    c_pool = torch.randn(n_phys, sh["page"], sh["lat"], generator=g,
                         device=cuda)
    r_pool = torch.randn(n_phys, sh["page"], sh["rd"], generator=g,
                         device=cuda)
    perm = torch.randperm(n_phys - 1, generator=g, device=cuda)[:b * npg] + 1
    return q_eff, q_rope, c_pool, r_pool, perm.reshape(b, npg).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("npg", SPLIT_NPG)
@pytest.mark.parametrize("shape", sorted(MLA_SHAPES))
def test_cuda_mla_paged_attention_split_boundaries(cuda, npg, shape):
    from repro_torch.kernels import mla_paged_attention as mpa
    from repro_torch.kernels.codebook_matmul_packed import sm_count
    sh = MLA_SHAPES[shape]
    q_eff, q_rope, c_pool, r_pool, table = _mla_split_operands(
        cuda, sh, npg, npg + len(shape))
    plan = mpa.plan(5, sh["h"], npg, sm_count(cuda.index))
    pos, alive = _split_pos(plan.pages, sh["page"], npg)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    alive = torch.tensor(alive, device=cuda)
    scale = (128 + 64) ** -0.5
    before = mla_paged_attention.launches
    got = mla_paged_attention(q_eff, q_rope, c_pool, r_pool, table, pos,
                              alive, scale=scale)
    torch.cuda.synchronize()
    assert mla_paged_attention.launches == before + 1
    _check_paged(got, ref.mla_paged_attention_ref(
        q_eff, q_rope, c_pool, r_pool, table, pos, alive, scale=scale),
        alive)
    again = mla_paged_attention(q_eff, q_rope, c_pool, r_pool, table, pos,
                                alive, scale=scale)
    assert torch.equal(again, got)              # a fixed merge order


@pytest.mark.cuda
@pytest.mark.parametrize("npg", (9, 17))
def test_cuda_mla_paged_attention_nan_past_pos(cuda, npg):
    sh = MLA_SHAPES["serving"]
    q_eff, q_rope, c_pool, r_pool, table = _mla_split_operands(cuda, sh, npg,
                                                               npg)
    pos, alive = _split_pos(2, sh["page"], npg)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    alive = torch.tensor(alive, device=cuda)
    scale = (128 + 64) ** -0.5
    got = mla_paged_attention(
        q_eff, q_rope, _poison_past_pos(c_pool, table, pos, alive),
        _poison_past_pos(r_pool, table, pos, alive), table, pos, alive,
        scale=scale)
    torch.cuda.synchronize()
    _check_paged(got, ref.mla_paged_attention_ref(
        q_eff, q_rope, c_pool, r_pool, table, pos, alive, scale=scale),
        alive)
