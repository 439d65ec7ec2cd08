"""The port's codebook-quantized KV cache held against the reference on the
CPU: the codebook fit (quantile seeding + exact 1-D k-means) bit for bit,
assignment / packing / dequant exactly, the quantizing page writes (words
and codebooks equal to the reference's after every write), the plain
versions of the two quantized attention kernels against the reference's
jnp oracles and its Pallas kernels (interpret mode), and the engine's
token streams at ``kv_bits`` 4 and 8 against the reference's ``Engine``.
The ``cuda``-marked kernel-vs-plain tests on the card are in
``tests/test_torch_cuda.py``.

The reference's functions run here under ``jax.jit``, as its engine steps
run them.  Their bits depend on it: called eagerly, ``jnp.quantile``
compiles alone and XLA contracts its interpolation ``lo·(1−w) + hi·w``
into a fused multiply-add over the second product; inside any jitted
program, over the first.  The port follows the jitted form.

Word pools are int32 bit patterns in the port and uint32 in the reference;
they compare through ``.view(np.uint32)``.
"""
import functools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.zoo import tiny_cfg as ref_tiny_cfg
from repro.core import PackedModel as RefPackedModel
from repro.core import kmeans as jkmeans
from repro.core import kvquant as jkvquant
from repro.core.compression import pack_rows as ref_pack_rows
from repro.engine import Engine as RefEngine
from repro.engine import Request as RefRequest
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch import configs
from repro_torch.core import kmeans, kvquant
from repro_torch.core.compression import PackedModel, unpack_rows
from repro_torch.engine import Engine, Outcome, Request
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.blockwise_prefill_quant import \
    blockwise_prefill_quant
from repro_torch.kernels.paged_attention_quant import paged_attention_quant
from repro_torch.models import attention as attn

# The shapes here are tiny: one torch thread per test worker keeps torch's
# thread pool off the cores the reference's JAX tests compile on.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "pr2_mlp_only")
CFG = configs.tiny_cfg(tie=True)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _u32(x) -> np.ndarray:
    """A word pool (port int32 or reference uint32) as uint32 bits."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint32)


def _jit(fn, **static):
    """``fn`` with keyword arguments fixed, under ``jax.jit``."""
    return jax.jit(functools.partial(fn, **static))


def _bits(x) -> np.ndarray:
    """f32 values as their bit patterns (tells -0.0 from 0.0)."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# The codebook fit, bit for bit
# ---------------------------------------------------------------------------

def _groups(n: int, seed: int) -> np.ndarray:
    """[1, 6, n] groups: Gaussian at three scales, one with repeated
    values (signed zeros among them), one constant, one heavy-tailed."""
    rng = np.random.RandomState(seed)
    g = rng.randn(6, n).astype(np.float32)
    g[0] *= 0.01
    g[1] *= 30.0
    g[2] = np.round(g[2] * 2) / 2           # repeats, -0.0 and 0.0
    g[3] = np.round(g[3] * 0.01 * 2) / 2    # almost all (signed) zeros
    g[4] = 1.25
    g[5] = rng.standard_cauchy(n).astype(np.float32)
    return g[None]


@pytest.mark.parametrize("n", [1, 16, 64, 1024])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fit_codebooks_bit_identical_to_reference(bits, n):
    """Group sizes 1 and 16 hold fewer values than K = 256 (and 1 fewer
    than every K): empty clusters keep their quantile seeds."""
    vals = _groups(n, 100 * bits + n)
    want = _jit(jkvquant.fit_codebooks, bits=bits)(jnp.asarray(vals))
    got = kvquant.fit_codebooks(torch.from_numpy(vals), bits)
    assert tuple(got.shape) == (1, 6, 1 << bits)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantile_init_and_kmeans_fit_match_reference(bits):
    """Single fits (the reference's un-vmapped call) at 30 iterations:
    seeds, codebooks, assignments and iteration counts exact.  The
    distortion is a sum whose order differs (XLA splits a long row
    reduction into windows of 32), so it is held to a few ulps."""
    k = 1 << bits
    jinit = _jit(jkmeans.quantile_init, k=k)
    jfit = _jit(jkmeans.kmeans_fit, iters=30)
    for n in (5, 64, 700):
        for row in _groups(n, bits + n)[0]:
            seed = kmeans.quantile_init(torch.from_numpy(row), k)
            jseed = jinit(jnp.asarray(row))
            np.testing.assert_array_equal(_bits(seed), _bits(jseed))
            got = kmeans.kmeans_fit(torch.from_numpy(row), seed, iters=30)
            want = jfit(jnp.asarray(row), jseed)
            np.testing.assert_array_equal(_bits(got.codebook),
                                          _bits(want.codebook))
            np.testing.assert_array_equal(got.assignments.numpy(),
                                          np.asarray(want.assignments))
            assert int(got.iters_run) == int(want.iters_run)
            np.testing.assert_allclose(float(got.distortion),
                                       float(want.distortion), rtol=1e-6)


def test_kmeans_batch_rows_fit_independently():
    """A row's fit does not depend on the rows batched with it: the
    convergence flags are per row."""
    vals = torch.from_numpy(_groups(64, 3)[0])
    seeds = kmeans.quantile_init(vals, 16)
    batch = kmeans.kmeans_fit(vals, seeds, iters=8)
    for i in range(vals.shape[0]):
        one = kmeans.kmeans_fit(vals[i], seeds[i], iters=8)
        assert torch.equal(one.codebook, batch.codebook[i])
        assert int(one.iters_run) == int(batch.iters_run[i])
    assert len(set(batch.iters_run.tolist())) > 1


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_assign_pack_dequant_exact(bits):
    rng = np.random.RandomState(bits)
    vals = rng.randn(3, 2, 21).astype(np.float32)
    cbs = np.sort(rng.randn(3, 2, 1 << bits), -1).astype(np.float32)
    # values on midpoints go to the larger index (eq. 11)
    vals[0, 0, :3] = 0.5 * (cbs[0, 0, 1:4] + cbs[0, 0, :3])
    idx = kvquant.assign_codebook(*_t(vals, cbs))
    want = np.asarray(jkvquant.assign_codebook(*_j(vals, cbs)))
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(idx.numpy()[0, 0, :3], [1, 2, 3])
    words = kvquant.pack_rows_torch(idx, bits)
    assert words.dtype == torch.int32
    jwords = jkvquant.pack_rows_jnp(jnp.asarray(want), bits)
    np.testing.assert_array_equal(_u32(words), _u32(jwords))
    np.testing.assert_array_equal(
        _u32(words).reshape(6, -1), ref_pack_rows(want.reshape(6, 21),
                                                  1 << bits))
    np.testing.assert_array_equal(
        kvquant.dequant_codebook(idx, torch.from_numpy(cbs)).numpy(),
        np.asarray(jkvquant.dequant_codebook(jnp.asarray(want),
                                             jnp.asarray(cbs))))


# ---------------------------------------------------------------------------
# Quantizing page writes: words and codebooks equal to the reference's
# ---------------------------------------------------------------------------

NPH, PAGE, KV, HD = 9, 4, 2, 8     # 8 usable pages of 4 rows, 2 kv heads


def _pools(bits, mode):
    cache = attn.init_quant_paged_kv_cache(NPH - 1, PAGE, KV, HD, bits, mode)
    jcache = jattn.init_quant_paged_kv_cache(NPH - 1, PAGE, KV, HD, bits,
                                             mode, jnp.float32)
    return [cache.k_words, cache.k_cb], [jcache.k_words, jcache.k_cb]


def _assert_pools_equal(port, ref_pools, label):
    np.testing.assert_array_equal(_u32(port[0]), _u32(ref_pools[0]),
                                  err_msg=f"{label}: words")
    np.testing.assert_array_equal(_bits(port[1]), _bits(ref_pools[1]),
                                  err_msg=f"{label}: codebooks")


@pytest.mark.parametrize("mode", ["page", "head"])
def test_write_slot_quant_equals_reference(mode):
    """Decode writes of 3 slots over 6 steps (pages started, continued and
    crossed; slot 1 dead for the middle steps, writing the trash page)."""
    bits = 4
    port, ref_pools = _pools(bits, mode)
    jwrite = _jit(jattn._write_slot_quant, page_size=PAGE, bits=bits,
                  cb_mode=mode)
    table = np.array([[3, 5, 1], [2, 0, 0], [7, 4, 6]], np.int32)
    rng = np.random.RandomState(11)
    for step in range(6):
        pos = np.array([step, 2 + step, 3 + step], np.int32)
        alive = np.array([True, step not in (2, 3), True])
        new = rng.randn(3, KV, HD).astype(np.float32)
        attn._write_slot_quant(*port, *_t(table, pos, alive, new), PAGE,
                               bits, mode)
        ref_pools = list(jwrite(*ref_pools, *_j(table, pos, alive, new)))
        _assert_pools_equal(port, ref_pools, f"step {step}")


@pytest.mark.parametrize("mode", ["page", "head"])
def test_write_block_slot_quant_equals_reference(mode):
    """A block of 10 tokens from position 3 crosses two page boundaries
    (offset 0 of two pages inside it) for a live slot while a dead slot's
    block lands on the trash page; then, on pools restored from the
    reference's, a second block and a decode write continue the pages
    (their codebooks frozen by the first block)."""
    bits = 8 if mode == "head" else 2
    port, ref_pools = _pools(bits, mode)
    kw = dict(page_size=PAGE, bits=bits, cb_mode=mode)
    jblock = _jit(jattn._write_block_slot_quant, **kw)
    jwrite = _jit(jattn._write_slot_quant, **kw)
    table = np.array([[6, 2, 8, 4], [1, 3, 5, 7]], np.int32)
    alive = np.array([True, False])
    rng = np.random.RandomState(12)
    new = rng.randn(2, 10, KV, HD).astype(np.float32)
    attn._write_block_slot_quant(*port, *_t(table), 3, *_t(alive, new), PAGE,
                                 bits, mode)
    ref_pools = list(jblock(*ref_pools, *_j(table), 3, *_j(alive, new)))
    _assert_pools_equal(port, ref_pools, "first block")
    # restore: the port continues from the reference's stored pools
    port = [torch.from_numpy(_u32(ref_pools[0]).view(np.int32).copy()),
            torch.from_numpy(np.array(ref_pools[1]))]
    alive = np.array([True, True])
    new = rng.randn(2, 2, KV, HD).astype(np.float32)
    attn._write_block_slot_quant(*port, *_t(table), 13, *_t(alive, new),
                                 PAGE, bits, mode)
    ref_pools = list(jblock(*ref_pools, *_j(table), 13, *_j(alive, new)))
    _assert_pools_equal(port, ref_pools, "block after restore")
    pos = np.array([15, 2], np.int32)
    new = rng.randn(2, KV, HD).astype(np.float32)
    attn._write_slot_quant(*port, *_t(table, pos, alive, new), PAGE, bits,
                           mode)
    ref_pools = list(jwrite(*ref_pools, *_j(table, pos, alive, new)))
    _assert_pools_equal(port, ref_pools, "decode after restore")


def test_write_slot_quant_freezes_codebook_on_first_write():
    """The reference's freeze-on-first-write test inside the port: the
    first write of a page fits its codebook, a later in-page write reuses
    it verbatim, replaying the writes gives the same bits, and the stored
    rows are assign-then-lookup of the written values."""
    bits, b = 4, 3
    table = torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 0]])
    alive = torch.ones(b, dtype=torch.bool)
    rng = np.random.RandomState(10)
    v0, v1 = (torch.from_numpy(rng.randn(b, KV, HD).astype(np.float32))
              for _ in range(2))

    def writes():
        cache = attn.init_quant_paged_kv_cache(NPH - 1, PAGE, KV, HD, bits,
                                               "page")
        w, c = cache.k_words, cache.k_cb
        attn._write_slot_quant(w, c, table, torch.zeros(b, dtype=torch.int32),
                               alive, v0, PAGE, bits, "page")
        c1 = c.clone()
        attn._write_slot_quant(w, c, table, torch.ones(b, dtype=torch.int32),
                               alive, v1, PAGE, bits, "page")
        return w, c1, c

    w2, c1, c2 = writes()
    phys = table[:, 0]
    assert torch.equal(c2[phys], c1[phys])
    w2b, _, c2b = writes()
    assert torch.equal(w2, w2b) and torch.equal(c2, c2b)
    for i in range(b):
        for off, v in ((0, v0), (1, v1)):
            row = unpack_rows(w2[phys[i], off], HD, 1 << bits)
            want = kvquant.assign_codebook(v[i].reshape(1, -1),
                                           c2[phys[i]]).reshape(KV, HD)
            assert torch.equal(row, want)


# ---------------------------------------------------------------------------
# The plain quantized attention kernels against the reference
# ---------------------------------------------------------------------------

B, NPG = 4, 3
TBL = np.array([[3, 7, 0], [5, 0, 0], [1, 2, 4], [8, 6, 5]], np.int32)
POS = np.array([0, 3, 4, 11], np.int32)
ALIVE = np.array([True, True, False, True])


@functools.lru_cache(maxsize=None)
def _quant_case(bits: int, mode: str, rep: int):
    """Random words (ragged last word: head dim 12) and sorted codebooks
    for 9 pages, and q for 4 slots."""
    rng = np.random.RandomState(bits + rep)
    hd = 12
    wd = kvquant.words_per(hd, bits)
    gcb = KV if mode == "head" else 1
    kw, vw = (rng.randint(0, 2 ** 32, size=(NPH, PAGE, KV, wd),
                          dtype=np.uint64).astype(np.uint32)
              for _ in range(2))
    kc, vc = (np.sort(rng.randn(NPH, gcb, 1 << bits), -1).astype(np.float32)
              for _ in range(2))
    q = (3 * rng.randn(B, 1, KV * rep, hd)).astype(np.float32)
    return q, kw, vw, kc, vc, hd


def _port_words(*words):
    return [torch.from_numpy(w.view(np.int32)) for w in words]


@pytest.mark.parametrize("bits,mode,rep,softcap", [
    (2, "page", 1, None), (4, "head", 2, 30.0), (8, "page", 2, None),
    (4, "page", 1, 30.0)])
def test_paged_attention_quant_plain_vs_reference_and_pallas(bits, mode, rep,
                                                             softcap):
    q, kw, vw, kc, vc, hd = _quant_case(bits, mode, rep)
    kws = dict(bits=bits, head_dim=hd, softcap=softcap, scale=hd ** -0.5)
    want = np.asarray(jref.paged_attention_quant_ref(
        *_j(q, kw, vw, kc, vc, TBL, POS, ALIVE), **kws))
    pallas = np.asarray(jops.paged_attention_quant(
        *_j(q, kw, vw, kc, vc, TBL, POS, ALIVE), interpret=True, **kws))
    got = paged_attention_quant(torch.from_numpy(q), *_port_words(kw, vw),
                                *_t(kc, vc, TBL, POS, ALIVE), **kws)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy()[ALIVE], pallas[ALIVE], **TOL)
    np.testing.assert_array_equal(pallas[2], 0.0)
    # uint32 words take the same plain route
    again = dispatch.paged_attention_quant(
        *_t(q, kw, vw, kc, vc, TBL, POS, ALIVE), **kws)
    assert torch.equal(again, got)


@pytest.mark.parametrize("bits,mode,rep,window,softcap", [
    (2, "head", 1, None, None), (4, "page", 2, 5, 30.0),
    (8, "head", 2, None, 30.0)])
def test_blockwise_prefill_quant_plain_vs_reference_and_pallas(
        bits, mode, rep, window, softcap):
    q, kw, vw, kc, vc, hd = _quant_case(bits, mode, rep)
    # a 2-slot view of 4 pages each (pages 1..8), 6 queries from position 9
    view = [w[1:].reshape(2, 4 * PAGE, KV, -1) for w in (kw, vw)]
    cbs = [c[1:].reshape(2, 4, *c.shape[1:]) for c in (kc, vc)]
    qq = np.concatenate([q[:2]] * 6, axis=1)            # [2, 6, H, hd]
    q_pos = np.arange(9, 15, dtype=np.int32)
    k_pos = np.arange(4 * PAGE, dtype=np.int32)
    kws = dict(page_size=PAGE, bits=bits, head_dim=hd, window=window,
               softcap=softcap, scale=hd ** -0.5)
    tile = dispatch.prefill_token_tile("quant", hd, page_size=PAGE)
    want = np.asarray(jref.blockwise_prefill_quant_ref(
        *_j(qq, *view, *cbs, q_pos, k_pos), token_tile=tile, **kws))
    pallas = np.asarray(jops.blockwise_prefill_quant(
        *_j(qq, *view, *cbs, q_pos, k_pos), token_tile=tile, interpret=True,
        **kws))
    got = blockwise_prefill_quant(torch.from_numpy(qq), *_port_words(*view),
                                  *_t(*cbs, q_pos, k_pos), token_tile=tile,
                                  **kws)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    routed = dispatch.blockwise_prefill_attention_quant(
        torch.from_numpy(qq), *_port_words(*view), *_t(*cbs, q_pos, k_pos),
        **kws)
    assert torch.equal(routed, got)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("mode", ["page", "head"])
def test_quant_plain_equals_dense_plain_on_dequantized_pools(bits, mode):
    """Inside the port, bit for bit: the quantized plain versions are the
    dense ones over the dequantized pools / view."""
    q, kw, vw, kc, vc, hd = _quant_case(bits, mode, 2)
    kt, vt = _port_words(kw, vw)
    kct, vct, tbl, pos, alive = _t(kc, vc, TBL, POS, ALIVE)
    all_pages = torch.arange(NPH)[None]
    kd = ref.dequant_pages_ref(kt, kct, all_pages, torch.ones(1, dtype=bool),
                               hd, bits).reshape(NPH, PAGE, KV, hd)
    vd = ref.dequant_pages_ref(vt, vct, all_pages, torch.ones(1, dtype=bool),
                               hd, bits).reshape(NPH, PAGE, KV, hd)
    kws = dict(softcap=30.0, scale=hd ** -0.5)
    got = ref.paged_attention_quant_ref(torch.from_numpy(q), kt, vt, kct,
                                        vct, tbl, pos, alive, bits=bits,
                                        head_dim=hd, **kws)
    assert torch.equal(got, ref.paged_attention_ref(
        torch.from_numpy(q), kd, vd, tbl, pos, alive, **kws))
    view_tbl = torch.arange(1, NPH).reshape(2, 4)
    live = torch.ones(2, dtype=torch.bool)
    kv_view = ref.gather_pages_ref(kt, view_tbl, live)
    vv_view = ref.gather_pages_ref(vt, view_tbl, live)
    qq = torch.from_numpy(np.concatenate([q[:2]] * 3, axis=1))
    q_pos, k_pos = torch.arange(5, 8), torch.arange(4 * PAGE)
    pkw = dict(scale=hd ** -0.5, token_tile=2)
    got = ref.blockwise_prefill_quant_ref(
        qq, kv_view, vv_view, kct[view_tbl], vct[view_tbl], q_pos, k_pos,
        page_size=PAGE, bits=bits, head_dim=hd, **pkw)
    want = ref.blockwise_prefill_ref(
        qq, ref.gather_pages_ref(kd, view_tbl, live),
        ref.gather_pages_ref(vd, view_tbl, live), q_pos, k_pos, **pkw)
    assert torch.equal(got, want)


def test_quant_wrappers_check_operands_and_do_not_count_on_cpu():
    q, kw, vw, kc, vc, hd = _quant_case(4, "head", 1)
    kt, vt = _port_words(kw, vw)
    args = _t(kc, vc, TBL, POS, ALIVE)
    dispatch.reset_launch_counts()
    with pytest.raises(ValueError, match="word operand width"):
        paged_attention_quant(torch.from_numpy(q), kt, vt, *args, bits=8,
                              head_dim=hd, scale=1.0)
    with pytest.raises(ValueError, match="codebook K"):
        paged_attention_quant(torch.from_numpy(q), kt, vt, args[0][..., :8],
                              args[1][..., :8], *args[2:], bits=4,
                              head_dim=hd, scale=1.0)
    with pytest.raises(ValueError, match="kv_bits"):
        paged_attention_quant(torch.from_numpy(q), kt, vt, *args, bits=3,
                              head_dim=hd, scale=1.0)
    with pytest.raises(ValueError, match="must divide"):
        blockwise_prefill_quant(
            torch.zeros(1, 2, 2, hd), kt[1:3].reshape(1, 8, KV, -1),
            vt[1:3].reshape(1, 8, KV, -1), args[0][1:3][None],
            args[1][1:3][None], torch.arange(2), torch.arange(8),
            page_size=PAGE, bits=4, head_dim=hd, scale=1.0, token_tile=3)
    paged_attention_quant(torch.from_numpy(q), kt, vt, *args, bits=4,
                          head_dim=hd, scale=1.0)
    assert dispatch.launch_counts() == {n: 0 for n in dispatch.KERNELS}


# ---------------------------------------------------------------------------
# Quantized paged GQA layer steps against the reference's
# ---------------------------------------------------------------------------

D_MODEL, H = 16, 4
LAYER_KW = dict(n_heads=H, n_kv=KV, head_dim=HD, page_size=PAGE,
                rope_theta=1e4)


def _layer():
    rng = np.random.RandomState(5)
    p = {"wq": rng.randn(D_MODEL, H * HD), "wk": rng.randn(D_MODEL, KV * HD),
         "wv": rng.randn(D_MODEL, KV * HD), "wo": rng.randn(H * HD, D_MODEL),
         "q_bias": rng.randn(H * HD), "k_bias": rng.randn(KV * HD),
         "v_bias": rng.randn(KV * HD)}
    p = {k: (0.3 * v).astype(np.float32) for k, v in p.items()}
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


def _assert_caches_match(cache, jcache):
    """Words exact (the trash page aside: dead slots write it), codebooks
    allclose: the layer's K/V come out of projections and RoPE that round
    differently in torch and XLA, and the fits see those values."""
    for a, b in ((cache.k_words, jcache.k_words),
                 (cache.v_words, jcache.v_words)):
        np.testing.assert_array_equal(_u32(a)[1:], _u32(b)[1:])
    for a, b in ((cache.k_cb, jcache.k_cb), (cache.v_cb, jcache.v_cb)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("bits,mode", [(4, "page"), (8, "head")])
def test_quant_layer_prefill_and_decode_match_reference(bits, mode):
    tp, jp = _layer()
    kw = dict(LAYER_KW, kv_bits=bits, kv_cb_mode=mode)
    cache = attn.init_quant_paged_kv_cache(NPH - 1, PAGE, KV, HD, bits, mode)
    jcache = jattn.init_quant_paged_kv_cache(NPH - 1, PAGE, KV, HD, bits,
                                             mode, jnp.float32)
    jprefill = _jit(jattn.gqa_prefill_block_paged_quant, **kw)
    jdecode = _jit(jattn.gqa_decode_paged_quant, **kw)
    table = np.array([[6, 2, 3, 8]], np.int32)
    x = np.random.RandomState(7).randn(1, 6, D_MODEL).astype(np.float32)
    one = np.ones(1, bool)
    for start in (0, 6):
        got, cache = attn.gqa_prefill_block_paged_quant(
            tp, *_t(x), cache, *_t(table), start, *_t(one), **kw)
        want, jcache = jprefill(jp, *_j(x), jcache, *_j(table), start,
                                *_j(one))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _assert_caches_match(cache, jcache)
    # decode on top of the prefilled pages: two slots, one dead
    table = np.array([[6, 2, 3, 8], [1, 4, 0, 0]], np.int32)
    x = np.random.RandomState(8).randn(2, 1, D_MODEL).astype(np.float32)
    for pos in ((12, 0), (13, 0)):
        pos = np.array(pos, np.int32)
        alive = np.array([True, False])
        got, cache = attn.gqa_decode_paged_quant(
            tp, *_t(x), cache, *_t(table, pos, alive), **kw)
        want, jcache = jdecode(jp, *_j(x), jcache, *_j(table, pos, alive))
        np.testing.assert_allclose(got.numpy()[:1], np.asarray(want)[:1],
                                   **TOL)
        _assert_caches_match(cache, jcache)


# ---------------------------------------------------------------------------
# The engine on quantized pages against the reference's engine
# ---------------------------------------------------------------------------

# tests/test_engine.py's long-prompt geometry: 40-token prompts run as five
# 8-token prefill blocks each, pages of 8
LONG_GEO = dict(page_size=8, max_seq=64, prefill_chunk=8, token_budget=10)


@functools.lru_cache(maxsize=None)
def _artifacts():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return PackedModel.load(FIXTURE), RefPackedModel.load(FIXTURE)


def _long_requests():
    prompts = np.random.RandomState(47).randint(0, CFG.vocab, size=(3, 40))
    return [dict(rid=r, prompt=prompts[r], max_new_tokens=[6, 3, 5][r])
            for r in range(3)]


@pytest.mark.parametrize("kv_bits,mode", [(4, "page"), (4, "head"),
                                          (8, "page")])
def test_engine_quant_streams_equal_reference_engine(kv_bits, mode):
    pm, rpm = _artifacts()
    reqs = _long_requests()
    kvq = dict(kv_bits=kv_bits, kv_cb_mode=mode)
    want = RefEngine(rpm.serving_params(packed=True), ref_tiny_cfg(tie=True),
                     n_slots=2, **LONG_GEO, **kvq).run(
        [RefRequest(**r) for r in reqs])
    for n_slots in (2, 3):
        eng = Engine(pm.serving_params(packed=True), CFG, n_slots=n_slots,
                     **LONG_GEO, **kvq)
        assert eng.cfg.kv_bits == kv_bits and eng.cfg.kv_cb_mode == mode
        outs = eng.run([Request(**r) for r in reqs])
        assert sorted(outs) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(outs[rid], np.asarray(want[rid]),
                                          err_msg=f"{n_slots} slots, "
                                                  f"rid {rid}")
        st = eng.stats
        assert st.prefill_calls == 3 * 5
        assert st.generated_tokens == st.decode_tokens + st.prefill_samples
    c = eng.caches[0]["pos0"]
    assert c.k_words.dtype == torch.int32
    assert c.k_cb.shape[-2:] == ((CFG.n_kv if mode == "head" else 1),
                                 1 << kv_bits)


def test_engine_rejects_bad_kv_knobs():
    pm, _ = _artifacts()
    params = pm.serving_params(packed=True)
    with pytest.raises(ValueError, match="kv_bits"):
        Engine(params, CFG, kv_bits=3)
    with pytest.raises(ValueError, match="kv_cb_mode"):
        Engine(params, CFG, kv_bits=4, kv_cb_mode="tensor")


def test_nan_quarantine_isolates_the_poisoned_slot_quant_pages():
    """The NaN quarantine at kv_bits=4: the poisoned slot's page codebooks
    go NaN; its neighbor takes over its scrubbed pages and streams what it
    streams alone."""
    pm, _ = _artifacts()
    params = pm.serving_params(packed=True)
    p8 = np.random.RandomState(15).randint(0, CFG.vocab, size=(2, 8))
    reqs = [Request(rid=0, prompt=p8[0], max_new_tokens=12),
            Request(rid=1, prompt=p8[1], max_new_tokens=5)]
    geo = dict(n_slots=2, page_size=4, max_seq=24, kv_bits=4)
    want = Engine(params, CFG, **geo).run(reqs[:1])
    eng = Engine(params, CFG, **geo)
    orig, calls = eng._decode, []

    def poisoned(*args, **kw):
        logits, caches = orig(*args, **kw)
        calls.append(1)
        if len(calls) == 2:
            slot = eng.sched.slot_of(1)
            idx = torch.tensor(eng.pool.pages_of(slot))
            for cache in caches[0].values():
                cache.k_cb[:, idx] = float("nan")
                cache.v_cb[:, idx] = float("nan")
            logits[slot] = float("nan")
        return logits, caches

    eng._decode = poisoned
    outs = eng.run(reqs)
    assert sorted(outs) == [0]
    res = eng.results[1]
    assert res.outcome is Outcome.FAILED and "non-finite" in res.detail
    assert eng.stats.quarantined == 1
    np.testing.assert_array_equal(outs[0], want[0])
    for stack in eng.caches:
        for cache in stack.values():
            assert all(torch.isfinite(t).all() for t in (cache.k_cb,
                                                          cache.v_cb))
