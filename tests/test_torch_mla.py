"""The port's MLA slice held against the reference on the CPU, at the
reduced ``deepseek-v2-lite-16b`` config (MLA + dense FFN, then MLA + MoE):
the one-shot and paged MLA layer steps (dense and codebook-quantized latent
pages), the plain versions of kernel rows 8, 9 and 11 against the
reference's jnp oracles and its Pallas kernels (interpret mode), the
latent-page byte accounting, the engine's streams against the one-shot
loop and the reference's engine, the launcher on a reference-made
artifact in both serving layouts, and the quarantine's scrub of latent
pages.  The ``cuda``-marked kernel-vs-plain tests on the card are in
``tests/test_torch_cuda.py``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_config as ref_reduce_config
from repro.core import PackedModel as RefPackedModel
from repro.engine import Engine as RefEngine
from repro.engine import Request as RefRequest
from repro.engine import kvcache as jkvcache
from repro.engine import oneshot as ref_oneshot
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.convert import from_numpy_tree
from repro_torch.engine import (Engine, Outcome, Request, greedy_generate,
                                kvcache)
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.codebook_matmul import codebook_matmul
from repro_torch.kernels.mla_paged_attention import mla_paged_attention
from repro_torch.kernels.mla_paged_attention_quant import \
    mla_paged_attention_quant
from repro_torch.launch import serve
from repro_torch.models import attention as attn

# The shapes here are tiny: one torch thread per test worker keeps torch's
# thread pool off the cores the reference's JAX tests compile on.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "deepseek-v2-lite-16b"
CFG = configs.reduce_config(configs.get_config(ARCH))
RCFG = ref_reduce_config(ref_get_config(ARCH))
M = CFG.mla
MLA_KW = dict(n_heads=CFG.n_heads, kv_lora=M.kv_lora, rope_dim=M.rope_dim,
              nope_dim=M.nope_dim, v_dim=M.v_dim, rope_theta=CFG.rope_theta)
SCALE = (M.nope_dim + M.rope_dim) ** -0.5


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _u32(x) -> np.ndarray:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint32)


@functools.lru_cache(maxsize=None)
def _model():
    """Reduced deepseek params made by the reference from a seed, in both
    frameworks."""
    rp = RT.init_params(jax.random.PRNGKey(0), RCFG)
    return rp, from_numpy_tree(jax.tree_util.tree_map(np.asarray, rp))


@functools.lru_cache(maxsize=None)
def _layer():
    rp = jattn.init_mla(jax.random.PRNGKey(4), CFG.d_model, CFG.n_heads,
                        kv_lora=M.kv_lora, rope_dim=M.rope_dim,
                        nope_dim=M.nope_dim, v_dim=M.v_dim)
    return rp, from_numpy_tree(jax.tree_util.tree_map(np.asarray, rp))


def _x(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# MLA layer steps
# ---------------------------------------------------------------------------

def test_mla_prefill_block_and_decode_match_reference():
    jp, tp = _layer()
    b = 2
    bc = jnp.zeros((b, 0, M.kv_lora))
    br = jnp.zeros((b, 0, M.rope_dim))
    tc, tr = torch.zeros(b, 0, M.kv_lora), torch.zeros(b, 0, M.rope_dim)
    jprefill = jax.jit(functools.partial(jattn.mla_prefill_block, **MLA_KW),
                       static_argnames=("start",))
    jdecode = jax.jit(functools.partial(jattn.mla_decode, **MLA_KW),
                      static_argnames=("pos",))
    for start, c in ((0, 5), (5, 4)):
        x = _x(b, c, CFG.d_model, seed=start)
        want, bc, br = jprefill(jp, jnp.asarray(x), bc, br, start=start)
        got, tc, tr = attn.mla_prefill_block(tp, *_t(x), tc, tr, start,
                                             **MLA_KW)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(bc), **TOL)
        np.testing.assert_allclose(tr.numpy(), np.asarray(br), **TOL)
    cap = 12
    jcache = jattn.MLACache(c_kv=jnp.pad(bc, ((0, 0), (0, cap - 9), (0, 0))),
                            k_rope=jnp.pad(br, ((0, 0), (0, cap - 9),
                                                (0, 0))))
    cache = attn.MLACache(*_t(np.asarray(jcache.c_kv),
                              np.asarray(jcache.k_rope)))
    for pos in (9, 10):
        x = _x(b, 1, CFG.d_model, seed=pos)
        want, jcache = jdecode(jp, jnp.asarray(x), jcache, pos=pos)
        got, cache = attn.mla_decode(tp, *_t(x), cache, pos, **MLA_KW)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(cache.c_kv.numpy(),
                                   np.asarray(jcache.c_kv), **TOL)


def _assert_pools(cache, jcache):
    for a, b_ in zip(cache, jcache):
        if a.dtype == torch.int32:
            np.testing.assert_array_equal(_u32(a)[1:], _u32(b_)[1:])
        else:
            np.testing.assert_allclose(a.numpy()[1:], np.asarray(b_)[1:],
                                       **TOL)


@pytest.mark.parametrize("bits", [0, 4])
def test_paged_mla_layer_steps_match_reference(bits):
    """One slot's prompt blocks into latent pages, then a decode step of two
    slots (one dead), on dense pages and 4-bit pages: outputs allclose,
    dense pools allclose, words exact (the reference under ``jax.jit``)."""
    jp, tp = _layer()
    page, n_pages = 4, 8
    kw = dict(MLA_KW, page_size=page)
    if bits:
        kw["kv_bits"] = bits
        cache = attn.init_quant_paged_mla_cache(n_pages, page, M.kv_lora,
                                                M.rope_dim, bits)
        jcache = jattn.init_quant_paged_mla_cache(n_pages, page, M.kv_lora,
                                                  M.rope_dim, bits,
                                                  jnp.float32)
        prefill, decode = (attn.mla_prefill_block_paged_quant,
                           attn.mla_decode_paged_quant)
        jprefill, jdecode = (jattn.mla_prefill_block_paged_quant,
                             jattn.mla_decode_paged_quant)
    else:
        cache = attn.init_paged_mla_cache(n_pages, page, M.kv_lora,
                                          M.rope_dim)
        jcache = jattn.init_paged_mla_cache(n_pages, page, M.kv_lora,
                                            M.rope_dim, jnp.float32)
        prefill, decode = (attn.mla_prefill_block_paged,
                           attn.mla_decode_paged)
        jprefill, jdecode = (jattn.mla_prefill_block_paged,
                             jattn.mla_decode_paged)
    jprefill = jax.jit(functools.partial(jprefill, **kw),
                       static_argnames=("start",))
    jdecode = jax.jit(functools.partial(jdecode, **kw))
    table = np.array([[6, 2, 3, 8]], np.int32)
    one = np.ones(1, bool)
    for start, c in ((0, 6), (6, 5)):
        x = _x(1, c, CFG.d_model, seed=20 + start)
        got, cache = prefill(tp, *_t(x), cache, *_t(table), start, *_t(one),
                             **kw)
        want, jcache = jprefill(jp, *_j(x), jcache, *_j(table), start=start,
                                alive=jnp.asarray(one))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _assert_pools(cache, jcache)
    table = np.array([[6, 2, 3, 8], [1, 4, 0, 0]], np.int32)
    alive = np.array([True, False])
    for pos in (11, 12):
        x = _x(2, 1, CFG.d_model, seed=pos)
        p = np.array([pos, 0], np.int32)
        got, cache = decode(tp, *_t(x), cache, *_t(table, p, alive), **kw)
        want, jcache = jdecode(jp, *_j(x), jcache, *_j(table, p, alive))
        np.testing.assert_allclose(got.numpy()[:1], np.asarray(want)[:1],
                                   **TOL)
        _assert_pools(cache, jcache)


# ---------------------------------------------------------------------------
# Plain versions of kernel rows 8, 9 and 11
# ---------------------------------------------------------------------------

# 4 slots, pages of 4, 3 logical pages per slot; pos covers 0, page - 1,
# page and capacity - 1; slot 2 is dead with a stale table row
B, PAGE, NPG, H, LAT, RD = 4, 4, 3, 3, 10, 6
TBL = np.array([[3, 7, 0], [5, 0, 0], [1, 2, 4], [9, 6, 8]], np.int32)
POS = np.array([0, 3, 4, 11], np.int32)
ALIVE = np.array([True, True, False, True])


@functools.lru_cache(maxsize=None)
def _mla_case():
    rng = np.random.RandomState(5)
    n = B * NPG - 2
    return (rng.randn(B, 1, H, LAT).astype(np.float32),
            rng.randn(B, 1, H, RD).astype(np.float32),
            rng.randn(n, PAGE, LAT).astype(np.float32),
            rng.randn(n, PAGE, RD).astype(np.float32))


def test_mla_paged_attention_plain_vs_reference_and_pallas():
    args = _mla_case() + (TBL, POS, ALIVE)
    want = np.asarray(jref.mla_paged_attention_ref(*_j(*args), scale=SCALE))
    pallas = np.asarray(jops.mla_paged_attention(
        *_j(*args), scale=SCALE, token_tile=2, interpret=True))
    dispatch.reset_launch_counts()
    got = mla_paged_attention(*_t(*args), scale=SCALE)
    assert tuple(got.shape) == (B, 1, H, LAT)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy()[ALIVE], pallas[ALIVE], **TOL)
    np.testing.assert_array_equal(pallas[2], 0.0)
    assert torch.equal(dispatch.mla_paged_attention(*_t(*args), scale=SCALE),
                       got)
    assert dispatch.launch_counts()["mla_paged_attention"] == 0
    with pytest.raises(ValueError, match="latent pools"):
        mla_paged_attention(*_t(*args[:2]), *_t(args[2], args[3][1:]),
                            *_t(*args[4:]), scale=SCALE)


def _quant_latent(bits):
    """Latent word pools and per-page codebooks, written by the port's
    quantizing write path from the dense case's rows."""
    from repro_torch.core import kvquant
    _, _, cp, rp = _mla_case()
    n = cp.shape[0]
    cache = attn.init_quant_paged_mla_cache(n - 1, PAGE, LAT, RD, bits)
    every = torch.arange(1, n)[None]
    one = torch.ones(1, dtype=torch.bool)
    for words, cbs, pool in ((cache.c_words, cache.c_cb, cp),
                             (cache.r_words, cache.r_cb, rp)):
        rows = torch.from_numpy(pool[1:]).reshape(1, -1, 1, pool.shape[-1])
        attn._write_block_slot_quant(words.unsqueeze(-2), cbs, every, 0, one,
                                     rows, PAGE, bits, "page")
    assert cache.c_words.shape[-1] == kvquant.words_per(LAT, bits)
    return cache


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_mla_paged_attention_quant_plain_vs_reference_and_pallas(bits):
    qe, qr, _, _ = _mla_case()
    cache = _quant_latent(bits)
    words = [_u32(w) for w in cache[:2]]
    cbs = [c.numpy() for c in cache[2:]]
    kw = dict(bits=bits, kv_lora=LAT, rope_dim=RD, scale=SCALE)
    jargs = _j(qe, qr, *words, *cbs, TBL, POS, ALIVE)
    want = np.asarray(jref.mla_paged_attention_quant_ref(*jargs, **kw))
    pallas = np.asarray(jops.mla_paged_attention_quant(
        *jargs, token_tile=2, interpret=True, **kw))
    got = mla_paged_attention_quant(*_t(qe, qr), *cache,
                                    *_t(TBL, POS, ALIVE), **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy()[ALIVE], pallas[ALIVE], **TOL)
    # the quantized route equals the dense route on the dequantized pools
    table = torch.arange(cache.c_words.shape[0])[None]
    one = torch.ones(1, dtype=torch.bool)
    dense = [ref.dequant_pages_ref(w, c, table, one, d, bits).reshape(
        w.shape[:2] + (d,)) for w, c, d in ((cache.c_words, cache.c_cb, LAT),
                                            (cache.r_words, cache.r_cb, RD))]
    assert torch.equal(got, ref.mla_paged_attention_ref(
        *_t(qe, qr), *dense, *_t(TBL, POS, ALIVE), scale=SCALE))
    with pytest.raises(ValueError, match="one codebook per latent page"):
        mla_paged_attention_quant(*_t(qe, qr), *cache[:2], cache.c_cb[:-1],
                                  cache.r_cb, *_t(TBL, POS, ALIVE), **kw)


@pytest.mark.parametrize("k", [2, 16, 256])
def test_codebook_matmul_plain_vs_reference_and_pallas(k):
    rng = np.random.RandomState(k)
    x = rng.randn(5, 40).astype(np.float32)
    idx = rng.randint(0, k, (40, 24)).astype(np.uint8)
    cb = np.sort(rng.randn(k)).astype(np.float32)
    want = np.asarray(jref.codebook_matmul_ref(*_j(x, idx, cb)))
    pallas = np.asarray(jops.codebook_matmul(*_j(x, idx, cb), bm=8, bn=128,
                                             bk=128, interpret=True))
    dispatch.reset_launch_counts()
    got = codebook_matmul(*_t(x, idx, cb))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    # the serving route on the CPU is the dense graph, bit for bit
    y = dispatch.quantized_matmul(*_t(x[None], idx, cb))
    assert torch.equal(y[0], torch.from_numpy(x) @ torch.from_numpy(cb)[
        torch.from_numpy(idx).long()])
    assert dispatch.launch_counts()["codebook_matmul"] == 0


def test_mla_page_footprint_matches_reference():
    for page, lat, rd in ((16, 512, 64), (4, 32, 8), (8, 10, 6)):
        for bits in (0, 2, 4, 8):
            assert kvcache.mla_page_footprint(page, lat, rd, bits) == \
                jkvcache.mla_page_footprint(page, lat, rd, bits)
    assert kvcache.mla_page_footprint(16, 512, 64) == 16 * 576 * 4
    # 4-bit latent pages: 16 * (64 + 8) words + two 16-entry codebooks
    assert kvcache.mla_page_footprint(16, 512, 64, 4) == 16 * 72 * 4 + 128
    assert kvcache.mla_equal_hbm_slots(4, 16, 512, 64, 4) == 4 * 36864 // 4736
    assert kvcache.mla_equal_hbm_slots(4, 16, 512, 64, 8) >= 4


# ---------------------------------------------------------------------------
# The engine on latent pages
# ---------------------------------------------------------------------------

GEO = dict(n_slots=2, page_size=4, max_seq=16, prefill_chunk=4)
GENS = (5, 3, 6, 4)


@functools.lru_cache(maxsize=None)
def _prompts():
    return np.random.RandomState(1).randint(0, CFG.vocab, (4, 10))


@functools.lru_cache(maxsize=None)
def _ref_engine(kv_bits):
    rp, _ = _model()
    reqs = [RefRequest(rid=i, prompt=_prompts()[i], max_new_tokens=g)
            for i, g in enumerate(GENS)]
    outs = RefEngine(rp, RCFG, kv_bits=kv_bits, **GEO).run(reqs)
    return {r: np.asarray(v) for r, v in outs.items()}


@pytest.mark.parametrize("kv_bits", [0, 4])
def test_engine_streams_equal_oneshot_and_reference_engine(kv_bits):
    _, tp = _model()
    reqs = [Request(rid=i, prompt=_prompts()[i], max_new_tokens=g)
            for i, g in enumerate(GENS)]
    eng = Engine(tp, CFG, kv_bits=kv_bits, **GEO)
    outs = eng.run(reqs)
    want = _ref_engine(kv_bits)
    assert sorted(outs) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(outs[rid], want[rid])
    st = eng.stats
    assert st.generated_tokens == st.decode_tokens + st.prefill_samples
    c = eng.caches[1]["pos0"]
    assert isinstance(c, attn.QuantPagedMLACache if kv_bits
                      else attn.PagedMLACache)
    if not kv_bits:
        one, _ = greedy_generate(tp, CFG, torch.from_numpy(_prompts()),
                                 max(GENS), block=GEO["prefill_chunk"])
        for rid, g in enumerate(GENS):
            np.testing.assert_array_equal(outs[rid], one.numpy()[rid, :g])
    else:
        # quantized latent pages: a second serve stores the same pages and
        # streams the same tokens (the fit is deterministic)
        again = Engine(tp, CFG, kv_bits=kv_bits, **GEO)
        outs2 = again.run([dataclasses.replace(r) for r in reqs])
        for rid in outs:
            np.testing.assert_array_equal(outs2[rid], outs[rid])
        for a, b_ in zip(eng.caches[1]["pos0"], again.caches[1]["pos0"]):
            assert torch.equal(a, b_)


def test_quarantine_scrubs_latent_pages():
    _, tp = _model()
    for kv_bits in (0, 4):
        eng = Engine(tp, CFG, kv_bits=kv_bits, **GEO)
        for stack in eng.caches:
            for cache in stack.values():
                for pool in cache:
                    pool.fill_(7)
        eng._scrub_pages([2, 5])
        for stack in eng.caches:
            for cache in stack.values():
                for pool in cache:
                    assert (pool[:, [2, 5]] == 0).all()
                    assert (pool[:, [1, 3]] == 7).all()


# ---------------------------------------------------------------------------
# The launcher on a reference-made artifact
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced_deepseek_artifact(tmp_path_factory):
    """A K=4 artifact of the reduced deepseek config (the MoE expert stacks
    quantized as [G, E, D, F] leaves) built and saved by the reference's
    PackedModel, with random assignments and codebooks from a seed."""
    from repro.core.compression import PackedLeaf, pack_indices
    from repro.core.lc import DEFAULT_EXCLUDE
    rp, _ = _model()
    rng = np.random.RandomState(0)
    packed, dense = {}, {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(rp)[0]:
        ks, leaf = jax.tree_util.keystr(path), np.asarray(leaf)
        grouped = ks.startswith("['stacks']")
        groups = leaf if grouped else leaf[None]
        if groups.ndim < 3 or DEFAULT_EXCLUDE.search(ks):
            dense[ks] = leaf
            continue
        idx = rng.randint(0, 4, size=groups.shape)
        cbs = np.sort(rng.randn(len(groups), 4) * 0.1, -1).astype(np.float32)
        words = np.stack([pack_indices(i, 4)[0] for i in idx])
        packed[ks] = PackedLeaf(words=words if grouped else words[0],
                                codebook=cbs if grouped else cbs[0],
                                shape=leaf.shape, k=4, dtype="float32")
    rpm = RefPackedModel(packed=packed, dense=dense, scheme_spec="adaptive:4",
                         k=4, codebook_entries=4 * len(packed))
    d = str(tmp_path_factory.mktemp("deepseek_reduced"))
    rpm.save(d)
    return d, rpm


def test_launcher_serves_deepseek_artifact_in_both_layouts(
        reduced_deepseek_artifact):
    d, rpm = reduced_deepseek_artifact
    base = ["--arch", ARCH, "--reduced", "--packed", d, "--device", "cpu",
            "--prompt-len", "9", "--gen-len", "4"]
    oneshot = base + ["--no-engine", "--batch", "2"]
    packed = serve.main(oneshot)
    uint8 = serve.main(oneshot + ["--serve-layout", "uint8"])
    np.testing.assert_array_equal(packed["tokens"], uint8["tokens"])
    assert torch.equal(packed["logits"], uint8["logits"])
    want, _ = ref_oneshot.greedy_generate(
        rpm.serving_params(packed=True), RCFG,
        jnp.asarray(packed["prompts"]), 4)
    np.testing.assert_array_equal(packed["tokens"], np.asarray(want))
    # engine mode on 4-bit latent pages
    eng = serve.main(base + ["--requests", "3", "--slots", "2",
                             "--page-size", "4", "--kv-bits", "4"])
    assert all(r.outcome is Outcome.FINISHED for r in eng["results"].values())
    assert isinstance(eng["engine"].caches[0]["pos0"],
                      attn.QuantPagedMLACache)
